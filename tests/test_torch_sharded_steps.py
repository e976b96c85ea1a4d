"""The port's sharded steps (launch/steps.py, distributed/step_plan.py)
against its single-device model, and checkpoints across meshes and
packages.

Four gloo ranks (tests/torch_sharded_ranks.py, spawned once) run every
case of ``make_step_and_specs`` at the reference's small-mesh cell size
(seq 64, batch 4, tests/test_distributed.py): the train step of each
family on 2 x 2 (the dense model also on 1 x 2, 2 x 1 and without
sequence parallelism; smollm's 3 heads on a model axis of 2, which
computes its attention whole), prefill + decode in ``head`` / ``seq`` /
``auto`` KV modes, and hubert's ``encode``. Everything is fp32, so the
sharded step differs from the single-device one only in the order of its
sums:

  * step-1 loss within 2e-6 relative; every gathered gradient within
    1e-4 of the single-device gradient's largest magnitude (zamba2's
    ``A_log`` gradient cancels heavily: on one device, splitting only
    ``out_proj``'s reduction in two moves it by 6.6e-6 of its largest
    magnitude, and the sharded step reorders every block's sums; the
    other leaves agree within ~2e-6);
  * the reported gradient norm within 1e-6 relative of
    ``optimizer.global_norm`` of the single-device gradients (step 1) and
    of the gathered gradients the step applied (both steps; measured
    <= 1.6e-7);
  * the optimizer, held to itself: ``apply_updates`` on one device with
    the gathered gradients gives the gathered params within 1e-4 of each
    leaf's largest update and m / v within 1e-6 of their largest
    magnitude (the norms differ in their last bits, and Adam's step moves
    with the clip scale where |g| is near eps; measured <= 4.8e-5 /
    3.3e-7);
  * the update (params after two AdamW steps at the full lr, one warm-up
    step, minus the initial params) within 1e-2 of the single-device
    update in the whole tree's Euclidean norm: Adam's normalised step
    flips with the sign of a gradient element near zero, so a few
    elements move by up to 2 lr (measured <= 1e-3 in any one leaf);
  * prefill / decode logits within 5e-5 absolute, encoder outputs within
    2e-5.

One cell of each family is also held to the JAX package on the same
params and batch, at ``tests/test_torch_loss.py``'s tolerances: the
gathered step-1 loss within 1e-5 relative and every gradient within
rel_err 1e-4 of ``jax.value_and_grad`` of the reference's ``loss``; the
prefill / decode logits and hubert's encoder outputs within rel_err 1e-4
of the reference model's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as P

import torch_sharded_ranks as ranks
from conftest import rel_err
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import build_model as ref_build_model
from repro.training.checkpoint import CheckpointManager as RefCheckpoint
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                             make_train_step)
from repro_torch.training.tree import tree_flatten

LOSS_RTOL = 2e-6
GRAD_TOL = 1e-4
NORM_RTOL = 1e-6
REPLAY_TOL = 1e-4
MOMENT_TOL = 1e-6
UPDATE_RTOL = 1e-2
LOGIT_ATOL = 5e-5
HIDDEN_ATOL = 2e-5
REF_LOSS_RTOL = 1e-5
REF_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size steps gain nothing from intra-op threads, and the suite's
    workers share the machine's cores (each rank sets its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(the reference's resharded checkpoint, the ranks' port checkpoint
    directory): the reference saves ``test_checkpoint_elastic_reshard``'s
    array from its 4 x 2 mesh before the ranks start."""
    ref_dir = tmp_path_factory.mktemp("ref_ckpt")
    x = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                       RefNamedSharding(ref_host_mesh(4, 2),
                                        P("data", "model")))
    RefCheckpoint(ref_dir).save(1, {"x": x}, blocking=True)
    return str(ref_dir), str(tmp_path_factory.mktemp("port_ckpt"))


@pytest.fixture(scope="module")
def out(dirs):
    return spawn_ranks(ranks.sharded_steps_rank, 4, *dirs, device="cpu")


@functools.lru_cache(maxsize=None)
def _single_train(arch, moe):
    """The single-device run of a train case: (step-1 loss, step-1
    gradients, params after the two steps, the initial params)."""
    cfg = ranks.smoke_cfg(arch, **dict(moe))
    batches = ranks.train_batches(cfg)
    loss, _, grads = loss_and_grads(build_model(cfg), ranks.init_params(cfg),
                                    *batches[0])
    state = opt.init_state(ranks.init_params(cfg))
    _, step = make_train_step(cfg, TrainConfig(opt=ranks.OPT), device="cpu")
    for inputs, targets in batches:
        state, _ = step(state, {"inputs": inputs, "targets": targets})
    return float(loss), grads, state["params"], ranks.init_params(cfg)


def _rank_batch(spec, rank, shape):
    """The rows of the global batch a rank of a ``data x model`` mesh laid
    by ``ranks.mesh_of`` holds under the batch ``spec``."""
    data, model = shape
    if not spec:
        return slice(0, ranks.BATCH)
    d = (rank // model) % data
    b = ranks.BATCH // data
    return slice(d * b, (d + 1) * b)


def _moe_key(moe: dict) -> tuple:
    return tuple(sorted(moe.items()))


@pytest.mark.parametrize("case", ranks.TRAIN_CASES, ids=lambda c: c[0])
def test_sharded_train_step_matches_single_device(out, case):
    name, arch, shape, moe, _ = case
    loss, grads, params, p0 = _single_train(arch, _moe_key(moe))
    for rank, res in enumerate(out):
        got = res["train"][name]
        assert got["shapes_ok"], (name, rank)
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), \
            (name, rank, got["loss"], loss)
    got = out[0]["train"][name]
    for (path, want), (_, g) in zip(tree_flatten(grads),
                                    tree_flatten(got["grads"][0])):
        scale = float(want.abs().max()) or 1.0
        err = float((g - want).abs().max())
        assert err <= GRAD_TOL * scale, (name, path, err, scale)
    norm = float(opt.global_norm(grads))
    assert abs(got["grad_norms"][0] - norm) <= NORM_RTOL * norm, \
        (name, got["grad_norms"][0], norm)
    # the update of two steps against the single device's
    diff = total = 0.0
    for (_, a), (_, want), (_, p) in zip(tree_flatten(p0),
                                         tree_flatten(params),
                                         tree_flatten(got["params"])):
        diff += float(torch.sum(torch.square((p - a) - (want - a))))
        total += float(torch.sum(torch.square(want - a)))
    assert total > 0 and diff ** 0.5 <= UPDATE_RTOL * total ** 0.5, \
        (name, diff ** 0.5 / total ** 0.5)
    # every rank's second-step loss is the same global loss
    assert len({r["train"][name]["losses"][1] for r in out}) == 1


@pytest.mark.parametrize("case", ranks.TRAIN_CASES, ids=lambda c: c[0])
def test_sharded_optimizer_applies_its_gradients(out, case):
    """The sharded AdamW (local m / v blocks, ``StepPlan.global_norm``,
    ``apply_updates(grad_norm=)``) against ``apply_updates`` on one
    device fed the gathered gradients the sharded step applied."""
    name, arch, shape, moe, _ = case
    got = out[0]["train"][name]
    cfg = ranks.smoke_cfg(arch, **moe)
    p0 = ranks.init_params(cfg)
    state = opt.init_state(ranks.init_params(cfg))
    for grads, norm in zip(got["grads"], got["grad_norms"]):
        want = float(opt.global_norm(grads))
        assert abs(norm - want) <= NORM_RTOL * want, (name, norm, want)
        state, _ = opt.apply_updates(state, grads, ranks.OPT)
    for (path, a), (_, want), (_, p) in zip(
            tree_flatten(p0), tree_flatten(state["params"]),
            tree_flatten(got["params"])):
        scale = float((want - a).abs().max())
        err = float(((p - a) - (want - a)).abs().max())
        assert err <= REPLAY_TOL * scale, (name, path, err, scale)
    for k in ("m", "v"):
        for (path, want), (_, g) in zip(tree_flatten(state[k]),
                                        tree_flatten(got[k])):
            scale = float(want.abs().max()) or 1.0
            err = float((g - want).abs().max())
            assert err <= MOMENT_TOL * scale, (name, k, path, err, scale)


def test_indivisible_heads_compute_attention_whole(out):
    """smollm's 3 query heads and 1 KV head on a model axis of 2: the
    attention keeps every head on both ranks, the FFN stays sharded."""
    got = out[0]["train"]["smollm 1x2"]
    assert got["tp_blocks"]["attn"] is False
    assert got["tp_blocks"]["ffn"] is True
    assert got["cfg_heads"] == 3
    dense = out[0]["train"]["llama3 2x2"]
    assert dense["tp_blocks"]["attn"] and dense["cfg_heads"] == 2


def test_every_family_shards_over_model(out):
    """On the 2 x 2 mesh every family's blocks are tensor-parallel: the MoE
    experts over model (EP: 6 experts, 2 ranks; on a model axis of 4 each
    expert's d_ff instead), zamba2's mamba
    ``out_proj`` and shared attention / FFN, RWKV-6's time and channel
    mixes, and every untied head over the vocabulary."""
    got = {name: out[0]["train"][name]["tp_blocks"]
           for name in ("qwen2-moe 2x2", "zamba2 2x2", "rwkv6 2x2",
                        "hubert 2x2")}
    assert got["qwen2-moe 2x2"]["moe"] == "ep"
    assert out[0]["train"]["qwen2-moe 1x4"]["tp_blocks"]["moe"] == "ff"
    assert got["qwen2-moe 2x2"]["attn"]
    assert got["zamba2 2x2"]["mamba"] and got["zamba2 2x2"]["attn"] \
        and got["zamba2 2x2"]["ffn"]
    assert got["rwkv6 2x2"]["rwkv_tm"] and got["rwkv6 2x2"]["rwkv_cm"]
    assert all(b["vocab"] for b in got.values())


def _single_serve(arch, moe):
    cfg = ranks.smoke_cfg(arch, **moe)
    model = build_model(cfg)
    params = ranks.init_params(cfg)
    toks = ranks.serve_tokens(cfg)
    cache = model.init_cache(batch=ranks.BATCH, max_len=ranks.SEQ,
                             dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(params, toks[:, :ranks.PROMPT], cache)
    want = [logits]
    for i in range(ranks.NEW):
        at = ranks.PROMPT + i
        logits, cache = model.decode_step(params, toks[:, at:at + 1], cache)
        want.append(logits)
    return want


@pytest.mark.parametrize("case", ranks.SERVE_CASES, ids=lambda c: c[0])
def test_sharded_serve_steps_match_model(out, case):
    name, arch, shape, moe, kv_mode = case
    want = _single_serve(arch, moe)
    for rank, res in enumerate(out):
        got = res["serve"][name]
        assert got["shapes_ok"], (name, rank)
        assert got["index"] == ranks.PROMPT + ranks.NEW
        rows = _rank_batch(got["batch_spec"], rank, shape)
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            err = float((g - w[rows]).abs().max())
            assert err <= LOGIT_ATOL, (name, rank, step, err)


def test_serve_kv_modes_resolve_as_the_reference(out):
    """'auto' is heads when the model axis divides the KV heads, else the
    sequence; split-KV decode runs on a sequence-sharded cache."""
    got = out[0]["serve"]
    assert (got["llama3 1x2 auto"]["kv_mode"], got["llama3 1x2 auto"][
        "split"]) == ("head", False)
    assert (got["smollm 1x2 auto"]["kv_mode"], got["smollm 1x2 auto"][
        "split"]) == ("seq", True)
    assert got["llama3 2x2 seq"]["split"] is True
    assert got["rwkv6 2x2 auto"]["kv_mode"] == "auto"


def test_sharded_encode_matches_model(out):
    cfg = ranks.smoke_cfg("hubert-xlarge")
    want = build_model(cfg).encode(ranks.init_params(cfg),
                                   ranks.train_batches(cfg, 1)[0][0])
    for rank, res in enumerate(out):
        got = res["encode"]["hubert 2x2"]
        rows = _rank_batch(got["batch_spec"], rank, (2, 2))
        err = float((got["hidden"] - want[rows]).abs().max())
        assert err <= HIDDEN_ATOL, (rank, err)


def _ref_pair(arch: str, moe: dict):
    """The reference's fp32 smoke model of a case and the case's params
    (the port's seeded init) as JAX arrays."""
    ref_cfg = ref_get_smoke_config(arch).with_(param_dtype="float32",
                                               compute_dtype="float32")
    if moe:
        ref_cfg = ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, **moe))
    params = ranks.init_params(ranks.smoke_cfg(arch, **moe))
    return ref_build_model(ref_cfg), jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


REF_TRAIN = ("llama3 2x2", "hubert 2x2", "qwen2-moe 2x2", "zamba2 2x2",
             "rwkv6 2x2")
REF_SERVE = ("llama3 2x2 head", "qwen2-moe 2x2 head", "zamba2 2x2 auto",
             "rwkv6 2x2 auto")


@pytest.mark.parametrize("name", REF_TRAIN)
def test_sharded_train_step_matches_reference(out, name):
    """One 2 x 2 cell a family: the gathered step-1 loss and gradients
    against ``jax.value_and_grad`` of the reference's loss on the same
    params and batch."""
    _, arch, _, moe, _ = next(c for c in ranks.TRAIN_CASES if c[0] == name)
    ref_model, ref_params = _ref_pair(arch, moe)
    inputs, targets = ranks.train_batches(ranks.smoke_cfg(arch, **moe))[0]
    (loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, jnp.asarray(inputs.numpy()),
                                 jnp.asarray(targets.numpy())),
        has_aux=True))(ref_params)
    got = out[0]["train"][name]
    assert abs(got["loss"] - float(loss)) <= REF_LOSS_RTOL * abs(float(loss))
    for path, g in tree_flatten(got["grads"][0]):
        want = np.asarray(_get(ref_grads, path))
        assert g.shape == want.shape, (name, path)
        if not np.any(want):
            assert not torch.any(g), (name, path)
        else:
            assert rel_err(g.numpy(), want) <= REF_TOL, (name, path)


@pytest.mark.parametrize("name", REF_SERVE)
def test_sharded_serve_steps_match_reference(out, name):
    """One 2 x 2 cell a family: every rank's prefill and decode logits
    against the reference model's rows of the same batch."""
    _, arch, shape, moe, _ = next(c for c in ranks.SERVE_CASES
                                  if c[0] == name)
    ref_model, ref_params = _ref_pair(arch, moe)
    toks = jnp.asarray(ranks.serve_tokens(
        ranks.smoke_cfg(arch, **moe)).numpy(), jnp.int32)
    cache = ref_model.init_cache(batch=ranks.BATCH, max_len=ranks.SEQ,
                                 dtype=jnp.float32)
    logits, cache = jax.jit(ref_model.prefill)(ref_params,
                                               toks[:, :ranks.PROMPT], cache)
    want = [np.asarray(logits)]
    decode = jax.jit(ref_model.decode_step)
    for i in range(ranks.NEW):
        at = ranks.PROMPT + i
        logits, cache = decode(ref_params, toks[:, at:at + 1], cache)
        want.append(np.asarray(logits))
    for rank, res in enumerate(out):
        got = res["serve"][name]
        rows = _rank_batch(got["batch_spec"], rank, shape)
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            assert g.shape == w[rows].shape, (name, rank, step)
            assert rel_err(g.numpy(), w[rows]) <= REF_TOL, (name, rank, step)


def test_sharded_encode_matches_reference(out):
    ref_model, ref_params = _ref_pair("hubert-xlarge", {})
    x = ranks.train_batches(ranks.smoke_cfg("hubert-xlarge"), 1)[0][0]
    want = np.asarray(jax.jit(ref_model.encode)(ref_params,
                                                jnp.asarray(x.numpy())))
    for rank, res in enumerate(out):
        got = res["encode"]["hubert 2x2"]
        rows = _rank_batch(got["batch_spec"], rank, (2, 2))
        assert rel_err(got["hidden"].numpy(), want[rows]) <= REF_TOL, rank


def test_checkpoint_reshards_across_meshes(out):
    """Saved from 2 x 2 under the FSDP specs, restored on 1 x 2 under the
    serving specs: every rank's blocks equal the saved state's."""
    for res in out:
        assert res["checkpoint"]["reshard_equal"]
        assert res["checkpoint"]["step"] == 7


def test_port_sharded_checkpoint_restores_in_reference(out, dirs):
    """The ranks' sharded save holds the whole arrays in the reference's
    layout: its CheckpointManager restores them leaf for leaf."""
    cfg = ranks.smoke_cfg("llama3-8b")
    state = opt.init_state(ranks.init_params(cfg))
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                        {k: state[k] for k in ("params", "m", "v")})
    like["step"] = np.zeros((), np.int32)
    got = RefCheckpoint(dirs[1]).restore(7, like)
    assert int(got["step"]) == 7
    for (path, want), g in zip(tree_flatten(state["params"]),
                               jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(np.asarray(g), want.numpy(),
                                      err_msg="/".join(path))
    for (path, want), g in zip(tree_flatten(state["m"]),
                               jax.tree.leaves(got["m"])):
        np.testing.assert_array_equal(np.asarray(g), want.numpy() + 0.5,
                                      err_msg="/".join(path))


def test_reference_checkpoint_restores_onto_port_mesh(out):
    """The reference's resharded save of ``arange(64).reshape(8, 8)``
    restored under ("model", "data") on the port's 2 x 2 mesh: rank (d, m)
    holds rows of block m and columns of block d."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rank, res in enumerate(out):
        d, m = rank // 2, rank % 2
        np.testing.assert_array_equal(res["checkpoint"]["ref_block"].numpy(),
                                      x[m * 4:(m + 1) * 4, d * 4:(d + 1) * 4])
