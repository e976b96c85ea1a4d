"""The port's training substrate against the reference's: AdamW
(``apply_updates`` on the same params and grads: params, moments and the
gradient norm), the int8 error-feedback compression, the data pipeline
(batches byte-equal to the reference's, also after ``restore``),
checkpoints (round trip, GC, the ``.tmp`` dir invisible, a checkpoint
written by either package restored by the other), fault tolerance under a
FakeClock (a crash mid-run ends bitwise equal to the uninterrupted run),
five ``train()`` steps against the reference's, and the CLI. All on the
CPU, fp32 smollm smoke model; the zamba2 hybrid's and RWKV-6's smoke
models take ``make_train_step`` steps equal to the port's own sequence of
gradient and AdamW update, and train through the CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.distributed import compression as ref_compression
from repro.models import build_model as ref_build_model
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_train_loop
from repro.training.checkpoint import CheckpointManager as RefCheckpoints
from repro.training.data import PackedFile as RefPackedFile
from repro.training.data import SyntheticLM as RefSyntheticLM
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import compression
from repro_torch.launch import train as train_cli
from repro_torch.serving.telemetry import FakeClock
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import PackedFile, Prefetcher, SyntheticLM
from repro_torch.training.fault_tolerance import StepMonitor, run_resilient
from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                             make_train_step, train)
from repro_torch.training.tree import tree_leaves, tree_map

FP32 = dict(param_dtype="float32", compute_dtype="float32")
OPT_TOL = 1e-6       # params, m, v and the norm after the same steps
TRAJ_TOL = 1e-4      # five steps' losses against the reference's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "nested": {"b": rng.standard_normal(7).astype(dtype),
                       "stack": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def _to_torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), tree)


def _close(a, b, tol=OPT_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) <= tol * max(float(np.abs(b).max()),
                                                   1.0)


# ----------------------------------------------------------------- AdamW --

@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_apply_updates_matches_reference(clip):
    """Four AdamW steps (warm-up and cosine schedule, clipping, decay on
    matrices only) from the same params on the same grads: params, m, v,
    grad_norm and lr within 1e-6 of the reference's."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, grad_clip=clip, warmup_steps=2, total_steps=6)
    params = _np_tree(rng)
    grads = [_np_tree(rng) for _ in range(4)]
    ref_state = ref_opt.init_state(jax.tree.map(jnp.asarray, params))
    state = opt.init_state(_to_torch(params))
    for g in grads:
        ref_state, ref_m = ref_opt.apply_updates(
            ref_state, jax.tree.map(jnp.asarray, g),
            ref_opt.AdamWConfig(**cfg))
        state, m = opt.apply_updates(state, _to_torch(g),
                                     opt.AdamWConfig(**cfg))
        assert _close(m["grad_norm"], ref_m["grad_norm"])
        assert _close(m["lr"], ref_m["lr"])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 4
    for key in ("params", "m", "v"):
        for a, b in zip(tree_leaves(state[key]),
                        jax.tree.leaves(ref_state[key])):
            assert _close(a.numpy(), b), key


def test_apply_updates_bf16_params_match_reference():
    """bf16 params: the update in fp32, cast back, as the reference's."""
    rng = np.random.default_rng(1)
    params = _np_tree(rng)
    g = _np_tree(rng)
    cfg = dict(lr=0.05, warmup_steps=0)
    ref_state = ref_opt.init_state(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params))
    ref_state, _ = ref_opt.apply_updates(ref_state, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), g), ref_opt.AdamWConfig(**cfg))
    state = opt.init_state(_to_torch(params, torch.bfloat16))
    state, _ = opt.apply_updates(state, _to_torch(g, torch.bfloat16),
                                 opt.AdamWConfig(**cfg))
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(ref_state["params"])):
        assert a.dtype == torch.bfloat16
        assert _close(a.float().numpy(), np.asarray(b, np.float32), 1e-2)


def test_adamw_reduces_loss_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0)
    state = opt.init_state({"w": torch.tensor([3.0, -2.0])}, cfg)
    for _ in range(200):
        state, _ = opt.apply_updates(state, {"w": 2 * state["params"]["w"]},
                                     cfg)
    assert float(state["params"]["w"].abs().max()) < 0.2


def test_grad_clip_reports_the_raw_norm():
    cfg = opt.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0)
    state = opt.init_state({"w": torch.zeros(4)}, cfg)
    _, m = opt.apply_updates(state, {"w": torch.full((4,), 1e6)}, cfg)
    assert float(m["grad_norm"]) > 1e5


# ----------------------------------------------------------- compression --

def test_compression_matches_reference():
    """Two steps of int8 error feedback: the rounded gradients and the
    residuals bitwise equal to the reference's; a zero tensor has scale 1."""
    rng = np.random.default_rng(2)
    err = compression.init_error(_to_torch(_np_tree(rng)))
    ref_err = ref_compression.init_error(_np_tree(rng))
    for _ in range(2):
        g = _np_tree(rng)
        got, err = compression.compress_grads_with_feedback(_to_torch(g),
                                                            err)
        want, ref_err = ref_compression.compress_grads_with_feedback(
            jax.tree.map(jnp.asarray, g), ref_err)
        for a, b in zip(tree_leaves(got) + tree_leaves(err),
                        jax.tree.leaves(want) + jax.tree.leaves(ref_err)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    q, s = compression.quantize_int8(torch.zeros(5))
    assert float(s) == 1.0 and q.dtype == torch.int8 and not q.any()
    assert torch.equal(compression.dequantize_int8(q, s), torch.zeros(5))


# ------------------------------------------------------------------ data --

def test_synthetic_batches_byte_equal_to_reference():
    ours, ref = SyntheticLM(1000, 32, 4, seed=3), RefSyntheticLM(1000, 32, 4,
                                                                seed=3)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        for key in ("inputs", "targets"):
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    ours2 = SyntheticLM(1000, 32, 4, seed=0)
    ours2.restore(ref.state())
    assert ours2.next()["inputs"].tobytes() == ref.next()["inputs"].tobytes()


def test_packed_file_and_prefetcher(tmp_path):
    toks = np.random.default_rng(0).integers(0, 60000, 10000
                                             ).astype(np.uint16)
    path = tmp_path / "tokens.bin"
    toks.tofile(path)
    src = PackedFile(path, vocab_size=50000, seq_len=16, batch=2)
    ref = RefPackedFile(path, vocab_size=50000, seq_len=16, batch=2)
    for _ in range(2):
        a, b = src.next(), ref.next()
        assert a["inputs"].tobytes() == b["inputs"].tobytes()
    assert (a["inputs"] < 50000).all() and a["inputs"].shape == (2, 16)
    pf = Prefetcher(src)
    b2 = pf.next()
    assert b2["inputs"].shape == (2, 16)
    pf.close()


# ----------------------------------------------------------- checkpoints --

def _state():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.linspace(-2, 2, 5).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32), "seed": 3}


def test_checkpoint_roundtrip_gc_and_tmp(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    state = _state()
    cm.save(7, state, blocking=True)
    out = cm.restore(7, _state())
    assert torch.equal(out["a"], state["a"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], state["nested"]["b"])
    assert out["step"].dtype == torch.int32 and out["seed"] == 3
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json"
                           ).read_text())
    assert manifest["leaves"]["nested/b"] == {
        "file": "nested__b.npy", "shape": [5], "dtype": "bfloat16"}
    (tmp_path / "step_00000009.tmp").mkdir()        # a write in flight
    assert cm.latest_step() == 7
    for s in (1, 2, 3):
        cm.save(s + 7, {"x": torch.zeros(3)}, blocking=True)
    assert cm.all_steps() == [9, 10]


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A reference-written train state (smollm smoke, bf16 params, fp32
    moments, int32 step, data state) restores in the port leaf for leaf,
    and the port's write of it restores in the reference bit for bit."""
    cfg = ref_get_smoke_config("smollm-135m")
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    ref_state = {"state": ref_opt.init_state(params),
                 "data": {"step": 4, "seed": 0}}
    ref_state["state"]["m"] = jax.tree.map(lambda p: p.astype(jnp.float32)
                                           * 0.5, params)
    RefCheckpoints(tmp_path / "ref").save(3, ref_state, blocking=True)
    np_params = jax.tree.map(np.asarray, params)
    like = {"state": opt.init_state(params_from_numpy(
        np_params, get_smoke_config("smollm-135m"), "cpu")),
        "data": {"step": 0, "seed": 9}}
    got = CheckpointManager(tmp_path / "ref").restore(3, like)
    assert got["data"] == {"step": 4, "seed": 0}
    assert int(got["state"]["step"]) == 0
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_state["state"])[0]]
    ours = tree_leaves(got["state"])
    for name, a, b in zip(names, ours, jax.tree.leaves(ref_state["state"])):
        assert a.dtype == like_dtype(b), name
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    CheckpointManager(tmp_path / "port").save(5, got, blocking=True)
    back = RefCheckpoints(tmp_path / "port").restore(5, ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


def like_dtype(jax_array):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32}[str(jax_array.dtype)]


# ------------------------------------------------------- fault tolerance --

def test_straggler_monitor():
    m = StepMonitor(straggler_factor=3.0)
    for i in range(10):
        assert not m.record(i, 0.1)
    assert m.record(10, 1.0)
    assert len(m.events) == 1


def test_run_resilient_reads_only_the_injected_clock(tmp_path):
    """Under a frozen FakeClock every step lasts 0.0; under one that ticks a
    second per read, every duration is a whole number of seconds."""

    class TickClock(FakeClock):
        def now(self):
            t = super().now()
            self.advance(1.0)
            return t

    def step_fn(s, batch):
        return {"step": s["step"] + 1}, {}

    for clock, want in ((FakeClock(), 0.0), (TickClock(), 1.0)):
        mon = StepMonitor()
        run_resilient(3, state={"step": 0}, data=SyntheticLM(100, 8, 2),
                      step_fn=step_fn, ckpt=CheckpointManager(
                          tmp_path / str(want)), monitor=mon, clock=clock,
                      log=lambda *a: None)
        assert mon.times == [want] * 3


@pytest.fixture(scope="module")
def smollm():
    """The fp32 smollm smoke model's reference params (PRNGKey 0, as the
    reference's ``train`` draws them) and the reference's five-step run."""
    ref_cfg = ref_get_smoke_config("smollm-135m").with_(**FP32)
    params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    return {"np_params": jax.tree.map(np.asarray, params),
            "cfg": get_smoke_config("smollm-135m").with_(**FP32),
            "ref_cfg": ref_cfg}


SHAPE = ShapeSpec("test", 32, 4, "train")


def _port_train(smollm, tmp_path, steps, **kw):
    cfg = smollm["cfg"]
    tcfg = TrainConfig(steps=steps, log_every=1, save_every=kw.pop(
        "save_every", 1000), ckpt_dir=str(tmp_path))
    return train(cfg, tcfg, SHAPE, device="cpu", clock=FakeClock(),
                 log=lambda *a: None,
                 params=params_from_numpy(smollm["np_params"], cfg, "cpu"),
                 **kw)


def test_crash_restart_is_bitwise_equal(smollm, tmp_path):
    """A crash at step 7 with save_every=5 restores step 5 (params, moments
    and the data position) and ends bitwise equal to the uninterrupted run:
    the same params, moments and losses."""
    crashed = []

    def injector(step):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    plain, plain_losses, _ = _port_train(smollm, tmp_path / "a", 9,
                                         save_every=5)
    state, losses, _ = _port_train(smollm, tmp_path / "b", 9, save_every=5,
                                   fail_injector=injector)
    assert crashed == [7] and int(state["step"]) == 9
    for key in ("params", "m", "v"):
        for a, b in zip(tree_leaves(state[key]),
                        tree_leaves(plain[key])):
            assert torch.equal(a, b), key
    assert dict(losses) == dict(plain_losses)


def test_five_steps_track_the_reference(smollm, tmp_path):
    """Five train() steps of the fp32 smollm smoke model from the
    reference's params on the reference's batches: each step's loss within
    1e-4 of the reference's train()."""
    ref_state, ref_losses, _ = ref_train_loop.train(
        smollm["ref_cfg"], ref_train_loop.TrainConfig(
            steps=5, log_every=1, save_every=1000,
            ckpt_dir=str(tmp_path / "ref")), SHAPE, log=lambda *a: None,
        clock=_RefFakeClock())
    _, losses, _ = _port_train(smollm, tmp_path / "port", 5)
    assert [s for s, _ in losses] == [s for s, _ in ref_losses] == \
        [1, 2, 3, 4, 5]
    for (_, a), (_, b) in zip(losses, ref_losses):
        assert abs(a - b) <= TRAJ_TOL * abs(b)


def _RefFakeClock():
    from repro.serving.telemetry import FakeClock as RefFakeClock
    return RefFakeClock()


def test_cli_smoke_on_cpu(tmp_path, capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq",
                    "16", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and out.strip().splitlines()[-1
                                                               ].startswith(
        "done: loss")


# ------------------------------------------------- the hybrid and RWKV-6 --

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_train_steps_of_the_hybrid_and_rwkv(arch):
    """Three ``make_train_step`` steps of the fp32 smoke model on
    SyntheticLM batches (the hybrid's SSD scan and shared attention, RWKV-6's
    WKV scan, each layer or period recomputed in backward) equal the port's
    own sequence of ``loss_and_grads`` then ``apply_updates`` on a copy of
    the same params, bitwise: params, moments and losses, all finite."""
    cfg = get_smoke_config(arch).with_(**FP32)
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=1e-2, warmup_steps=1))
    model, step_fn = make_train_step(cfg, tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = opt.init_state(params)
    seq = opt.init_state(tree_map(lambda t: t.clone(), params))
    data = SyntheticLM(cfg.vocab_size, 32, 2, seed=1)
    losses = []
    for _ in range(3):
        batch = data.next()
        state, metrics = step_fn(state, batch)
        loss, _, grads = loss_and_grads(model, seq["params"],
                                        torch.from_numpy(batch["inputs"]),
                                        torch.from_numpy(batch["targets"]))
        seq, _ = opt.apply_updates(seq, grads, tcfg.opt)
        assert torch.equal(metrics["loss"], loss)
        assert torch.isfinite(loss) and torch.isfinite(metrics["grad_norm"])
        losses.append(float(loss))
    assert int(state["step"]) == int(seq["step"]) == 3
    for key in ("params", "m", "v"):
        for a, b in zip(tree_leaves(state[key]), tree_leaves(seq[key])):
            assert torch.isfinite(a).all() and torch.equal(a, b), key
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_cli_trains_the_hybrid_and_rwkv_on_cpu(arch, tmp_path, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "2", "--seq", "16", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step     1 loss")
    assert out[-1].startswith("done: loss")
