"""Rank bodies of the port's sharded-step CPU tests
(tests/test_torch_sharded_steps.py).

One spawned gloo group of four ranks computes every case once. A case's
mesh is ``data x model`` laid as the inner axes of a ``(4 / (data *
model), data, model)`` mesh, so a 1 x 2 or 2 x 1 mesh runs as two
replicas. Each rank builds the seeded fp32 smoke model's params whole,
keeps its blocks under the step's specs, runs the step on its block of
the batch, and gathers what the test compares (losses, gradients,
params, logits, encoder outputs) whole. Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.distributed.sharding import (NamedSharding, gather_tree,
                                              shard_tensor, shard_tree)
from repro_torch.launch.steps import make_step_and_specs, state_shardings
from repro_torch.models import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.tree import tree_flatten, tree_map

SEQ, BATCH = 64, 4                  # tests/test_distributed.py's cells
PROMPT, NEW = 48, 4                 # serve cells: prefill, then decode steps
SEED = 3
# one warm-up step: the first steps' lr is the full 3e-4, so two updates
# move each parameter far above the comparisons' tolerances
OPT = opt.AdamWConfig(warmup_steps=1)

# (name, arch, (data, model), config overrides, seq_shard)
TRAIN_CASES = (
    ("llama3 2x2", "llama3-8b", (2, 2), {}, True),
    ("llama3 1x2", "llama3-8b", (1, 2), {}, True),
    ("llama3 2x1", "llama3-8b", (2, 1), {}, False),
    ("llama3 2x2 no-sp", "llama3-8b", (2, 2), {}, False),
    # 3 heads, 1 KV head: model = 2 divides neither, attention computes
    # whole on both ranks (the FFN and the tied head stay sharded)
    ("smollm 1x2", "smollm-135m", (1, 2), {}, True),
    ("hubert 2x2", "hubert-xlarge", (2, 2), {}, True),
    # a rank's 128 tokens must hold whole dispatch groups
    ("qwen2-moe 2x2", "qwen2-moe-a2.7b", (2, 2), {"group_size": 2}, True),
    # 6 experts on a model axis of 4: every expert's d_ff shards instead
    ("qwen2-moe 1x4", "qwen2-moe-a2.7b", (1, 4), {}, True),
    ("zamba2 2x2", "zamba2-2.7b", (2, 2), {}, True),
    ("rwkv6 2x2", "rwkv6-3b", (2, 2), {}, True),
)
# (name, arch, (data, model), config overrides, kv_mode)
SERVE_CASES = (
    ("llama3 2x2 head", "llama3-8b", (2, 2), {}, "head"),
    ("llama3 2x2 seq", "llama3-8b", (2, 2), {}, "seq"),
    ("llama3 1x2 auto", "llama3-8b", (1, 2), {}, "auto"),
    ("llama3 2x1 auto", "llama3-8b", (2, 1), {}, "auto"),
    ("smollm 1x2 auto", "smollm-135m", (1, 2), {}, "auto"),
    # two tokens a rank in a decode step: groups of two
    ("qwen2-moe 2x2 head", "qwen2-moe-a2.7b", (2, 2), {"group_size": 2},
     "head"),
    ("zamba2 2x2 auto", "zamba2-2.7b", (2, 2), {}, "auto"),
    ("zamba2 2x2 seq", "zamba2-2.7b", (2, 2), {}, "seq"),
    ("rwkv6 2x2 auto", "rwkv6-3b", (2, 2), {}, "auto"),
)
ENCODE_CASES = (("hubert 2x2", "hubert-xlarge", (2, 2)),)


def smoke_cfg(arch: str, **moe):
    cfg = get_smoke_config(arch).with_(param_dtype="float32",
                                       compute_dtype="float32")
    if moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def init_params(cfg) -> dict:
    return build_model(cfg).init(torch.Generator().manual_seed(SEED),
                                 device="cpu")


def train_batches(cfg, n: int = 2) -> list:
    """``n`` seeded (inputs, targets) pairs of BATCH x SEQ."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
        inputs = (rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(
            np.float32) if cfg.encoder_only else toks[:, :-1])
        out.append((torch.from_numpy(inputs),
                    torch.from_numpy(toks[:, 1:])))
    return out


def serve_tokens(cfg) -> torch.Tensor:
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (BATCH, PROMPT + NEW)))


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh
    data, model = shape
    return init_device_mesh("cpu", (4 // (data * model), data, model),
                            mesh_dim_names=("rep", "data", "model")
                            )["data", "model"]


def _specs(tree):
    return tree_map(lambda a: a.spec, tree)


def _local_shapes_ok(tree_args, tree_local) -> bool:
    """Each local tensor's shape is its example's global shape divided by
    the example's spec."""
    return all(tuple(t.shape) == a.local_shape
               for (_, a), (_, t) in zip(tree_flatten(tree_args),
                                         tree_flatten(tree_local)))


def train_case(rank, arch, shape, moe, seq_shard) -> dict:
    cfg = smoke_cfg(arch, **moe)
    mesh = mesh_of(shape)
    train = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=BATCH)
    step, (state_args, batch_args), _ = make_step_and_specs(
        cfg, mesh, train, seq_shard=seq_shard, opt_cfg=OPT)
    pspecs = _specs(state_args["params"])
    bspec = batch_args["targets"].spec
    batches = [(shard_tensor(i, bspec, mesh), shard_tensor(t, bspec, mesh))
               for i, t in train_batches(cfg)]
    state = opt.init_state(shard_tree(init_params(cfg), pspecs, mesh))
    shapes_ok = _local_shapes_ok(state_args["params"], state["params"]) \
        and _local_shapes_ok(state_args["m"], state["m"])
    losses, norms, grads = [], [], []
    for inputs, targets in batches:
        # the loss and gradients this step applies (the CPU step is
        # deterministic)
        lg = step.loss_and_grads(state["params"], inputs, targets)
        if not grads:
            loss, metrics = lg[:2]
        grads.append(gather_tree(lg[2], pspecs, mesh))
        state, m = step(state, {"inputs": inputs, "targets": targets})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": float(loss), "aux": float(metrics["aux"]),
            "grads": grads,
            **{k: gather_tree(state[k], pspecs, mesh)
               for k in ("params", "m", "v")},
            "losses": losses, "grad_norms": norms,
            "shapes_ok": shapes_ok, "cfg_heads": step.plan.cfg_local.n_heads,
            "tp_blocks": dict(step.plan.tp_blocks)}


def serve_case(rank, arch, shape, moe, kv_mode) -> dict:
    cfg = smoke_cfg(arch, **moe)
    mesh = mesh_of(shape)
    dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=SEQ,
                              global_batch=BATCH)
    pre = dataclasses.replace(dec, kind="prefill")
    pstep, (pargs, tok_arg, cache_args), _ = make_step_and_specs(
        cfg, mesh, pre, kv_mode=kv_mode)
    dstep, _, _ = make_step_and_specs(cfg, mesh, dec, kv_mode=kv_mode)
    params = shard_tree(init_params(cfg), _specs(pargs), mesh)
    # an fp32 cache: the split-KV combine rounds its probabilities to the
    # cache's dtype, the plain decode to the activations'
    cache = tree_map(lambda a: torch.zeros(
        a.local_shape, dtype=torch.float32 if a.dtype.is_floating_point
        else a.dtype), cache_args)
    shapes_ok = _local_shapes_ok(pargs, params)
    toks = shard_tensor(serve_tokens(cfg), tok_arg.spec, mesh)
    logits, cache = pstep(params, toks[:, :PROMPT], cache)
    out = [logits]
    for i in range(NEW):
        logits, cache = dstep(params, toks[:, PROMPT + i:PROMPT + i + 1],
                              cache)
        out.append(logits)
    return {"logits": out, "batch_spec": tok_arg.spec,
            "kv_mode": dstep.kv_mode, "split": dstep.use_split,
            "shapes_ok": shapes_ok, "index": int(cache["index"])}


def encode_case(rank, arch, shape) -> dict:
    cfg = smoke_cfg(arch)
    mesh = mesh_of(shape)
    pre = dataclasses.replace(SHAPES["prefill_32k"], seq_len=SEQ,
                              global_batch=BATCH)
    step, (pargs, inp_arg), _ = make_step_and_specs(cfg, mesh, pre)
    params = shard_tree(init_params(cfg), _specs(pargs), mesh)
    inputs = shard_tensor(train_batches(cfg, 1)[0][0], inp_arg.spec, mesh)
    return {"hidden": step(params, inputs), "batch_spec": inp_arg.spec}


def checkpoint_case(rank, ref_dir: str, port_dir: str) -> dict:
    """A sharded llama3 state saved from 2 x 2 (FSDP specs) restores on
    1 x 2 under the serving specs; the reference's saved state restores
    onto this rank's 2 x 2 blocks."""
    cfg = smoke_cfg("llama3-8b")
    model = build_model(cfg)
    mesh = mesh_of((2, 2))
    ssh = state_shardings(model, mesh)
    state = opt.init_state(init_params(cfg))
    state["m"] = tree_map(lambda t: t + 0.5, state["m"])
    state["step"] += 7
    local = {k: shard_tree(v, _specs(ssh[k]), mesh) if k != "step" else v
             for k, v in state.items()}
    cm = CheckpointManager(port_dir)
    cm.save(7, local, shardings=ssh)
    # restore on 1 x 2 with the serving specs (model axis only)
    mesh_b = mesh_of((1, 2))
    from repro_torch.distributed.sharding import param_shardings
    psh_b = param_shardings(state["params"], mesh_b, fsdp=False)
    shb = {"params": psh_b, "m": psh_b, "v": psh_b,
           "step": NamedSharding(mesh_b, ())}
    like = {k: tree_map(lambda t, s: torch.empty(s.local_shape(t.shape),
                                                 dtype=t.dtype),
                        state[k], shb[k]) if k != "step" else state[k]
            for k in ("params", "m", "v", "step")}
    back = cm.restore(7, like, shb)
    equal = all(torch.equal(a, shard_tensor(b, s.spec, mesh_b))
                for k in ("params", "m")
                for (_, a), (_, b), (_, s) in zip(
                    tree_flatten(back[k]), tree_flatten(state[k]),
                    tree_flatten(shb[k])))
    # the reference's checkpoint of {"x": [8, 8]} onto this rank's block
    x_sh = {"x": NamedSharding(mesh, ("model", "data"))}
    ref = CheckpointManager(ref_dir).restore(
        1, {"x": torch.empty((4, 4))}, x_sh)
    return {"reshard_equal": equal, "step": int(back["step"]),
            "ref_block": ref["x"]}


def sharded_steps_rank(rank: int, ref_dir: str, port_dir: str) -> dict:
    torch.set_num_threads(1)
    out = {"train": {}, "serve": {}, "encode": {}}
    for name, arch, shape, moe, seq_shard in TRAIN_CASES:
        res = train_case(rank, arch, shape, moe, seq_shard)
        if rank:                    # the gathered tensors: rank 0's only
            res = {k: v for k, v in res.items()
                   if k not in ("grads", "params", "m", "v")}
        out["train"][name] = res
    for name, arch, shape, moe, kv_mode in SERVE_CASES:
        out["serve"][name] = serve_case(rank, arch, shape, moe, kv_mode)
    for name, arch, shape in ENCODE_CASES:
        out["encode"][name] = encode_case(rank, arch, shape)
    out["checkpoint"] = checkpoint_case(rank, ref_dir, port_dir)
    return out
