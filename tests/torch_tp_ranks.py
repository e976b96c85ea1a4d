"""Rank bodies of the port's tensor-parallel CPU tests
(tests/test_torch_tp_serving.py, tests/test_torch_split_kv.py).

Each function runs in one spawned process of a gloo group
(``repro_torch.launch.mesh.spawn_ranks``), computes every case of its test
module once, and returns plain data (token streams, stats, shapes, numpy
arrays, error messages) that the test module compares with the
single-device port and the reference. This module imports torch and the
port only, so a rank starts without JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.partition import QuantWeight
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.serving.layout import MeshLayout
from repro_torch.serving.scheduler import PagedBatcher, Request
from repro_torch.serving.spec import SpecConfig

BS = 16
N_NEW = 8
PROMPT_LENS = (5, 12, 33)       # straddles block and bucket boundaries
POOL = dict(num_blocks=40, block_size=BS, max_blocks_per_seq=4,
            decode_width=3, buckets=(16, 32), cache_dtype=torch.float32)

# arm -> PagedBatcher kwargs: the reference's tests/test_tp_serving.py ARMS
ARMS = {
    "host": dict(sync="host"),
    "device": dict(sync="device", window=3),
    "mixed": dict(sync="device", window=3, mixed_batch=True),
    "prefix_cache": dict(sync="host", prefix_cache=True),
    "spec_self": dict(sync="host", spec=SpecConfig(k=2)),
    "w4a16_kv_int8": dict(sync="device", window=3, weight_quant="w4a16",
                          kv_quant="int8"),
    "w_int8": dict(sync="host", weight_quant="int8"),
    "kv_int8": dict(sync="host", kv_quant="int8"),
}
TP4_ARMS = ("host", "device")


def smoke_cfg(**kw):
    return get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                               compute_dtype="float32", **kw)


def tp4_params():
    """The n_kv_heads=4 smoke variant (TP = 4 must divide the KV heads),
    seeded: (cfg, params)."""
    cfg = smoke_cfg(n_kv_heads=4)
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(7),
                                      device="cpu")


def prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def serve(cfg, params, mesh=None, **kw):
    """One closed-loop serve through the paged batcher: (rid -> tokens,
    stats), the pool drained."""
    b = PagedBatcher(cfg, params, mesh=mesh, device="cpu", **POOL, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts(cfg))]
    b.run(reqs)
    if not all(r.done for r in reqs) or b.busy or b.queue:
        raise RuntimeError("the batcher left work undone")
    b.kv.assert_drained()
    return {r.rid: tuple(r.output) for r in reqs}, b.stats()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def tp_serving_rank(rank: int, params: dict, qparams: dict) -> dict:
    """Every case of test_torch_tp_serving.py on one of 4 ranks: the arms
    at TP = 2 on a data 2 x model 2 mesh (two replicas of the TP pair),
    TP = 4, placement, the prefix replay, the reference's quantized params
    (``qparams``, converted) sliced, and the validation errors. ``params``:
    the reference's smoke params, converted."""
    torch.set_num_threads(1)
    cfg = smoke_cfg()
    mesh22 = make_host_mesh(2, 2, device="cpu")
    out = {"arms": {arm: serve(cfg, params, mesh22, **kw)
                    for arm, kw in ARMS.items()}}
    out["prefix_replay"] = serve(cfg, params, mesh22,
                                 **ARMS["prefix_cache"])[0]

    b = PagedBatcher(cfg, params, mesh=mesh22, device="cpu", kv_quant="int8",
                     **POOL)
    lay = b.layout
    flat = {path: leaf for path, leaf in _leaves(b.params)}
    out["placement"] = {
        "shapes": {path: tuple(t.shape) for path, t in flat.items()},
        "shares_full": {path: t.data_ptr() == dict(_leaves(params))[path]
                        .data_ptr() for path, t in flat.items()},
        "pool": {name: tuple(t.shape) for name, t in b.kv.pool.items()},
        "plan": lay.shard_plan(b.params),
        "rank": lay.rank, "tp": lay.tp, "capturable": lay.capturable,
        "wq": _np(b.params["layers"]["attn"]["wq"]),
        "head_dim": lay.cfg_local.head_dim,
    }
    placed = lay.place_params(qparams)
    out["quant"] = {path: _np(t) for path, t in _leaves(placed)
                    if lay.shard_plan(qparams)[path]}

    mesh14 = make_host_mesh(1, 4, device="cpu")
    cfg4, params4 = tp4_params()
    out["tp4"] = {arm: serve(cfg4, params4, mesh14, **ARMS[arm])
                  for arm in TP4_ARMS}
    from torch.distributed.device_mesh import init_device_mesh
    mesh_x = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
    out["errors"] = {
        "n_kv_heads": _error(lambda: PagedBatcher(
            cfg, params, mesh=mesh14, device="cpu", **POOL)),
        "engine_mode": _error(lambda: PagedBatcher(
            cfg, params, mesh=mesh22, engine_mode="hetero-tensor",
            device="cpu", **POOL)),
        "no_model_axis": _error(lambda: PagedBatcher(
            cfg, params, mesh=mesh_x, device="cpu", **POOL)),
        "hetero_ctx": _error(lambda: lay.step_fns(None).paged_prefill(
            b.params, None, b.kv.pool, block_table=None,
            hetero_ctx=object())),
        "family": _error(lambda: MeshLayout(
            get_smoke_config("qwen2-moe-a2.7b"), mesh22)),
    }
    return out


def _leaves(tree, prefix=""):
    """(path, tensor) of every leaf; a QuantWeight as ``/wq`` and
    ``/scale``."""
    for key, leaf in tree.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, dict):
            yield from _leaves(leaf, path + "/")
        elif isinstance(leaf, QuantWeight):
            yield path + "/wq", leaf.wq
            yield path + "/scale", leaf.scale
        else:
            yield path, leaf


# ------------------------------------------------------------- split-KV --

SPLIT_KV_POSITIONS = (0, 15, 16, 37, 63)


def split_kv_inputs(B=4, Smax=64, Hq=8, Hkv=2, D=16, seed=0):
    """q, k_new, v_new, k_cache, v_cache as numpy fp32, from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = [(B, 1, Hq, D), (B, 1, Hkv, D), (B, 1, Hkv, D),
              (B, Smax, Hkv, D), (B, Smax, Hkv, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def combine_inputs(B=3, K=48, Hkv=2, G=4, D=16, seed=1):
    """Ragged-length masked scores [B, Hkv, G, K] and values [B, K, Hkv, D]
    (lengths 1, 17, 48: 17 straddles a quarter of K, a length-1 row leaves
    three ranks all masked)."""
    from repro_torch.distributed.split_kv import NEG_INF
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    s = np.einsum("bhgd,bkhd->bhgk", q, k)
    mask = np.arange(K)[None, :] < np.asarray([1, 17, 48])[:, None]
    s = np.where(mask[:, None, None, :], s, NEG_INF).astype(np.float32)
    return s, v


def psum_input(seed=2):
    return np.random.default_rng(seed).standard_normal(
        (4, 128)).astype(np.float32)


def split_kv_rank(rank: int) -> dict:
    """Every collective case of test_torch_split_kv.py on one of 4 ranks:
    split-KV decode on a 1 x 4 and a 2 x 2 mesh (this rank's output and
    cache blocks per position), the combine over the 4-rank model group,
    ``compressed_psum`` and ``tp_all_gather``."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.split_kv import (
        combine_split_softmax, local_shard, split_kv_decode_update_attend)
    from repro_torch.models.layers import tp_all_gather
    torch.set_num_threads(1)
    out = {"split_kv": {}}
    q, kn, vn, kc, vc = (torch.from_numpy(a) for a in split_kv_inputs())
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape, device="cpu")
        qb, knb, vnb = (_batch_shard(t, mesh) for t in (q, kn, vn))
        for pos in SPLIT_KV_POSITIONS:
            ck = local_shard(kc, mesh).clone()
            cv = local_shard(vc, mesh).clone()
            o, ck, cv = split_kv_decode_update_attend(
                qb, knb, vnb, ck, cv, torch.tensor(pos), mesh)
            out["split_kv"][shape, pos] = (_np(o), _np(ck), _np(cv))
    mesh = make_host_mesh(1, 4, device="cpu")
    group = mesh.get_group("model")
    s, v = combine_inputs()
    kq = s.shape[-1] // 4
    out["combine"] = _np(combine_split_softmax(
        torch.from_numpy(s[..., rank * kq:(rank + 1) * kq]),
        torch.from_numpy(v[:, rank * kq:(rank + 1) * kq]), group))
    out["psum"] = _np(compressed_psum(
        torch.from_numpy(psum_input()[rank:rank + 1]), group))
    out["gather"] = _np(tp_all_gather(
        torch.full((2, 1, 3), float(rank)) + torch.arange(3.0), group))
    return out


def _batch_shard(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the batch axis over the mesh's ``data`` axis."""
    from repro_torch.distributed.sharding import axis_rank, axis_size
    n = axis_size(mesh, "data")
    b = t.shape[0] // n
    i = axis_rank(mesh, "data")
    return t[i * b:(i + 1) * b]


# ------------------------------------------------ open loop over the mesh --

OPEN_LOOP = {"poisson": dict(kind="poisson", rate=400.0, seed=3),
             "burst": dict(kind="burst", rate=400.0, seed=4)}
OPEN_LOOP_STEP = 1e-3           # virtual seconds a tick (FakeClock)


def open_loop_workload(cfg, kind: str, rate: float, seed: int):
    """Eight seeded prompts, every other one low priority, arriving on the
    seeded ``kind`` schedule: with two lanes and a small pool the high
    arrivals defer and preempt."""
    from repro_torch.serving.ingress import arrival_times
    from repro_torch.serving.ingress import open_loop_workload as workload
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 30, size=8)]
    return workload(prompts, [N_NEW] * 8, arrival_times(kind, rate, 8, seed),
                    [i % 2 for i in range(8)])


def open_loop(cfg, params, mesh=None, *, kind, rate, seed) -> dict:
    """One open-loop run through ``AsyncServer`` on a FakeClock over the
    paged batcher (two lanes, 14 blocks), with one admission for the
    mesh's model group: (rid -> tokens, stats(), report())."""
    from repro_torch.serving.ingress import AsyncServer, TickBroadcast
    from repro_torch.serving.telemetry import FakeClock
    pool = dict(POOL, num_blocks=14, decode_width=2)
    b = PagedBatcher(cfg, params, mesh=mesh, device="cpu", sync="device",
                     window=3, **pool)
    sync = None if mesh is None else TickBroadcast(mesh.get_group("model"))
    server = AsyncServer(b, clock=FakeClock(), step_time_s=OPEN_LOOP_STEP,
                         admit_watermark=1, tick_sync=sync)
    handles = server.run_sync(open_loop_workload(cfg, kind, rate, seed))
    b.kv.assert_drained()
    # the mesh's own keys aside ("tp", and "captured": gloo runs eager)
    stats = {k: v for k, v in server.stats().items()
             if k not in ("tp", "captured")}
    return {"tokens": {h.rid: tuple(h.tokens) for h in handles},
            "stats": stats, "report": server.report(slo_ms=20.0)}


def open_loop_rank(rank: int, params: dict) -> dict:
    """Both schedules at TP = 2 on a data 2 x model 2 mesh: each replica's
    model-rank 0 admits, its partner applies the broadcast decisions."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2, device="cpu")
    return {name: open_loop(smoke_cfg(), params, mesh, **kw)
            for name, kw in OPEN_LOOP.items()}
