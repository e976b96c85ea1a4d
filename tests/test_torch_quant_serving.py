"""The port's quantized serving path against the reference's PAGED batcher:
PagedBatcher with quantized weights (int8, w4a16) and/or an int8 KV pool
gives the reference's greedy tokens on the fp32 llama3 smoke model, in
every engine mode and sync arm, with mixed batching, speculative decoding
and the prefix cache too, and drains its pool; and every quantized serving
entry point (the reference's ``QUANT_SERVING_CHECKS``) against its
dequantize-then-fp version."""
import jax
import numpy as np
import pytest
import torch

from conftest import QUANT_SERVING_CHECKS, rel_err
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import build_hetero_ctx
from repro_torch.core.partition import QuantWeight
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.models import build_model
from repro_torch.models.quant import dequantize_params, quantize_params
from repro_torch.serving.scheduler import PagedBatcher, Request

PROMPT_LENS = (5, 70, 130)
NEW_TOKENS = 6
POOL = dict(num_blocks=1 + 3 * 5, block_size=32, max_blocks_per_seq=5,
            decode_width=4)
QUANT = {"w_int8": ("int8", None), "w_w4a16": ("w4a16", None),
         "kv_int8": (None, "int8"), "w_int8_kv_int8": ("int8", "int8"),
         "w_w4a16_kv_int8": ("w4a16", "int8")}
# (engine mode, sync arm): the reference's is the first
PORT_ARMS = (("hetero-tensor", dict(sync="device", window=4)),
             ("hetero-tensor", dict(sync="host")),
             ("mxu", dict(sync="device", window=4)),
             (None, dict(sync="device", window=4)))


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_params(smoke_model):
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def ref_runs(smoke_model):
    """The reference's paged batcher (hetero-tensor, sync device, window 4)
    per quantization arm, run once each on first use: (tokens, stats)."""
    ref_cfg, _, ref_params = smoke_model
    done = {}

    def run(quant):
        if quant not in done:
            weight_quant, kv_quant = QUANT[quant]
            ref = RefPagedBatcher(ref_cfg, ref_params,
                                  engine_mode="hetero-tensor",
                                  weight_quant=weight_quant,
                                  kv_quant=kv_quant, sync="device", window=4,
                                  **POOL)
            ref_reqs = [RefRequest(rid=i, prompt=p,
                                   max_new_tokens=NEW_TOKENS)
                        for i, p in enumerate(_prompts())]
            ref.run(ref_reqs)
            ref.kv.assert_drained()
            done[quant] = [r.output for r in ref_reqs], ref.stats()
        return done[quant]
    return run


@pytest.mark.parametrize("quant", list(QUANT))
def test_quant_arms_give_reference_paged_tokens(port_params, ref_runs,
                                                quant):
    weight_quant, kv_quant = QUANT[quant]
    expect, ref_stats = ref_runs(quant)
    assert all(len(o) == NEW_TOKENS for o in expect)

    cfg, params = port_params
    for mode, arm in PORT_ARMS:
        cb = PagedBatcher(cfg, params, engine_mode=mode,
                          weight_quant=weight_quant, kv_quant=kv_quant,
                          device="cpu", **POOL, **arm)
        if weight_quant is not None:
            assert isinstance(cb.params["layers"]["ffn"]["w_up"], QuantWeight)
            assert cb.ctx is None or cb.ctx.plan.weight_quant == weight_quant
        if kv_quant is not None:
            assert cb.kv.pool["k"].dtype == torch.int8
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
        cb.run(reqs)
        cb.kv.assert_drained()
        assert all(r.done for r in reqs)
        assert [r.output for r in reqs] == expect, (mode, arm)
        if arm["sync"] == "device":           # the reference's own arm
            stats = cb.stats()
            for key in stats:
                assert stats[key] == ref_stats[key], key


# the three serving arms, each in both sync modes
SERVING_ARMS = {
    "mixed-host": dict(mixed_batch=True, sync="host"),
    "mixed-device": dict(mixed_batch=True, sync="device", window=3),
    "spec-host": dict(spec=2, sync="host"),
    "spec-device": dict(spec=2, sync="device"),
    "prefix-host": dict(prefix_cache=True, sync="host"),
    "prefix-device": dict(prefix_cache=True, sync="device", window=4),
}


@pytest.mark.parametrize("arm", list(SERVING_ARMS))
@pytest.mark.parametrize("quant", ["w_int8_kv_int8", "w_w4a16"])
def test_quant_arms_compose_with_serving_arms(port_params, ref_runs, quant,
                                              arm):
    """Quantized weights and the int8 pool under mixed batching, speculative
    decoding (self-draft on the quantized weights) and the prefix cache
    (the prompts served twice: the second wave hits, its blocks shared as
    int8 codes and scales) give the reference's tokens; chunks fuse,
    drafts are accepted."""
    weight_quant, kv_quant = QUANT[quant]
    expect, _ = ref_runs(quant)
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, engine_mode="hetero-tensor",
                      weight_quant=weight_quant, kv_quant=kv_quant,
                      device="cpu", **POOL, **SERVING_ARMS[arm])
    for wave in range(2 if arm.startswith("prefix") else 1):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
        cb.run(reqs)
        cb.kv.assert_drained()
        assert [r.output for r in reqs] == expect, (arm, wave)
    stats = cb.stats()
    if arm.startswith("mixed"):
        assert stats["fused_steps"] > 0
    elif arm.startswith("spec"):
        assert 0 < stats["verify_dispatches"] < stats["decode_steps"]
    else:
        # every prompt holding a full block hits in the second wave
        assert stats["prefix_hits"] == sum(n >= POOL["block_size"]
                                           for n in PROMPT_LENS)


# ------------------------------------------ quantized serving entry points --

QUANT_FORMATS = ("int8", "w4a16")
ENTRY_POINTS = tuple(c for c in QUANT_SERVING_CHECKS
                     if c != "int8_pool_gather")


def _serving_entry(model, cfg, params, entry, ctx=None):
    """One serving entry point on ragged shapes (the reference
    conformance tier's): its logits."""
    B, S, NB, BS = 2, 9, 16, 8
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    bt = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]])
    pool = model.init_paged_cache(num_blocks=NB, block_size=BS,
                                  dtype=torch.float32, device="cpu")
    logits, pool = model.paged_prefill(params, tok, pool, block_table=bt,
                                       start_index=0, hetero_ctx=ctx)
    if entry == "paged_prefill":
        return logits
    nxt = logits[:, -1].argmax(-1)[:, None]
    lengths = torch.tensor([S, S])
    if entry == "paged_decode_step":
        return model.paged_decode_step(params, nxt, pool, block_tables=bt,
                                       lengths=lengths, hetero_ctx=ctx)[0]
    if entry == "paged_verify":
        vt = torch.cat([nxt, (nxt + 1) % cfg.vocab_size], dim=1)
        vctx = ctx.for_verify(1, B) if ctx is not None else None
        return model.paged_verify(params, vt, pool, block_table=bt,
                                  start_index=lengths, hetero_ctx=vctx)[0]
    assert entry == "mixed_step"
    chunk = torch.randint(0, cfg.vocab_size, (1, 5), generator=g)
    dlg, plg, _ = model.mixed_step(params, nxt, chunk, pool,
                                   decode_tables=bt, decode_lengths=lengths,
                                   prefill_table=torch.tensor([[7, 8, 0, 0]]),
                                   prefill_start=torch.tensor(0),
                                   hetero_ctx=ctx)
    return torch.cat([dlg[:, -1], plg[:, -1]], dim=0)


@pytest.fixture(scope="module")
def quant_params(port_params):
    cfg, params = port_params
    out = {}
    for fmt in QUANT_FORMATS:
        qp = quantize_params(params, cfg, fmt)
        out[fmt] = (qp, dequantize_params(qp),
                    build_hetero_ctx(cfg, "hetero-tensor", weight_quant=fmt,
                                     mixed_pairs=((5, 2),),
                                     verify_ks=((1, 2),)))
    return out


@pytest.mark.parametrize("path", ["flexible", "hetero"])
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_quant_serving_entry_points(port_params, quant_params, entry, fmt,
                                    path):
    """Each quantized entry point against dequantize-then-fp: the plan-free
    path exactly to fp32 rounding (both sides multiply the same
    dequantized values), the hetero-tensor plan (the dequantizing GEMMs'
    plain versions on the CPU) within 1e-4."""
    cfg, _ = port_params
    model = build_model(cfg)
    qp, dq, ctx = quant_params[fmt]
    got = _serving_entry(model, cfg, qp, entry,
                         ctx=ctx if path == "hetero" else None)
    want = _serving_entry(model, cfg, dq, entry)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want.numpy()) < (
        2e-6 if path == "flexible" else 1e-4)


def test_int8_pool_bytes_count_the_scale_planes(port_params):
    """pool_bytes counts the scale planes: int8 codes are a quarter of the
    fp32 pool's bytes, plus one bf16 scale per slot and tensor."""
    cfg, _ = port_params
    fp = PagedBatcher(cfg, None, device="cpu", **POOL)
    q = PagedBatcher(cfg, None, kv_quant="int8", device="cpu", **POOL)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    slots = L * POOL["num_blocks"] * POOL["block_size"]
    assert fp.kv.pool_bytes() == 2 * slots * Hkv * D * 4
    assert q.kv.pool_bytes() == 2 * slots * (Hkv * D + 2)


def test_cpu_quant_serving_launches_no_kernel(port_params):
    """On the CPU the wrappers take their plain versions: no launch counted."""
    cfg, params = port_params
    before = (ops.mxu_matmul.launches, ops.mxu_quant_matmul.launches,
              ops.mxu_q4_matmul.launches)
    cb = PagedBatcher(cfg, params, engine_mode="mxu", weight_quant="w4a16",
                      device="cpu", **POOL)
    cb.run([Request(rid=0, prompt=_prompts()[1], max_new_tokens=2)])
    assert (ops.mxu_matmul.launches, ops.mxu_quant_matmul.launches,
            ops.mxu_q4_matmul.launches) == before


@pytest.mark.parametrize("kw", [dict(weight_quant="int4"),
                                dict(kv_quant="fp8")])
def test_batcher_rejects_unknown_formats(port_params, kw):
    cfg, params = port_params
    with pytest.raises(ValueError):
        PagedBatcher(cfg, params, device="cpu", **POOL, **kw)
