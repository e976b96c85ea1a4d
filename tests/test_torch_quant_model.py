"""The port's quantized model path against the reference on the CPU: every
partition strategy on a QuantWeight, the quantized plans, the int8 KV
pool's codes and scales, paged prefill and decode over an int8 pool (and
quantized weights), and quantized params carried across by the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro import configs as ref_configs
from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.core.engine import build_plan as ref_build_plan
from repro.core.partition import HeteroCtx as RefHeteroCtx
from repro.core.partition import QuantWeight as RefQuantWeight
from repro.core.solver import Decision as RefDecision
from repro.models.layers import quantize_kv_slot as ref_quantize_kv_slot
from repro.models.quant import dequantize_params as ref_dequantize_params
from repro.models.quant import quantize_params as ref_quantize_params
from repro_torch import configs
from repro_torch.configs import dtype_of
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import build_hetero_ctx, build_plan
from repro_torch.core.partition import HeteroCtx, QuantWeight
from repro_torch.core.profiler import LatencyTable
from repro_torch.core.solver import Decision, PartitionPlan
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.models import build_model
from repro_torch.models.layers import dequant_kv_ref, quantize_kv_slot
from repro_torch.models.quant import (WEIGHT_FORMATS, dequantize_params,
                                      quantize_params)

FMTS = WEIGHT_FORMATS
# two layers of fp32 sums taken in another order than XLA's, over the same
# int8 codes and bf16 scales (the dequantized values are identical)
LOGITS_TOL = 1e-4
NUM_BLOCKS, BLOCK = 8, 32
TABLE = np.array([[1, 2, 3, 5, 0]], np.int32)
STRATEGIES = {               # strategy -> (n_split, m_bucket) at M = 300
    "xla_only": (0, 0), "mxu_only": (0, 0), "pad": (0, 384),
    "weight": (256, 0), "act": (0, 256), "hybrid": (128, 256)}


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("fmt", FMTS)
def test_execute_every_strategy_on_quant_weight(fmt, strategy):
    """HeteroCtx.execute on a QuantWeight (M 300, odd K 97, N 384), port vs
    the reference HeteroCtx (Pallas in interpret mode), fp32 and bf16."""
    rng = np.random.default_rng(1)
    M, K, N = 300, 97, 384
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    quant = ops.quantize_weight if fmt == "int8" else ops.quantize_weight_int4
    wq, s = quant(torch.from_numpy(w))
    tw = QuantWeight(wq, s, fmt, K)
    rw = RefQuantWeight(jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()),
                        fmt, K)
    n_split, m_bucket = STRATEGIES[strategy]
    dec = Decision("wq", M, strategy, 0.0, n_split=n_split, m_bucket=m_bucket)
    rdec = RefDecision("wq", M, strategy, 0.0, n_split=n_split,
                       m_bucket=m_bucket)
    for dt, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        ref = RefHeteroCtx(mode="hetero-tensor", interpret=True).execute(
            rdec, jnp.asarray(x).astype(dt), rw)
        y = HeteroCtx(mode="hetero-tensor").execute(
            dec, torch.from_numpy(x).to(dtype_of(dt)), tw)
        assert tuple(y.shape) == (M, N) and y.dtype == dtype_of(dt)
        assert rel_err(_np(y), np.asarray(ref, np.float32)) <= tol, dt


def _plan_key(plan):
    return {k: (d.strategy, d.n_split, d.m_bucket)
            for k, d in plan.decisions.items()}


@pytest.mark.parametrize("sync_mode", ["fast", "host"])
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_plans_match_reference(fmt, smoke, sync_mode):
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (configs.get_config, ref_configs.get_config))
    cfg, ref = get("llama3-8b"), ref_get("llama3-8b")
    table, plan = build_plan(cfg, sync_mode=sync_mode, weight_quant=fmt)
    ref_table, ref_plan = ref_build_plan(ref, sync_mode=sync_mode,
                                         weight_quant=fmt)
    assert plan.weight_quant == table.weight_quant == fmt
    assert _plan_key(plan) == _plan_key(ref_plan)
    for k, d in plan.decisions.items():
        assert d.t_us == pytest.approx(ref_plan.decisions[k].t_us, rel=1e-12)
    for k, t in table.entries.items():
        assert t == pytest.approx(ref_table.entries[k], rel=1e-12)
    if not smoke and sync_mode == "fast":
        # the fp plan differs: the cheaper weight stream moves the splits
        assert _plan_key(plan) != _plan_key(build_plan(cfg)[1])


def test_table_and_plan_save_load_keep_weight_quant(tmp_path):
    cfg = configs.get_smoke_config("llama3-8b")
    table, plan = build_plan(cfg, weight_quant="w4a16")
    table.save(tmp_path / "t.json")
    plan.save(tmp_path / "p.json")
    t2 = LatencyTable.load(tmp_path / "t.json")
    p2 = PartitionPlan.load(tmp_path / "p.json")
    assert t2.weight_quant == p2.weight_quant == "w4a16"
    assert t2.entries == table.entries and t2.sites == table.sites
    assert _plan_key(p2) == _plan_key(plan)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_slot_matches_reference(dtype):
    x = np.random.default_rng(2).standard_normal((9, 2, 16)).astype(
        np.float32) * 3
    x[4] = 0.0                                 # an all-zero slot: scale 0
    codes, sc = quantize_kv_slot(torch.from_numpy(x).to(dtype_of(dtype)))
    rc, rs = ref_quantize_kv_slot(jnp.asarray(x).astype(dtype))
    assert codes.dtype == torch.int8 and sc.dtype == torch.bfloat16
    assert codes.numpy().tobytes() == np.asarray(rc).tobytes()
    np.testing.assert_array_equal(sc.float().numpy(),
                                  np.asarray(rs, np.float32))
    assert float(sc[4]) == 0.0 and torch.all(codes[4] == 0)
    back = dequant_kv_ref(codes, sc, torch.float32)
    assert rel_err(back.numpy(), x) <= 1 / 127 + 1e-2


@pytest.fixture(scope="module")
def pair(smoke_model):
    ref_cfg, ref_model, ref_params = smoke_model
    cfg = configs.get_smoke_config("llama3-8b").with_(
        param_dtype="float32", compute_dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def _run_pair(pair, fmt, kv_quant, n, mode):
    """Prefill ``n`` tokens and one decode step (a second, inactive lane
    sinks its write into the null block), port vs reference, on the same
    (quantized) weights and pools. Returns both logits and both pools."""
    ref_cfg, ref_model, ref_params, cfg, model, params = pair
    if fmt is not None:
        ref_params = ref_quantize_params(ref_params, ref_cfg, fmt)
        params = quantize_params(params, cfg, fmt)
    rctx = (ref_build_hetero_ctx(ref_cfg, mode, weight_quant=fmt)
            if mode else None)
    ctx = build_hetero_ctx(cfg, mode, weight_quant=fmt) if mode else None
    rpool = ref_model.init_paged_cache(num_blocks=NUM_BLOCKS,
                                       block_size=BLOCK, dtype=jnp.float32,
                                       kv_quant=kv_quant)
    tpool = model.init_paged_cache(num_blocks=NUM_BLOCKS, block_size=BLOCK,
                                   dtype=torch.float32, kv_quant=kv_quant,
                                   device="cpu")
    tokens = _prompt(n)
    rl, rpool = ref_model.paged_prefill(
        ref_params, jnp.asarray(tokens), rpool,
        block_table=jnp.asarray(TABLE), hetero_ctx=rctx)
    tl, tpool = model.paged_prefill(
        params, torch.as_tensor(tokens).long(), tpool,
        block_table=torch.as_tensor(TABLE), hetero_ctx=ctx)
    tables = np.stack([TABLE[0], np.zeros_like(TABLE[0])])
    tok = np.array([[17], [3]], np.int32)
    lengths = np.array([n, 0], np.int32)
    rd, rpool = ref_model.paged_decode_step(
        ref_params, jnp.asarray(tok), rpool, block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lengths))
    td, tpool = model.paged_decode_step(
        params, torch.as_tensor(tok).long(), tpool,
        block_tables=torch.as_tensor(tables),
        lengths=torch.as_tensor(lengths).long())
    return (tl.numpy(), np.asarray(rl), td[:1].numpy(),
            np.asarray(rd)[:1], tpool, rpool)


@pytest.mark.parametrize("fmt,mode", [(None, None), ("int8", None),
                                      ("w4a16", "hetero-tensor")])
def test_int8_pool_prefill_and_decode_match_reference(pair, fmt, mode):
    tl, rl, td, rd, tpool, rpool = _run_pair(pair, fmt, "int8", 70, mode)
    assert rel_err(tl, rl) <= LOGITS_TOL
    assert rel_err(td, rd) <= LOGITS_TOL
    assert set(tpool) == set(rpool) == {"k", "v", "k_scale", "v_scale"}
    assert tpool["k"].dtype == torch.int8
    assert tpool["k_scale"].dtype == torch.bfloat16
    # the pool's written slots (blocks 1-3, positions 0..70) agree: every
    # scale bit for bit; codes to one step, where fp32 sums of another
    # order put a value on the other side of a rounding boundary
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(
            tpool[name][:, 1:4].float().numpy(),
            np.asarray(rpool[name][:, 1:4], np.float32))
    for name in ("k", "v"):
        diff = np.abs(tpool[name][:, 1:4].numpy().astype(np.int32)
                      - np.asarray(rpool[name][:, 1:4]).astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_weights_prefill_matches_reference(pair, fmt):
    """Quantized weights over the fp32 pool under the solver's quantized
    plan, port vs reference."""
    tl, rl, td, rd, _, _ = _run_pair(pair, fmt, None, 130, "hetero-tensor")
    assert rel_err(tl, rl) <= LOGITS_TOL
    assert rel_err(td, rd) <= LOGITS_TOL


@pytest.mark.parametrize("fmt", FMTS)
def test_convert_carries_quantized_params_bit_for_bit(pair, fmt):
    """The reference's quantized params through the bridge equal the port's
    quantize_params on the converted fp params, codes and scales bit for
    bit; dequantize_params agrees with the reference's."""
    ref_cfg, _, ref_params, cfg, _, params = pair
    ref_q = ref_quantize_params(ref_params, ref_cfg, fmt)
    bridged = params_from_numpy(jax.tree.map(np.asarray, ref_q), cfg, "cpu")
    ours = quantize_params(params, cfg, fmt)
    for site in ("wq", "wk", "wv", "wo"):
        a, b = bridged["layers"]["attn"][site], ours["layers"]["attn"][site]
        assert isinstance(a, QuantWeight) and isinstance(b, QuantWeight)
        assert (a.fmt, a.k, a.shape) == (b.fmt, b.k, b.shape)
        assert a.wq.dtype == torch.int8
        assert a.wq.numpy().tobytes() == b.wq.numpy().tobytes()
        assert a.scale.numpy().tobytes() == b.scale.numpy().tobytes()
    for site in ("w_gate", "w_up", "w_down"):
        a, b = bridged["layers"]["ffn"][site], ours["layers"]["ffn"][site]
        assert a.wq.numpy().tobytes() == b.wq.numpy().tobytes()
        assert a.scale.numpy().tobytes() == b.scale.numpy().tobytes()
    assert bridged["head"].wq.numpy().tobytes() == \
        ours["head"].wq.numpy().tobytes()
    assert torch.equal(bridged["embed"], ours["embed"])
    deq = dequantize_params(ours)
    ref_deq = ref_dequantize_params(ref_q)
    np.testing.assert_array_equal(
        deq["layers"]["ffn"]["w_down"].numpy(),
        np.asarray(ref_deq["layers"]["ffn"]["w_down"]))
    with pytest.raises(ValueError):
        quantize_params(params, cfg, "int3")
