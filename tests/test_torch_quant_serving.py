"""The port's quantized serving path against the reference's PAGED batcher:
PagedBatcher with quantized weights (int8, w4a16) and/or an int8 KV pool
gives the reference's greedy tokens on the fp32 llama3 smoke model, in
every engine mode and sync arm, and drains its pool."""
import jax
import numpy as np
import pytest
import torch

from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.partition import QuantWeight
from repro_torch.kernels.hetero_matmul import ops
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


@pytest.fixture(scope="module")
def port_params(smoke_model):
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.mark.parametrize("quant", list(QUANT))
def test_quant_arms_give_reference_paged_tokens(smoke_model, port_params,
                                                quant):
    weight_quant, kv_quant = QUANT[quant]
    ref_cfg, _, ref_params = smoke_model
    ref = RefPagedBatcher(ref_cfg, ref_params, engine_mode="hetero-tensor",
                          weight_quant=weight_quant, kv_quant=kv_quant,
                          sync="device", window=4, **POOL)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
    ref.run(ref_reqs)
    ref.kv.assert_drained()
    expect = [r.output for r in ref_reqs]
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
            stats, ref_stats = cb.stats(), ref.stats()
            for key in stats:
                assert stats[key] == ref_stats[key], key


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
