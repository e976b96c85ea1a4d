"""The port's mixed batching against the reference's: ``mixed_step``'s
logits and pool writes within 1e-4 in xla and hetero-tensor modes, the
mixed window's staging against a step-by-step sequence, and
``PagedBatcher(mixed_batch=True)`` giving the reference's greedy tokens and
``stats()`` on the fp32 llama3 smoke model, in both sync modes (with int8 +
int8 KV and W4A16 weights: tests/test_torch_quant_serving.py)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import build_hetero_ctx
from repro_torch.core.sync import (paged_decode_window_eager,
                                   paged_mixed_window_loop)
from repro_torch.models import build_model
from repro_torch.serving.scheduler import PagedBatcher, Request

LOGITS_TOL = 1e-4
PROMPT_LENS = (5, 70, 40, 130)
NEW_TOKENS = 6
POOL = dict(num_blocks=1 + 4 * 5, block_size=32, max_blocks_per_seq=5,
            decode_width=3)
SYNCS = {"host": dict(sync="host"), "device-w3": dict(sync="device",
                                                      window=3)}


def _prompts():
    rng = np.random.default_rng(21)
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
    """The reference's mixed batcher per sync arm, run once each on first
    use: (tokens, stats)."""
    cfg, _, params = smoke_model
    done = {}

    def run(sync):
        if sync not in done:
            cb = RefPagedBatcher(cfg, params, mixed_batch=True, **POOL,
                                 **SYNCS[sync])
            reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(_prompts())]
            cb.run(reqs)
            cb.kv.assert_drained()
            done[sync] = [r.output for r in reqs], cb.stats()
        return done[sync]
    return run


def _run_port(port_params, **kw):
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, device="cpu", **POOL, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    cb.run(reqs)
    cb.kv.assert_drained()
    assert all(r.done and len(r.output) == NEW_TOKENS for r in reqs)
    return [r.output for r in reqs], cb


# -------------------------------------------------------- mixed_step logits --

def _mixed_inputs(cfg):
    rng = np.random.default_rng(5)
    return dict(prompts=[rng.integers(0, 256, n) for n in (9, 20, 16)],
                chunk=rng.integers(0, 256, (1, 11)),
                tables=np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32),
                ptable=np.array([[5, 6, 0, 0]], np.int32))


@pytest.mark.parametrize("mode", ["xla", "hetero-tensor"])
def test_mixed_step_logits_match_reference(smoke_model, port_params, mode):
    """Two decode lanes and an admitting request's second chunk (start 16)
    in one mixed_step, each pool prefilled by its own package: decode and
    prefill logits and the written pool within 1e-4 of the reference's."""
    ref_cfg, ref_model, ref_params = smoke_model
    cfg, params = port_params
    model = build_model(cfg)
    inp = _mixed_inputs(cfg)
    pairs = ((11, 2),)
    ref_ctx = ref_build_hetero_ctx(ref_cfg, mode, mixed_pairs=pairs)
    ctx = build_hetero_ctx(cfg, mode, mixed_pairs=pairs)
    NB, BS = 8, 16

    ref_pool = ref_model.init_paged_cache(num_blocks=NB, block_size=BS,
                                          dtype=jnp.float32)
    pool = model.init_paged_cache(num_blocks=NB, block_size=BS,
                                  dtype=torch.float32, device="cpu")
    ref_prefill = jax.jit(ref_model.paged_prefill)
    tables = list(inp["tables"]) + list(inp["ptable"])
    for p, t in zip(inp["prompts"], tables):
        _, ref_pool = ref_prefill(ref_params, jnp.asarray(p)[None], ref_pool,
                                  block_table=jnp.asarray(t)[None],
                                  start_index=0)
        _, pool = model.paged_prefill(params, torch.as_tensor(p)[None], pool,
                                      block_table=torch.as_tensor(t)[None],
                                      start_index=0)
    last = np.array([[7], [200]])
    lengths = np.array([9, 20])
    ref_dl, ref_pl, ref_pool = jax.jit(partial(ref_model.mixed_step,
                                               hetero_ctx=ref_ctx))(
        ref_params, jnp.asarray(last, jnp.int32),
        jnp.asarray(inp["chunk"], jnp.int32), ref_pool,
        decode_tables=jnp.asarray(inp["tables"]),
        decode_lengths=jnp.asarray(lengths, jnp.int32),
        prefill_table=jnp.asarray(inp["ptable"]),
        prefill_start=jnp.asarray(16, jnp.int32))
    dl, pl, pool = model.mixed_step(
        params, torch.as_tensor(last), torch.as_tensor(inp["chunk"]), pool,
        decode_tables=torch.as_tensor(inp["tables"]),
        decode_lengths=torch.as_tensor(lengths),
        prefill_table=torch.as_tensor(inp["ptable"]),
        prefill_start=torch.tensor(16), hetero_ctx=ctx)
    assert dl.shape == (2, 1, cfg.vocab_size)
    assert pl.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(dl.numpy(), np.asarray(ref_dl),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(ref_pl),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name].numpy(),
                                   np.asarray(ref_pool[name]),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_mixed_step_equals_decode_then_prefill(port_params):
    """The fusion changes no number: mixed_step's logits and pool equal a
    paged decode step followed by a paged prefill of the chunk."""
    cfg, params = port_params
    model = build_model(cfg)
    inp = _mixed_inputs(cfg)
    pools = [model.init_paged_cache(num_blocks=8, block_size=16,
                                    dtype=torch.float32, device="cpu")
             for _ in range(2)]
    tables = list(inp["tables"]) + list(inp["ptable"])
    for pool in pools:
        for p, t in zip(inp["prompts"], tables):
            model.paged_prefill(params, torch.as_tensor(p)[None], pool,
                                block_table=torch.as_tensor(t)[None])
    last, lengths = torch.tensor([[7], [200]]), torch.tensor([9, 20])
    chunk, tabs = torch.as_tensor(inp["chunk"]), torch.as_tensor(inp["tables"])
    ptab = torch.as_tensor(inp["ptable"])
    dl, pl, _ = model.mixed_step(params, last, chunk, pools[0],
                                 decode_tables=tabs, decode_lengths=lengths,
                                 prefill_table=ptab, prefill_start=16)
    dl2, _ = model.paged_decode_step(params, last, pools[1],
                                     block_tables=tabs, lengths=lengths)
    pl2, _ = model.paged_prefill(params, chunk, pools[1], block_table=ptab,
                                 start_index=16)
    torch.testing.assert_close(dl, dl2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pl, pl2, atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(pools[0][name], pools[1][name],
                                   atol=1e-5, rtol=1e-5)


def test_mixed_window_staging_equals_its_steps(port_params):
    """The mixed window loop (run eagerly on the CPU, as its graph's body)
    gives a mixed step then masked decode steps: the same tokens, -1 where
    a lane emitted nothing, and the chunk's logits."""
    cfg, params = port_params
    model = build_model(cfg)
    inp = _mixed_inputs(cfg)
    pools = [model.init_paged_cache(num_blocks=8, block_size=16,
                                    dtype=torch.float32, device="cpu")
             for _ in range(2)]
    tables = list(inp["tables"]) + list(inp["ptable"])
    for pool in pools:
        for p, t in zip(inp["prompts"], tables):
            model.paged_prefill(params, torch.as_tensor(p)[None], pool,
                                block_table=torch.as_tensor(t)[None])
    mixed = model.mixed_step
    loop = paged_mixed_window_loop(model, params, pools[0], 2, 4, 3, 11,
                                   mixed_step_fn=mixed)
    last, tabs = torch.tensor([[7], [200]]), torch.as_tensor(inp["tables"])
    lengths, remaining = torch.tensor([9, 20]), torch.tensor([3, 1])
    chunk, ptab = torch.as_tensor(inp["chunk"]), torch.as_tensor(
        inp["ptable"])
    toks, pre = loop(last, tabs, lengths, remaining, chunk, ptab,
                     torch.tensor(16))
    want, valid, want_pre, _, _, _ = paged_decode_window_eager(
        model, params, last, pools[1], tabs, lengths, remaining, 3,
        prefill_tokens=chunk, prefill_table=ptab, prefill_start=16,
        mixed_step_fn=mixed)
    assert valid.tolist() == [[True] * 3, [True, False, False]]
    assert torch.equal(toks, torch.where(valid, want, -1))
    torch.testing.assert_close(pre, want_pre)
    # step 0 is the fused step: lane tokens equal a plain decode step's
    dl, pl, _ = model.mixed_step(params, last, chunk, pools[1],
                                 decode_tables=tabs, decode_lengths=lengths,
                                 prefill_table=ptab, prefill_start=16)
    assert toks[:, 0].tolist() == dl[:, -1].argmax(-1).tolist()


# ----------------------------------------------------------------- batcher --

@pytest.mark.parametrize("sync", list(SYNCS))
def test_mixed_batcher_matches_reference(port_params, ref_runs, sync):
    """The port's mixed batcher (hetero-tensor) gives the reference mixed
    batcher's tokens and stats(), which equal the non-mixed batcher's
    tokens; chunks ride decode dispatches, one graph (on the card) per
    chunk length."""
    ref_out, ref_stats = ref_runs(sync)
    out, cb = _run_port(port_params, mixed_batch=True,
                        engine_mode="hetero-tensor", **SYNCS[sync])
    assert out == ref_out
    plain, _ = _run_port(port_params, engine_mode="hetero-tensor",
                         **SYNCS[sync])
    assert out == plain
    stats = cb.stats()
    assert stats["fused_steps"] > 0
    assert set(stats) <= set(ref_stats)
    assert stats == {k: ref_stats[k] for k in stats}
    kind = "mixed-tick" if sync == "host" else "mixed-window"
    chunks = {key[-1] for key in cb._loops if key[0] == kind}
    assert chunks and chunks <= {64, 128, 6, 40, 2}


def test_prefill_cap_bounds_the_chunks(port_params, ref_runs):
    """max_prefill_chunk_per_step=64 splits every admission into chunks of
    at most 64 tokens: one chunk more (130 = 64 + 64 + 2), the same
    tokens."""
    ref_out, ref_stats = ref_runs("device-w3")
    out, cb = _run_port(port_params, mixed_batch=True,
                        max_prefill_chunk_per_step=64, **SYNCS["device-w3"])
    assert out == ref_out
    assert cb.admit_buckets == (64,)
    stats = cb.stats()
    assert (stats["fused_steps"] + stats["prefill_dispatches"] ==
            ref_stats["fused_steps"] + ref_stats["prefill_dispatches"] + 1)
    assert all(key[-1] <= 64 for key in cb._loops
               if key[0] == "mixed-window")


@pytest.mark.parametrize("kw", [dict(mixed_batch=True, spec=2),
                                dict(mixed_batch=True,
                                     max_prefill_chunk_per_step=0)])
def test_mixed_batcher_rejects_bad_arguments(port_params, kw):
    cfg, params = port_params
    with pytest.raises(ValueError):
        PagedBatcher(cfg, params, device="cpu", **POOL, **kw)


@pytest.mark.parametrize("sync", list(SYNCS))
def test_mixed_eos_stops_a_lane_early(port_params, sync):
    """EOS ends a lane inside a chunk-carrying window or tick: the plain
    stream cut after its first EOS, the pool drained."""
    base, _ = _run_port(port_params, **SYNCS[sync])
    eos = base[2][2]
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, mixed_batch=True, eos_id=eos,
                      device="cpu", **POOL, **SYNCS[sync])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    cb.run(reqs)
    cb.kv.assert_drained()
    assert reqs[2].output == base[2][:base[2].index(eos) + 1]
    assert cb.stats()["fused_steps"] > 0
