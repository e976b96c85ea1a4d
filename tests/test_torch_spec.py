"""The port's speculative decoding against the reference's: ``paged_verify``
logits within 1e-4 in xla and hetero-tensor modes, ``greedy_verify`` on
seeded cases (ties included), ``prefill_slot`` and per-slot ``decode_step``
within 1e-4, and ``PagedBatcher(spec=...)`` / ``SpecDecoder`` giving the
reference's greedy tokens and ``stats()`` on the fp32 llama3 smoke model,
self-drafted and with an independent smollm draft, in both sync modes
(with int8 + int8 KV and W4A16 weights: tests/test_torch_quant_serving.py).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro.serving.sampler import greedy_verify as ref_greedy_verify
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro.serving.spec import SpecDecoder as RefSpecDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import build_hetero_ctx
from repro_torch.models import build_model
from repro_torch.serving.sampler import greedy_verify
from repro_torch.serving.scheduler import PagedBatcher, Request
from repro_torch.serving.spec import DraftLanes, SpecConfig, SpecDecoder

LOGITS_TOL = 1e-4
K = 3
PROMPT_LENS = (5, 70, 40)
NEW_TOKENS = 7
POOL = dict(num_blocks=1 + 3 * 5, block_size=32, max_blocks_per_seq=5,
            decode_width=2)
SYNCS = {"host": dict(sync="host"), "device": dict(sync="device")}
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _prompts():
    rng = np.random.default_rng(31)
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
    cfg = get_smoke_config("llama3-8b").with_(**FP32)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def drafts():
    """The independent draft: the smollm smoke model in fp32, the
    reference's parameters in both packages."""
    ref_cfg = ref_get_smoke_config("smollm-135m").with_(**FP32)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(8))
    cfg = get_smoke_config("smollm-135m").with_(**FP32)
    return (ref_cfg, ref_params, cfg,
            params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                              "cpu"))


@pytest.fixture(scope="module")
def ref_runs(smoke_model, drafts):
    """The reference's spec batcher (sync device) per draft, run once each
    on first use: (tokens, stats)."""
    cfg, _, params = smoke_model
    done = {}

    def run(draft):
        if draft not in done:
            spec = RefSpecConfig(k=K, draft=None if draft == "self"
                                 else drafts[0])
            cb = RefPagedBatcher(cfg, params, spec=spec, sync="device",
                                 spec_draft_params=None if draft == "self"
                                 else drafts[1], **POOL)
            reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(_prompts())]
            cb.run(reqs)
            cb.kv.assert_drained()
            done[draft] = [r.output for r in reqs], cb.stats()
        return done[draft]
    return run


# ---------------------------------------------------------- model entries --

@pytest.mark.parametrize("mode", ["xla", "hetero-tensor"])
def test_paged_verify_logits_match_reference(smoke_model, port_params, mode):
    """Two lanes at different starts append K+1 tokens each: every
    position's logits and the written pool within 1e-4 of the reference's,
    through the VERIFY view of each package's context."""
    ref_cfg, ref_model, ref_params = smoke_model
    cfg, params = port_params
    model = build_model(cfg)
    ref_ctx = ref_build_hetero_ctx(ref_cfg, mode, verify_ks=((K, 2),))
    ctx = build_hetero_ctx(cfg, mode, verify_ks=((K, 2),))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n) for n in (9, 20)]
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    tokens = rng.integers(0, 256, (2, K + 1))
    ref_pool = ref_model.init_paged_cache(num_blocks=8, block_size=16,
                                          dtype=jnp.float32)
    pool = model.init_paged_cache(num_blocks=8, block_size=16,
                                  dtype=torch.float32, device="cpu")
    ref_prefill = jax.jit(ref_model.paged_prefill)
    for p, t in zip(prompts, tables):
        _, ref_pool = ref_prefill(ref_params, jnp.asarray(p)[None], ref_pool,
                                  block_table=jnp.asarray(t)[None],
                                  start_index=0)
        model.paged_prefill(params, torch.as_tensor(p)[None], pool,
                            block_table=torch.as_tensor(t)[None])
    ref_logits, ref_pool = jax.jit(partial(
        ref_model.paged_verify, hetero_ctx=ref_ctx.for_verify(K, 2)))(
        ref_params, jnp.asarray(tokens, jnp.int32), ref_pool,
        block_table=jnp.asarray(tables),
        start_index=jnp.asarray([9, 20], jnp.int32))
    logits, pool = model.paged_verify(
        params, torch.as_tensor(tokens), pool,
        block_table=torch.as_tensor(tables),
        start_index=torch.tensor([9, 20]), hetero_ctx=ctx.for_verify(K, 2))
    assert logits.shape == (2, K + 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name].numpy(),
                                   np.asarray(ref_pool[name]),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)


def _verify_cases():
    rng = np.random.default_rng(17)
    cases = []
    for B, k, V in ((3, 4, 11), (2, 1, 5), (4, 3, 7)):
        logits = rng.integers(-2, 3, (B, k + 1, V)).astype(np.float32)
        greedy = logits.argmax(-1)
        drafts = rng.integers(0, V, (B, k))
        drafts[0] = greedy[0, :k]                    # lane 0: all accepted
        drafts[1, 0] = greedy[1, 0]                  # lane 1: first one
        cases.append((drafts, logits))
    ties = np.zeros((1, 3, 6), np.float32)           # every position tied:
    ties[0, :, [2, 4]] = 1.0                         # argmax takes index 2
    cases.append((np.array([[2, 4]]), ties))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_greedy_verify_matches_reference(case):
    drafts, logits = _verify_cases()[case]
    ref_emit, ref_n = ref_greedy_verify(jnp.asarray(drafts, jnp.int32),
                                        jnp.asarray(logits))
    emit, n = greedy_verify(torch.as_tensor(drafts),
                            torch.from_numpy(logits))
    assert n.tolist() == np.asarray(ref_n).tolist()
    assert emit.tolist() == np.asarray(ref_emit).tolist()
    if case == 3:
        assert n.tolist() == [2] and emit.tolist() == [[2, 2, 2]]


def test_prefill_slot_and_slot_decode_match_reference(smoke_model,
                                                      port_params):
    """Prompts of different lengths prefilled into slots 0 and 2 of a
    3-lane dense cache (chunks, the second at a nonzero start), then three
    per-slot decode steps: logits and the cache within 1e-4 of the
    reference's."""
    ref_cfg, ref_model, ref_params = smoke_model
    cfg, params = port_params
    model = build_model(cfg)
    rng = np.random.default_rng(9)
    ref_cache = ref_model.init_cache(batch=3, max_len=48, dtype=jnp.float32)
    ref_cache["index"] = jnp.zeros((3,), jnp.int32)
    cache = model.init_cache(batch=3, max_len=48, dtype=torch.float32,
                             device="cpu")
    cache["index"] = torch.zeros((3,), dtype=torch.int32)
    ref_slot = jax.jit(partial(ref_transformer.prefill_slot, cfg=ref_cfg),
                       static_argnames=("chunk",))
    lengths = np.zeros((3,), np.int32)
    for slot, chunks in ((0, (16, 5)), (2, (9,))):
        start = 0
        for c in chunks:
            toks = rng.integers(0, 256, c)
            ref_logits, ref_cache = ref_slot(
                ref_params, ref_cache, jnp.asarray(toks, jnp.int32),
                jnp.asarray(slot), jnp.asarray(start, jnp.int32), chunk=c)
            logits, cache = model.prefill_slot(
                params, cache, torch.as_tensor(toks), slot, start)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(ref_logits),
                                       atol=LOGITS_TOL, rtol=LOGITS_TOL)
            start += c
        lengths[slot] = start
    ref_cache["index"] = jnp.asarray(lengths)
    cache["index"] = torch.as_tensor(lengths)
    ref_decode = jax.jit(ref_model.decode_step)
    for step in range(3):
        tok = rng.integers(0, 256, (3, 1))
        ref_logits, ref_cache = ref_decode(ref_params,
                                           jnp.asarray(tok, jnp.int32),
                                           ref_cache)
        logits, cache = model.decode_step(params, torch.as_tensor(tok),
                                          cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert cache["index"].tolist() == (lengths + 3).tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_draft_lanes_host_and_device_draft_alike(port_params):
    """The draft round as one loop (sync device; eager on the CPU, its
    graph's body) and as k+1 steps (sync host) give the same drafts, and a
    rollback makes the next round redraft from the accepted prefix."""
    cfg, params = port_params
    prompts = _prompts()[:2]
    out = {}
    for sync in SYNCS:
        lanes = DraftLanes(cfg, params, lanes=2, max_len=96, sync=sync,
                           dtype=torch.float32, device="cpu")
        for lane, p in enumerate(prompts):
            lanes.prefill(lane, p)
        last = np.array([[3], [9]])
        first = lanes.draft(last, K)
        lanes.rollback(0, len(prompts[0]))
        lanes.rollback(1, len(prompts[1]))
        again = lanes.draft(last, K)
        out[sync] = first, again, lanes.dispatches
        assert first.shape == (2, K)
        assert np.array_equal(first, again)
    assert np.array_equal(out["host"][0], out["device"][0])
    chunks = 1 + 2                      # 5 -> [5]; 70 -> [64, 6]
    assert out["host"][2] == chunks + 2 * (K + 1)
    assert out["device"][2] == chunks + 2


# ----------------------------------------------------------------- batcher --

@pytest.mark.parametrize("sync", list(SYNCS))
@pytest.mark.parametrize("draft", ["self", "smollm"])
def test_spec_batcher_matches_reference(port_params, drafts, ref_runs,
                                        draft, sync):
    """The port's spec batcher (hetero-tensor, the VERIFY plan) gives the
    reference spec batcher's tokens, which equal the non-spec batcher's,
    and its stats(); fewer target dispatches than decode steps."""
    ref_out, ref_stats = ref_runs(draft)
    cfg, params = port_params
    spec = SpecConfig(k=K, draft=None if draft == "self" else drafts[2])
    cb = PagedBatcher(cfg, params, spec=spec, engine_mode="hetero-tensor",
                      spec_draft_params=None if draft == "self"
                      else drafts[3], device="cpu", **POOL, **SYNCS[sync])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    cb.run(reqs)
    cb.kv.assert_drained()
    assert [r.output for r in reqs] == ref_out
    plain = PagedBatcher(cfg, params, device="cpu", **POOL)
    preqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
             for i, p in enumerate(_prompts())]
    plain.run(preqs)
    assert [r.output for r in preqs] == ref_out
    stats = cb.stats()
    assert set(stats) <= set(ref_stats)
    if sync == "device":
        assert stats == {k: ref_stats[k] for k in stats}
    else:      # the draft's dispatches count its k + 1 steps one by one
        assert {k: v for k, v in stats.items() if k != "draft_dispatches"} \
            == {k: ref_stats[k] for k in stats if k != "draft_dispatches"}
    assert stats["verify_dispatches"] < stats["decode_steps"]
    assert stats["draft_model"] == (cfg.name if draft == "self"
                                    else "smollm-smoke")


@pytest.mark.parametrize("sync", list(SYNCS))
def test_spec_decoder_matches_reference(smoke_model, port_params, sync):
    """The single-stream SpecDecoder: the reference's tokens and stats."""
    ref_cfg, _, ref_params = smoke_model
    prompt = _prompts()[1]
    ref = RefSpecDecoder(ref_cfg, ref_params, spec=RefSpecConfig(k=K),
                         max_len=128, sync="device")
    ref_out = ref.generate(prompt, NEW_TOKENS)
    cfg, params = port_params
    dec = SpecDecoder(cfg, params, spec=SpecConfig(k=K), max_len=128,
                      engine_mode="hetero-tensor", device="cpu",
                      **SYNCS[sync])
    assert dec.generate(prompt, NEW_TOKENS) == ref_out
    dec.kv.assert_drained()
    stats, ref_stats = dec.stats(), ref.stats()
    skip = () if sync == "device" else ("draft_dispatches",)
    assert {k: v for k, v in stats.items() if k not in skip} == \
        {k: v for k, v in ref_stats.items() if k not in skip}


@pytest.mark.parametrize("bad", ["k0", "vocab", "hybrid", "temperature"])
def test_spec_config_is_validated(port_params, bad):
    from repro_torch.serving.sampler import SamplerConfig
    cfg, params = port_params
    kw = {"k0": dict(spec=SpecConfig(k=0)),
          "vocab": dict(spec=SpecConfig(k=2, draft=cfg.with_(
              vocab_size=128))),
          "hybrid": dict(spec=SpecConfig(k=2, draft="zamba2-2.7b",
                                         smoke=True)),
          "temperature": dict(spec=2,
                              sampler=SamplerConfig(temperature=1.0))}[bad]
    with pytest.raises(ValueError):
        PagedBatcher(cfg, params, device="cpu", **POOL, **kw)


def test_spec_eos_stops_a_lane_early(port_params):
    """An EOS drafted and accepted mid-round ends the lane there, in the
    batcher (both syncs) and in SpecDecoder: the plain stream cut after
    its first EOS."""
    cfg, params = port_params
    plain = PagedBatcher(cfg, params, device="cpu", **POOL)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    plain.run(reqs)
    base = reqs[1].output
    eos = base[3]
    want = base[:base.index(eos) + 1]
    for sync in SYNCS:
        cb = PagedBatcher(cfg, params, spec=K, eos_id=eos, device="cpu",
                          **POOL, **SYNCS[sync])
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
        cb.run(reqs)
        cb.kv.assert_drained()
        assert reqs[1].output == want, sync
    dec = SpecDecoder(cfg, params, spec=SpecConfig(k=K), max_len=128,
                      eos_id=eos, device="cpu")
    assert dec.generate(_prompts()[1], NEW_TOKENS) == want
