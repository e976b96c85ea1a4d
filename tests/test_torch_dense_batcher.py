"""The port's dense ``ContinuousBatcher`` and the ``buckets=`` /
``cache_dtype=`` repair of ``PagedBatcher``, ``DraftLanes`` and
``SpecDecoder``, against the reference on the fp32 llama3 smoke model:

  * ``ContinuousBatcher`` (slots by ``max_batch``, ``bucket_chunks``
    prefill through ``prefill_slot``, one batched decode step a tick over
    the ``[B]`` cache index) gives the reference's tokens and ``stats()``
    with fp and int8 weights; with W4A16 weights the port's own sequential
    reference's (the reference's W4A16 dense arm fails on this tree);
  * ``tests/test_scheduler_fuzz.py``'s ``dense`` and ``paged`` schedules
    (its workload, ``buckets=(32, 64)``, fp32 pools, the six arms) replayed
    on the port give the reference's tokens and ``stats()``, the pool's
    ``memory_tokens()`` / ``utilization()`` equal to the reference's after
    every step;
  * ``SpecDecoder(buckets=, cache_dtype=)`` gives the reference's tokens
    and ``stats()``;
  * the dense batcher's tracer counters reconcile with ``stats()``, and its
    submit guard, zero-budget and ``max_len`` stops and refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.serving.scheduler import ContinuousBatcher as RefContinuousBatcher
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro.serving.spec import SpecDecoder as RefSpecDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.quant import quantize_params
from repro_torch.serving.scheduler import (ContinuousBatcher, PagedBatcher,
                                           Request, bucket_chunks)
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.serving.telemetry import FakeClock
from repro_torch.serving.trace import Tracer, counter_reconciliation

LEN_PALETTE = (4, 9, 20, 32, 33, 48, 57, 64)
BS = 16
MAX_LEN = max(LEN_PALETTE) + 8 + 1
FP32 = dict(param_dtype="float32", compute_dtype="float32")


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
    """The fuzz test's independent draft: the smollm smoke model in fp32
    (its parameters made by the reference, bridged to the port)."""
    ref_cfg = ref_get_smoke_config("smollm-135m").with_(**FP32)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(8))
    cfg = get_smoke_config("smollm-135m").with_(**FP32)
    return (ref_cfg, ref_params, cfg,
            params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                              "cpu"))


def _workload(vocab, seed, n=5):
    """tests/test_scheduler_fuzz.py's workload: palette lengths, budgets
    1..7, a random arrival order."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(LEN_PALETTE, size=n)
    prompts = [rng.integers(0, vocab, s).astype(np.int32) for s in lens]
    budgets = [int(b) for b in rng.integers(1, 8, size=n)]
    order = list(rng.permutation(n))
    return prompts, budgets, order


def _run(batcher, make, prompts, budgets, order):
    reqs = [make(rid=int(i), prompt=prompts[i], max_new_tokens=budgets[i])
            for i in order]
    batcher.run(reqs)
    assert all(r.done for r in reqs) and not batcher.busy
    return {r.rid: r.output for r in reqs}, batcher.stats()


# ------------------------------------------------------------ dense batcher --

@pytest.mark.parametrize("quant", ["int8"])
def test_dense_tokens_and_stats_equal_reference(smoke_model, port_params,
                                                quant):
    """int8 weights (fp weights: the ``dense`` arm of
    test_fuzz_schedules_equal_reference, on the same workload)."""
    ref_cfg, _, ref_params = smoke_model
    cfg, params = port_params
    prompts, budgets, order = _workload(cfg.vocab_size, 1)
    want = _run(RefContinuousBatcher(ref_cfg, ref_params, max_batch=3,
                                     max_len=MAX_LEN, buckets=(32, 64),
                                     weight_quant=quant),
                RefRequest, prompts, budgets, order)
    got = _run(ContinuousBatcher(cfg, params, max_batch=3, max_len=MAX_LEN,
                                 buckets=(32, 64), weight_quant=quant,
                                 device="cpu"),
               Request, prompts, budgets, order)
    assert got == want


def _sequential(cfg, params, prompt, n, buckets=(32, 64)):
    """The port's sequential reference: one request alone in a one-slot
    dense cache (the model's default dtype), prefilled by bucket chunks,
    then greedy decode steps."""
    model = build_model(cfg)
    cache = model.init_cache(batch=1, max_len=MAX_LEN, device="cpu")
    cache["index"] = torch.zeros((1,), dtype=torch.int32)
    idx = 0
    for c in bucket_chunks(len(prompt), buckets):
        logits, cache = model.prefill_slot(
            params, cache, torch.as_tensor(prompt[idx: idx + c]).long(), 0,
            idx)
        idx += c
    cache["index"][0] = len(prompt)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[out[-1]]]), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.mark.parametrize("quant", [None, "w4a16"])
def test_dense_equals_port_sequential_reference(port_params, quant):
    """W4A16 dense is held to the port's sequential reference (and so is
    fp, which the reference's test also gives)."""
    cfg, params = port_params
    prompts, budgets, order = _workload(cfg.vocab_size, 0)
    got, stats = _run(ContinuousBatcher(cfg, params, max_batch=3,
                                        max_len=MAX_LEN, buckets=(32, 64),
                                        weight_quant=quant, device="cpu"),
                      Request, prompts, budgets, order)
    qparams = quantize_params(params, cfg, quant) if quant else params
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        assert got[i] == _sequential(cfg, qparams, p, m), i
    assert stats["decode_steps"] == sum(budgets) - len(budgets)


def test_dense_tracer_and_guards(port_params):
    cfg, params = port_params
    tracer = Tracer(FakeClock(), cost_model=lambda k, p: 1e-5)
    cb = ContinuousBatcher(cfg, params, max_batch=2, max_len=40,
                           buckets=(32, 64), tracer=tracer, device="cpu")
    assert cb.cache["k"].dtype == torch.bfloat16     # the model's default
    assert cb.cache["index"].shape == (2,)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=0, prompt=rng.integers(0, 256, 35), max_new_tokens=9),
            Request(rid=1, prompt=rng.integers(0, 256, 5), max_new_tokens=1),
            Request(rid=2, prompt=rng.integers(0, 256, 7), max_new_tokens=3)]
    cb.submit(reqs[0])
    with pytest.raises(ValueError, match="duplicate"):
        cb.submit(Request(rid=0, prompt=np.ones(3, np.int32)))
    with pytest.raises(ValueError, match="empty prompt"):
        cb.submit(Request(rid=5, prompt=np.zeros((0,), np.int32)))
    assert cb.busy
    cb.run(reqs[1:])
    assert not cb.busy and all(r.done for r in reqs)
    assert len(reqs[1].output) == 1            # satisfied at prefill
    assert len(reqs[2].output) == 3
    assert len(reqs[0].output) == 40 - 1 - 35 + 1   # stopped by max_len
    s = cb.stats()
    assert counter_reconciliation(tracer, s) == {}
    kinds = [e["name"] for e in tracer.events if e["ph"] == "B"]
    assert kinds.count("prefill_chunk") == s["prefill_dispatches"] == 4
    assert kinds.count("decode_step") == s["decode_dispatches"]
    assert s["total_dispatches"] == s["decode_dispatches"] + 4
    with pytest.raises(ValueError, match="weight_quant"):
        ContinuousBatcher(cfg, params, weight_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        ContinuousBatcher(get_smoke_config("zamba2-2.7b"), device="cpu")


# ------------------------------------------- the fuzz schedules, replayed --

def _arms(ref: bool, cfg, params, draft):
    """tests/test_scheduler_fuzz.py's six arms in either package."""
    nb = 1 + 5 * -(-MAX_LEN // BS)
    if ref:
        pool = dict(num_blocks=nb, block_size=BS,
                    max_blocks_per_seq=-(-MAX_LEN // BS), decode_width=3,
                    buckets=(32, 64), cache_dtype=jnp.float32)
        dense = lambda: RefContinuousBatcher(cfg, params, max_batch=3,
                                             max_len=MAX_LEN,
                                             buckets=(32, 64))
        paged, spec = RefPagedBatcher, RefSpecConfig
    else:
        pool = dict(num_blocks=nb, block_size=BS,
                    max_blocks_per_seq=-(-MAX_LEN // BS), decode_width=3,
                    buckets=(32, 64), cache_dtype=torch.float32,
                    device="cpu")
        dense = lambda: ContinuousBatcher(cfg, params, max_batch=3,
                                          max_len=MAX_LEN, buckets=(32, 64),
                                          device="cpu")
        paged, spec = PagedBatcher, SpecConfig
    draft_cfg, draft_params = draft
    return {
        "dense": dense,
        "paged_host": lambda: paged(cfg, params, sync="host", **pool),
        "paged_device": lambda: paged(cfg, params, sync="device", window=3,
                                      **pool),
        "mixed": lambda: paged(cfg, params, sync="device", window=3,
                               mixed_batch=True, **pool),
        "spec_indep": lambda: paged(cfg, params, sync="host",
                                    spec=spec(k=3, draft=draft_cfg),
                                    spec_draft_params=draft_params, **pool),
        "spec_self_device": lambda: paged(cfg, params, sync="device",
                                          spec=spec(k=2), **pool),
    }


@pytest.mark.parametrize("arm", ["dense", "paged_device", "spec_indep"])
def test_fuzz_schedules_equal_reference(smoke_model, port_params, drafts,
                                        arm):
    """Each arm steps in lockstep with the reference's on the fuzz
    workload (seed 0): the same tokens, the same stats(), and after every
    step the same pool utilization. (The host-synced, mixed and
    self-drafted arms run at the same buckets and fp32 pools behind the
    ingress in tests/test_torch_ingress.py, held to the reference's
    streams and stats() there.)"""
    ref_cfg, _, ref_params = smoke_model
    cfg, params = port_params
    prompts, budgets, order = _workload(cfg.vocab_size, 0)
    want_b = _arms(True, ref_cfg, ref_params, drafts[:2])[arm]()
    got_b = _arms(False, cfg, params, drafts[2:])[arm]()
    reqs = {}
    for b, make in ((want_b, RefRequest), (got_b, Request)):
        reqs[b] = [make(rid=int(i), prompt=prompts[i],
                        max_new_tokens=budgets[i]) for i in order]
        for r in reqs[b]:
            b.submit(r)
    paged = arm != "dense"
    if paged:
        assert got_b.kv.memory_tokens() == want_b.kv.memory_tokens() \
            == got_b.kv.num_blocks * BS
        assert got_b.buckets == (32, 64) and \
            got_b.kv.pool["k"].dtype == torch.float32
        if got_b.drafts is not None:
            assert got_b.drafts.buckets == (32, 64)
            assert got_b.drafts.cache["k"].dtype == torch.float32
    for step in range(200):
        if not want_b.busy:
            break
        want_b.step()
        got_b.step()
        assert got_b.busy == want_b.busy, step
        if paged:
            assert got_b.kv.utilization() == want_b.kv.utilization(), step
    assert not got_b.busy
    assert [r.output for r in reqs[got_b]] == [r.output for r in
                                               reqs[want_b]]
    assert got_b.stats() == {k: v for k, v in want_b.stats().items()
                             if k != "tp"}
    if paged:
        got_b.kv.assert_drained()
        assert got_b.kv.utilization() == 0.0


@pytest.mark.parametrize("sync", ["device"])
def test_spec_decoder_buckets_and_cache_dtype_equal_reference(
        smoke_model, port_params, sync):
    ref_cfg, _, ref_params = smoke_model
    cfg, params = port_params
    prompt = np.random.default_rng(9).integers(0, 256, 45).astype(np.int32)
    ref = RefSpecDecoder(ref_cfg, ref_params, spec=RefSpecConfig(k=3),
                         max_len=96, buckets=(32, 64),
                         cache_dtype=jnp.float32, sync=sync)
    dec = SpecDecoder(cfg, params, spec=SpecConfig(k=3), max_len=96,
                      buckets=(32, 64), cache_dtype=torch.float32, sync=sync,
                      device="cpu")
    assert dec.kv.pool["k"].dtype == dec.drafts.cache["k"].dtype \
        == torch.float32
    assert dec.drafts.buckets == (32, 64)
    assert dec.generate(prompt, 9) == ref.generate(prompt, 9)
    assert dec.stats() == ref.stats()
    assert dec.stats()["prefill_dispatches"] == 2      # chunks 32 + 13
