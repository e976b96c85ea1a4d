"""The dense batcher's and the draft lanes' captured calls on the CPU, where
``core/sync.py::make_call`` returns the body itself, so the staging that
feeds the CUDA graphs on the card runs eagerly against the JAX package at
smoke size (fp32, the reference's parameters):

  * ``transformer.prefill_slot`` at a 0-dim slot and start (the captured
    form: gather the slot, prefill at a device start, write it back) is
    bitwise the host-int call at slots 0, mid and B - 1 and starts 0, mid
    and ``Smax - C`` (a chunk of 6, and a 1-token tail), and leaves every
    other slot's rows as they were;
  * ``ContinuousBatcher`` with fp and int8 weights gives the reference's
    tokens and ``stats()``, with as many calls of each kind as the
    reference's ``_prefill_piece`` and ``_decode`` compiled; W4A16 gives
    the port's sequential reference's tokens (the reference's dense W4A16
    arm fails on this tree);
  * ``DraftLanes`` under host and device sync, inside ``PagedBatcher(spec=)``
    and ``SpecDecoder``: the reference's tokens and draft dispatches, its
    calls equal to the reference's jit-cache counts;
  * through a stand-in ``CapturedCall`` whose replay reruns the body on its
    static buffers: one call per chunk length serves every slot and start,
    one decode call and one draft step serve every tick and round, tokens
    equal to the eager run's, replays and launches counted."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.serving.scheduler import ContinuousBatcher as RefContinuousBatcher
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro.serving.spec import SpecDecoder as RefSpecDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.sync import CapturedCall
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import build_model
from repro_torch.models.quant import quantize_params
from repro_torch.serving import scheduler, spec
from repro_torch.serving.scheduler import (ContinuousBatcher, PagedBatcher,
                                           Request, bucket_chunks)
from repro_torch.serving.spec import SpecConfig, SpecDecoder

FP32 = dict(param_dtype="float32", compute_dtype="float32")
BUCKETS = (8, 16)
# chunks [5], [16, 16, 8], [16, 5], [16, 16, 1], [16]: lengths 16 and 5 at
# other slots and starts, and a 1-token tail
PROMPT_LENS = (5, 40, 21, 33, 16)
BUDGETS = (4, 6, 3, 5, 2)
MAX_LEN = 48
K = 3
POOL = dict(num_blocks=1 + 3 * 4, block_size=16, max_blocks_per_seq=4,
            decode_width=2, buckets=BUCKETS)


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
def llama(smoke_model):
    ref_cfg, _, ref_params = smoke_model
    cfg = get_smoke_config("llama3-8b").with_(**FP32)
    return ref_cfg, ref_params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


def _prompts(vocab: int = 256):
    rng = np.random.default_rng(31)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _run(batcher, make, prompts=None):
    prompts = _prompts() if prompts is None else prompts
    reqs = [make(rid=i, prompt=p, max_new_tokens=BUDGETS[i % len(BUDGETS)])
            for i, p in enumerate(prompts)]
    batcher.run(reqs)
    assert all(r.done for r in reqs) and not batcher.busy
    return [r.output for r in reqs]


# ---------------------------------------------------------- prefill_slot --

@pytest.mark.parametrize("chunk", [6, 1])
@pytest.mark.parametrize("start", ["zero", "mid", "end"])
@pytest.mark.parametrize("slot", ["first", "mid", "last"])
def test_prefill_slot_at_device_slot_and_start_is_the_host_call(
        llama, slot, start, chunk):
    """Logits and the whole cache bitwise the host-int call's; every other
    slot's rows bitwise as before (a cache of 3 slots x 40 rows of random
    K/V, so the prefix the chunk attends over is not zeros)."""
    _, _, cfg, params = llama
    model = build_model(cfg)
    B, Smax = 3, 40
    b = {"first": 0, "mid": 1, "last": B - 1}[slot]
    at = {"zero": 0, "mid": 17, "end": Smax - chunk}[start]
    g = np.random.default_rng(b * 100 + at + chunk)
    cache = model.init_cache(batch=B, max_len=Smax, dtype=torch.float32,
                             device="cpu")
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(
            g.standard_normal(cache[name].shape).astype(np.float32)))
    before = {name: cache[name].clone() for name in ("k", "v")}
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, chunk))
    host = {name: t.clone() for name, t in cache.items()}
    want, _ = model.prefill_slot(params, host, tokens, b, at)
    dev = {name: t.clone() for name, t in cache.items()}
    got, out = model.prefill_slot(params, dev, tokens, torch.tensor(b),
                                  torch.tensor(at))
    assert out is dev
    assert torch.equal(got, want)
    others = [s for s in range(B) if s != b]
    for name in ("k", "v"):
        assert torch.equal(dev[name], host[name])
        assert torch.equal(dev[name][:, others], before[name][:, others])
        assert not torch.equal(dev[name][:, b], before[name][:, b])


# --------------------------------------------------------- dense batcher --

@pytest.mark.parametrize("quant", [None, "int8"])
def test_dense_batcher_calls_match_reference(llama, quant):
    """Tokens and ``stats()`` equal to the reference batcher's, and one
    call per chunk length and one decode call: as many as the reference's
    ``_prefill_piece`` and ``_decode`` compiled. The host's positions are
    what the decode step left on the device."""
    ref_cfg, ref_params, cfg, params = llama
    ref = RefContinuousBatcher(ref_cfg, ref_params, max_batch=2,
                               max_len=MAX_LEN, buckets=BUCKETS,
                               weight_quant=quant)
    want = _run(ref, RefRequest)
    cb = ContinuousBatcher(cfg, params, max_batch=2, max_len=MAX_LEN,
                           buckets=BUCKETS, weight_quant=quant, device="cpu")
    assert _run(cb, Request) == want
    assert cb.stats() == ref.stats()
    prefill = {key for key in cb._calls if key[0] == "prefill"}
    assert prefill == {("prefill", c) for n in PROMPT_LENS
                       for c in bucket_chunks(n, BUCKETS)}
    assert len(prefill) == ref._prefill_piece._cache_size() == 4
    assert set(cb._calls) - prefill == {("decode",)}
    assert ref._decode._cache_size() == 1
    assert cb.index.tolist() == cb.cache["index"].tolist() \
        == np.asarray(ref.cache["index"]).tolist()
    none = {"graphs": 0, "replays": 0, "pool_bytes": 0}
    assert cb.graph_stats() == {**none, "calls": none}


def _sequential(cfg, params, prompt, n):
    """The port's sequential reference: one request alone in a one-slot
    dense cache (the model's default dtype), prefilled by bucket chunks at
    host ints, then greedy decode steps."""
    model = build_model(cfg)
    cache = model.init_cache(batch=1, max_len=MAX_LEN, device="cpu")
    cache["index"] = torch.zeros((1,), dtype=torch.int32)
    idx = 0
    for c in bucket_chunks(len(prompt), BUCKETS):
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


def test_dense_batcher_w4a16_equals_port_sequential(llama):
    _, _, cfg, params = llama
    cb = ContinuousBatcher(cfg, params, max_batch=2, max_len=MAX_LEN,
                           buckets=BUCKETS, weight_quant="w4a16",
                           device="cpu")
    got = _run(cb, Request)
    qparams = quantize_params(params, cfg, "w4a16")
    for i, p in enumerate(_prompts()):
        assert got[i] == _sequential(cfg, qparams, p, BUDGETS[i]), i
    assert len(cb._calls) == 5


# ----------------------------------------------------------- draft lanes --

def _draft_counts(drafts) -> dict:
    return {kind: sum(key[0] == kind for key in drafts.calls)
            for kind in ("prefill", "step")}


def _ref_draft_counts(drafts) -> dict:
    return {"prefill": drafts._prefill_piece._cache_size(),
            "step": drafts._step._cache_size()}


@pytest.mark.parametrize("sync", ["host", "device"])
def test_paged_draft_lanes_match_reference(llama, sync):
    """PagedBatcher(spec=3), self-draft: the reference's tokens and stats
    (draft dispatches included); the draft lanes' calls (one per chunk
    length, one step under host sync) and the accept call as many as the
    reference compiled."""
    ref_cfg, ref_params, cfg, params = llama
    ref = RefPagedBatcher(ref_cfg, ref_params, sync=sync,
                          spec=RefSpecConfig(k=K), **POOL)
    want = _run(ref, RefRequest)
    pb = PagedBatcher(cfg, params, sync=sync, spec=K, device="cpu", **POOL)
    assert _run(pb, Request) == want
    pb.kv.assert_drained()
    assert pb.stats() == ref.stats()
    assert _draft_counts(pb.drafts) == _ref_draft_counts(ref.drafts)
    assert _draft_counts(pb.drafts)["step"] == (sync == "host")
    accept = [key for key in pb._calls if key[0] == "accept"]
    assert len(accept) == ref._accept._cache_size() == 1


@pytest.mark.parametrize("sync", ["host", "device"])
def test_spec_decoder_draft_lanes_match_reference(llama, sync):
    """SpecDecoder, self-draft: tokens and every stat (draft dispatches
    included) equal to the reference's, the draft calls as many as its
    jit caches hold."""
    ref_cfg, ref_params, cfg, params = llama
    prompt = _prompts()[1]
    ref = RefSpecDecoder(ref_cfg, ref_params, spec=RefSpecConfig(k=K),
                         max_len=64, buckets=BUCKETS, sync=sync)
    want = ref.generate(prompt, 7)
    dec = SpecDecoder(cfg, params, spec=SpecConfig(k=K), max_len=64,
                      buckets=BUCKETS, sync=sync, device="cpu")
    assert dec.generate(prompt, 7) == want
    dec.kv.assert_drained()
    assert dec.stats() == ref.stats()
    assert _draft_counts(dec.drafts) == _ref_draft_counts(ref.drafts)
    assert ("accept", K + 1) in dec._calls


# ---------------------------------------------------- a stand-in for graphs --

def _flat(out):
    return out if isinstance(out, tuple) else (out,)


class _ReplayGraph:
    """A graph's stand-in: a replay reruns the body on the call's static
    inputs and writes its static outputs in place. The body's launches
    are put back: a replay runs no Python, and ``CapturedLoop`` adds what
    the capture recorded."""

    def __init__(self, body, inputs, outputs):
        self.body, self.inputs, self.outputs = body, inputs, outputs

    def replay(self):
        counts = launch_counts()
        out = self.body(*self.inputs)
        for w, n in counts.items():
            w.launches = n
        for static, new in zip(_flat(self.outputs), _flat(out), strict=True):
            static.copy_(new)


class _FakeCall(CapturedCall):
    """CapturedCall with the CUDA parts replaced: the warm-up and the
    capture run the body on the CPU (the capture's launches are taken off
    the counters), a replay is a ``_ReplayGraph``'s."""

    def _warm_up(self, body):
        return body(*self.inputs)

    def _record(self, body, generator):
        out = body(*self.inputs)
        return out, _ReplayGraph(body, self.inputs, out), 0


def _fake_calls(monkeypatch):
    def make(body, device, *, pool=None, capture=True):
        return _FakeCall(body, torch.device("cpu"), pool)

    for mod in (scheduler, spec):
        monkeypatch.setattr(mod, "make_call", make)


def _counting(fn, wrapper):
    """``fn`` adding one launch of ``wrapper`` a call, as a kernel's
    wrapper does where it launches on the card."""
    def run(*a, **k):
        wrapper.launches += 1
        return fn(*a, **k)
    return run


def test_dense_calls_replay_per_chunk_length(llama, monkeypatch):
    """One captured call per chunk length serves every slot and start and
    one decode call every tick: tokens equal to the eager batcher's, each
    call's replays its uses but the first, and a kernel launched in the
    bodies counted once a dispatch, replays included."""
    _, _, cfg, params = llama
    want = _run(ContinuousBatcher(cfg, params, max_batch=2, max_len=MAX_LEN,
                                  buckets=BUCKETS, device="cpu"), Request)
    _fake_calls(monkeypatch)
    for wrapper in (flash_attention, decode_attention):
        monkeypatch.setattr(wrapper, "launches", 0)
    cb = ContinuousBatcher(cfg, params, max_batch=2, max_len=MAX_LEN,
                           buckets=BUCKETS, device="cpu")
    cb.model = dataclasses.replace(
        cb.model,
        prefill_slot=_counting(cb.model.prefill_slot, flash_attention),
        decode_step=_counting(cb.model.decode_step, decode_attention))
    assert _run(cb, Request) == want
    s = cb.stats()
    chunks = [c for n in PROMPT_LENS for c in bucket_chunks(n, BUCKETS)]
    uses = {c: chunks.count(c) for c in set(chunks)}
    assert {key: call.replays for key, call in cb._calls.items()} == {
        **{("prefill", c): n - 1 for c, n in uses.items()},
        ("decode",): s["decode_dispatches"] - 1}
    assert flash_attention.launches == s["prefill_dispatches"] == len(chunks)
    assert decode_attention.launches == s["decode_dispatches"]
    g = cb.graph_stats()
    assert (g["graphs"], g["replays"]) == (1, s["decode_dispatches"] - 1)
    assert (g["calls"]["graphs"], g["calls"]["replays"]) == (
        len(uses), len(chunks) - len(uses))


def test_draft_step_replays_feed_each_other(llama, monkeypatch):
    """``sync='host'`` draft rounds through one captured step, each replay
    fed the last one's outputs: tokens and draft dispatches equal to the
    eager batcher's, the step replayed k + 1 times a round (but its first
    use), the draft prefill once per chunk; ``graph_stats()["calls"]``
    counts the draft lanes' calls."""
    _, _, cfg, params = llama
    eager = PagedBatcher(cfg, params, sync="host", spec=K, device="cpu",
                         **POOL)
    want = _run(eager, Request)
    _fake_calls(monkeypatch)
    pb = PagedBatcher(cfg, params, sync="host", spec=K, device="cpu", **POOL)
    assert _run(pb, Request) == want
    assert pb.stats() == eager.stats()
    rounds = pb.stats()["decode_dispatches"]
    step = pb.drafts.calls[("step",)]
    assert step.replays == (K + 1) * rounds - 1
    draft_chunks = pb.stats()["draft_dispatches"] - (K + 1) * rounds
    prefill = [c for key, c in pb.drafts.calls.items() if key[0] == "prefill"]
    assert sum(c.replays for c in prefill) == draft_chunks - len(prefill)
    calls = [*pb._calls.values(), *pb.drafts.calls.values()]
    assert pb.graph_stats()["calls"] == {
        "graphs": len(calls), "replays": sum(c.replays for c in calls),
        "pool_bytes": 0}
