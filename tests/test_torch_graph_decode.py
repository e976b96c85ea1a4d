"""The staging around the port's captured decode loops, on the CPU, where
the entry points run the loops' bodies eagerly through the same code that
feeds the CUDA graphs on the card: the engine's per-shape cache reused
across requests (against a fresh engine and the reference's two decode
loops, on the fp32 llama3 and zamba2 smoke models with the reference's
parameters), the batcher's window and tick staging (lanes finishing
mid-window by budget and by EOS, against a sequential reference, with the
reference's dispatch arithmetic), the graph keys, and the launch
accounting of ``CapturedLoop`` through a fake graph."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.sync import generate_host_loop as ref_generate_host_loop
from repro.core.sync import generate_on_device as ref_generate_on_device
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.sync import (CapturedLoop, loop_stats, make_loop,
                                   paged_decode_window_eager,
                                   paged_window_loop)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.hetero_matmul.ops import mxu_matmul
from repro_torch.models import build_model
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import PagedBatcher, Request

ARCHS = ("llama3-8b", "zamba2-2.7b")
PROMPT_LEN, NEW_TOKENS = 40, 6
# the same fp32 computation on the same cache, reused or fresh
LOGITS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(cfg):
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = _fp32(ref_configs.get_smoke_config(arch))
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = _fp32(get_smoke_config(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_model, ref_params, cfg, params


def _prompt(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (1, PROMPT_LEN)).astype(np.int32)


def _recording_engine(cfg, params, fast: bool):
    """An engine whose prefill and decode steps append their last-position
    logits to ``eng.seen`` (the loops are made at the first generate, so
    they call the recording step)."""
    eng = InferenceEngine(cfg, params, mode="xla",
                          prefill_strategy="online-prepare", fast_sync=fast,
                          device="cpu")
    eng.seen = []
    prefill, decode = eng._prefill, eng.model.decode_step

    def keep(fn):
        def run(*a, **k):
            logits, cache = fn(*a, **k)
            eng.seen.append(logits[:, -1].clone())
            return logits, cache
        return run

    eng._prefill = keep(prefill)
    eng.model = dataclasses.replace(eng.model, decode_step=keep(decode))
    return eng


def _reference_tokens(ref_model, ref_params, prompt, fast: bool) -> list:
    cache = ref_model.init_cache(batch=1, max_len=PROMPT_LEN + NEW_TOKENS,
                                 dtype=jnp.float32)
    logits, cache = ref_model.prefill(ref_params, jnp.asarray(prompt), cache)
    first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    loop = ref_generate_on_device if fast else ref_generate_host_loop
    toks, _ = loop(ref_model, ref_params, first, cache, NEW_TOKENS - 1)
    return [int(first[0, 0])] + np.asarray(toks)[0].tolist()


# ------------------------------------------------------ engine cache reuse --

@pytest.mark.parametrize("fast", [True, False], ids=["fast", "host"])
def test_engine_reuses_its_cache_across_requests(pair, fast):
    """Two requests of one shape on one engine prefill into the same cache
    and run the same decode loop; each gives a fresh engine's logits
    (within 1e-5) and tokens, and the reference's decode loop's tokens
    (for zamba2 the reused cache's conv and SSM state is reset by the
    prefill from position 0)."""
    ref_model, ref_params, cfg, params = pair
    eng = _recording_engine(cfg, params, fast)
    for seed in (3, 5):
        prompt = _prompt(seed)
        start = len(eng.seen)
        got = eng.generate(prompt, NEW_TOKENS)[0].tolist()
        fresh = _recording_engine(cfg, params, fast)
        assert fresh.generate(prompt, NEW_TOKENS)[0].tolist() == got
        mine = eng.seen[start:]
        assert len(mine) == len(fresh.seen) == NEW_TOKENS
        for a, b in zip(mine, fresh.seen):
            assert float((a - b).abs().max()) <= LOGITS_TOL
        assert got == _reference_tokens(ref_model, ref_params, prompt, fast)
    assert len(eng._caches) == 1 and len(eng._loops) == 1
    none = {"graphs": 0, "replays": 0, "pool_bytes": 0}
    assert eng.graph_stats() == {**none, "calls": none}


def test_hybrid_prefill_from_zero_resets_the_recurrent_state(pair):
    """A Mamba2 prefill at position 0 into a cache that holds another
    request's conv and SSM state gives the logits and state of a fresh
    cache; the dense model has no recurrent state and is unaffected."""
    _, _, cfg, params = pair
    model = build_model(cfg)
    a, b = (torch.from_numpy(_prompt(s)).long() for s in (3, 5))
    used = model.init_cache(batch=1, max_len=PROMPT_LEN + 4,
                            dtype=torch.float32, device="cpu")
    _, used = model.prefill(params, a, used)
    token = torch.zeros((1, 1), dtype=torch.long)
    _, used = model.decode_step(params, token, used)
    fresh = model.init_cache(batch=1, max_len=PROMPT_LEN + 4,
                             dtype=torch.float32, device="cpu")
    want, fresh = model.prefill(params, b, fresh)
    got, used = model.prefill(params, b, used)
    assert torch.equal(got, want)
    for name in ("conv", "ssm") if cfg.ssm is not None else ():
        assert torch.equal(used[name], fresh[name]), name


# ---------------------------------------------------------- window staging --

def _sequential(cfg, params, prompt, n: int, eos_id=None) -> list:
    """The port's sequential reference: one request through the dense
    cache, greedy, ``n`` tokens or up to and including ``eos_id``."""
    model = build_model(cfg)
    cache = model.init_cache(batch=1, max_len=len(prompt) + n,
                             dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(params, torch.from_numpy(prompt)[None]
                                  .long(), cache)
    out = [int(torch.argmax(logits[0, -1]))]
    while len(out) < n and out[-1] != eos_id:
        logits, cache = model.decode_step(params, torch.tensor([[out[-1]]]),
                                          cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.fixture(scope="module")
def llama():
    cfg = _fp32(get_smoke_config("llama3-8b"))
    return cfg, build_model(cfg).init(
        torch.Generator().manual_seed(7), device="cpu")


PROMPT_LENS, BUDGETS = (37, 75, 20, 9), (5, 9, 3, 7)


def _batch(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
            for s in PROMPT_LENS]


@pytest.mark.parametrize("with_eos", [False, True], ids=["budget", "eos"])
@pytest.mark.parametrize("sync", ["host", "device"])
def test_window_staging_matches_sequential_reference(llama, sync, with_eos):
    """Lanes that finish mid-window by budget (5 / 9 / 3 / 7 tokens, window
    4) or by EOS (request 1's fourth token) give the sequential
    reference's tokens over several windows; decode dispatches are
    ceil(steps / window) under sync device and one per step under sync
    host, as the reference's tests/test_fused_decode.py requires."""
    cfg, params = llama
    prompts = _batch(cfg)
    eos = _sequential(cfg, params, prompts[1], 9)[3] if with_eos else None
    want = [_sequential(cfg, params, p, m, eos)
            for p, m in zip(prompts, BUDGETS)]
    pb = PagedBatcher(cfg, params, num_blocks=1 + 4 * 3, block_size=32,
                      max_blocks_per_seq=3, decode_width=4, sync=sync,
                      window=4, eos_id=eos, device="cpu")
    reqs = pb.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, BUDGETS))])
    assert [r.output for r in reqs] == want
    assert all(r.done for r in reqs)
    pb.kv.assert_drained()
    steps = max(len(w) for w in want) - 1
    assert pb.decode_steps == sum(len(w) - 1 for w in want)
    assert pb.decode_dispatches == (-(-steps // 4) if sync == "device"
                                    else steps)
    assert list(pb._loops) == [pb.loop_key("window" if sync == "device"
                                           else "tick")]


def test_window_loop_marks_what_a_lane_did_not_emit(llama):
    """The window body reads back one tensor: each lane's tokens, -1 where
    the lane emitted nothing (budget spent, EOS, or inactive), equal to the
    plain window's tokens where its valid mask is set."""
    cfg, params = llama
    model = build_model(cfg)
    pool = model.init_paged_cache(num_blocks=5, block_size=32,
                                  dtype=torch.float32, device="cpu")
    tables = torch.tensor([[1, 2], [3, 4], [0, 0]])
    lengths = torch.tensor([5, 9, 0])
    remaining = torch.tensor([4, 2, 0])
    last = torch.tensor([[7], [11], [0]])
    loop = paged_window_loop(model, params, pool, 3, 2, 4)
    got = loop(last, tables, lengths, remaining)
    pool2 = model.init_paged_cache(num_blocks=5, block_size=32,
                                   dtype=torch.float32, device="cpu")
    toks, valid, _, _, _ = paged_decode_window_eager(
        model, params, last, pool2, tables, lengths, remaining, 4)
    assert torch.equal(got, torch.where(valid, toks, -1))
    assert valid.sum(dim=1).tolist() == [4, 2, 0]
    assert (got[2] == -1).all() and (got[1, 2:] == -1).all()


# -------------------------------------------------------------- graph keys --

def _batcher(cfg, params, **kw):
    args = dict(num_blocks=9, block_size=32, max_blocks_per_seq=4,
                decode_width=4, sync="device", window=4, device="cpu")
    return PagedBatcher(cfg, params, **{**args, **kw})


def test_batcher_graph_keys_are_per_instance_and_shape_complete(llama):
    cfg, params = llama
    base = _batcher(cfg, params)
    variants = [dict(decode_width=2), dict(window=8),
                dict(max_blocks_per_seq=3),
                dict(sampler=SamplerConfig(temperature=1.0, top_k=8)),
                dict(eos_id=3), dict(kv_quant="int8"),
                dict(weight_quant="int8"), dict(weight_quant="w4a16")]
    keys = [base.loop_key("window")]
    keys += [_batcher(cfg, params, **v).loop_key("window") for v in variants]
    assert len(set(keys)) == len(keys)
    ticks = {_batcher(cfg, params, **v).loop_key("tick")
             for v in (dict(decode_width=2), dict(max_blocks_per_seq=3),
                       dict(kv_quant="int8"), dict(weight_quant="w4a16"), {})}
    assert len(ticks) == 5
    assert base.loop_key("tick") != base.loop_key("window")
    # two batchers of one key never share an entry
    other = _batcher(cfg, params)
    prompt = np.arange(10, dtype=np.int32)
    for pb in (base, other):
        pb.run([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    assert base.loop_key("window") == other.loop_key("window")
    assert base._loops is not other._loops
    assert base._loops[base.loop_key("window")] is not \
        other._loops[other.loop_key("window")]


def test_engine_graph_keys_are_per_instance_and_shape_complete(llama):
    cfg, params = llama
    fast, host = (InferenceEngine(cfg, params, mode="xla", fast_sync=f,
                                  device="cpu") for f in (True, False))
    keys = {fast.loop_key(1, 48, 5), fast.loop_key(2, 48, 5),
            fast.loop_key(1, 64, 5), fast.loop_key(1, 48, 7),
            host.loop_key(1, 48, 5), host.loop_key(1, 64, 5)}
    assert len(keys) == 6
    assert host.loop_key(1, 48, 5) == host.loop_key(1, 48, 7)  # one step
    other = InferenceEngine(cfg, params, mode="xla", device="cpu")
    prompt = np.arange(20).reshape(1, 20)
    for eng in (fast, other):
        eng.generate(prompt, 4)
    key = fast.loop_key(1, 24, 3)
    assert fast._loops is not other._loops
    assert fast._loops[key] is not other._loops[key]
    assert fast._caches[(1, 24, torch.float32)]["k"].data_ptr() != \
        other._caches[(1, 24, torch.float32)]["k"].data_ptr()


# -------------------------------------------------------- launch accounting --

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeLoop(CapturedLoop):
    """CapturedLoop with the CUDA parts replaced: the warm-up and the
    capture run the body on the CPU; a replay runs nothing (no Python)."""

    def _warm_up(self, body):
        body(*self.inputs)

    def _record(self, body, generator):
        return body(*self.inputs), _FakeGraph(), 0


def test_replays_add_the_launches_the_capture_recorded(monkeypatch):
    """After a capture that recorded k launches of a wrapper, r replays add
    r * k to its counter; the warm-up's launches ran and stay counted, the
    capture's did not run and are taken off."""
    monkeypatch.setattr(decode_attention, "launches", 100)
    monkeypatch.setattr(mxu_matmul, "launches", 7)

    def body(x):
        decode_attention.launches += 3     # what a wrapper does at launch
        mxu_matmul.launches += 1
        return x * 2

    loop = _FakeLoop(body, (torch.zeros(2),))
    assert loop.launches == {decode_attention: 3, mxu_matmul: 1}
    assert (decode_attention.launches, mxu_matmul.launches) == (103, 8)
    for r in range(1, 6):
        out = loop(torch.full((2,), float(r)))
        assert torch.equal(loop.inputs[0], torch.full((2,), float(r)))
        assert (decode_attention.launches, mxu_matmul.launches) == \
            (103 + 3 * r, 8 + r)
    assert out is loop.outputs and loop.graph.replays == 5
    assert loop_stats([loop, body]) == {"graphs": 1, "replays": 5,
                                        "pool_bytes": 0}


def test_make_loop_is_the_body_itself_on_the_cpu():
    def body(x):
        return x + 1

    assert make_loop(body, (torch.zeros(1),)) is body
