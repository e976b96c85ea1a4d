"""The port's captured prefill and verify calls on the CPU, where
``core/sync.py::make_call`` returns the body itself, so the staging that
feeds the CUDA graphs on the card runs eagerly against the JAX package at
smoke size (fp32, the reference's parameters): the device-start plain
attention bitwise against the int-start path (the plain versions and the
layer, starts 0, mid and ``Smax - S``, G > 1); the engine's chunks at a
device start, their lengths repeating at other starts, against the
reference ``InferenceEngine`` (every chunk's logits within the fp32
DTYPE_TOL, greedy tokens, ``n_compiles``) for the llama3, zamba2 and rwkv6
smoke models under the ``hetero`` and ``pipe`` strategies; the paged
batcher's prefill and verify calls and ``SpecDecoder``'s against the
reference's tokens and dispatch counts; and ``CapturedCall``'s first call,
replays and launch accounting through a fake graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DTYPE_TOL, rel_err
from repro import configs as ref_configs
from repro.core.engine import InferenceEngine as RefEngine
from repro.models.registry import build_model as ref_build_model
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro.serving.spec import SpecDecoder as RefSpecDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.sync import (CapturedCall, CapturedLoop, graph_pool,
                                   loop_stats, make_call)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_at_ref,
                                                     attention_ref)
from repro_torch.kernels.hetero_matmul.ops import mxu_matmul
from repro_torch.models import build_model
from repro_torch.models.layers import attention, rope_table
from repro_torch.serving.scheduler import PagedBatcher, Request
from repro_torch.serving.spec import SpecConfig, SpecDecoder

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ("llama3-8b", "zamba2-2.7b", "rwkv6-3b")
BUCKETS = (8, 16)
# hetero: 16 at 0 and 16, 8, ragged 5 / 16 at 0 and 16, ragged 5; pipe: 16
# at 0 and 16, 8, a padded 8-chunk tail at 40 / at 32, then one token
PROMPT_LENS = (45, 37)
NEW_TOKENS = 4
K = 3
POOL = dict(num_blocks=1 + 3 * 4, block_size=16, max_blocks_per_seq=4,
            decode_width=2, buckets=BUCKETS)
BATCH_PROMPT_LENS = (5, 40, 21)     # chunks [5], [16, 16, 8], [16, 5]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(
        np.int32)


# ------------------------------------------------ device-start attention --

CASES = [(1, 8, 40, 2, 2, 16), (2, 5, 37, 1, 4, 32), (1, 44, 130, 2, 3, 16),
         (1, 20, 200, 2, 2, 64)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_device_start_plain_attention_is_the_int_start_path(case):
    """``attention_at_ref`` over the whole cache at a start tensor equals
    ``attention_ref`` on the prefix ``[0, start + S)`` bitwise, at starts
    0, mid and ``Smax - S``; so does the wrapper's device-start entry on
    CPU tensors, and the int32 / int64 / [1] forms of the start."""
    B, S, Smax, Hkv, G, D = case
    g = np.random.default_rng(sum(case))
    q, k, v = (torch.from_numpy(g.standard_normal(shape).astype(np.float32))
               for shape in ((B, S, Hkv * G, D), (B, Smax, Hkv, D),
                             (B, Smax, Hkv, D)))
    for start in (0, (Smax - S) // 2, Smax - S):
        want = attention_ref(q, k[:, :start + S], v[:, :start + S])
        assert torch.equal(attention_at_ref(q, k, v, torch.tensor(start)),
                           want)
        for at in (torch.tensor(start, dtype=torch.int32),
                   torch.tensor([start])):
            assert torch.equal(flash_attention(q, k, v, start=at), want)


def test_device_start_entry_refuses_what_it_cannot_serve():
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="device start"):
        flash_attention(q, kv, kv, causal=False, start=torch.tensor(0))
    with pytest.raises(ValueError, match="device start"):
        flash_attention(q, kv, kv, start=torch.tensor([0, 1]))


@pytest.mark.parametrize("start", ["zero", "mid", "end"])
def test_layer_attention_device_start_is_the_int_start(start):
    """``layers.attention`` of a 6-token chunk (G = 2) into a cache of 24
    rows holding an earlier prefix: at a 0-dim start tensor the output and
    the whole cache are bitwise those of the int start."""
    cfg = get_smoke_config("llama3-8b").with_(**FP32)
    assert cfg.n_heads // cfg.n_kv_heads > 1
    S, Smax = 6, 24
    at = {"zero": 0, "mid": 9, "end": Smax - S}[start]
    g = np.random.default_rng(5)
    hd, d = cfg.head_dim, cfg.d_model
    p = {name: torch.from_numpy(
            g.standard_normal(shape).astype(np.float32) * 0.1)
         for name, shape in (("wq", (d, cfg.n_heads * hd)),
                             ("wk", (d, cfg.n_kv_heads * hd)),
                             ("wv", (d, cfg.n_kv_heads * hd)),
                             ("wo", (cfg.n_heads * hd, d)))}
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(hd), k_norm=torch.ones(hd))
    x = torch.from_numpy(g.standard_normal((1, S, d)).astype(np.float32))
    prefix = g.standard_normal((1, Smax, cfg.n_kv_heads, hd)).astype(
        np.float32)
    outs = []
    for start_index in (at, torch.tensor(at, dtype=torch.int32)):
        cache = {"k": torch.from_numpy(prefix.copy()),
                 "v": torch.from_numpy(prefix.copy() * 0.5)}
        o, cache = attention(
            p, x, cfg, positions=torch.arange(at, at + S), cache=cache,
            cache_index=start_index, freqs=rope_table(cfg, "cpu"))
        outs.append((o, cache))
    (o1, c1), (o2, c2) = outs
    assert torch.equal(o1, o2)
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])


# -------------------------------------------------------------- the engine --

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = ref_configs.get_smoke_config(arch).with_(**FP32)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(7))
    cfg = get_smoke_config(arch).with_(**FP32)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_params, cfg, params


def _recording_reference(ref_cfg, ref_params, strategy):
    """The reference engine with every chunk's logits kept in ``seen``."""
    ref = RefEngine(ref_cfg, ref_params, mode="xla",
                    prefill_strategy=strategy, buckets=BUCKETS)
    ref.seen = []
    jit_prefill = ref._jit_prefill

    def recording(c):
        fn, new = jit_prefill(c)

        def run(*a, **k):
            logits, cache = fn(*a, **k)
            ref.seen.append(np.asarray(logits))
            return logits, cache
        return run, new

    ref._jit_prefill = recording
    return ref


def _recording_port(cfg, params, strategy):
    """The port's engine with every chunk's logits kept in ``seen``."""
    eng = InferenceEngine(cfg, params, mode="xla", prefill_strategy=strategy,
                          buckets=BUCKETS, device="cpu")
    eng.seen = []
    chunk = eng.prefill_chunk

    def recording(*a):
        logits = chunk(*a)
        eng.seen.append(logits.numpy())
        return logits

    eng.prefill_chunk = recording
    return eng


@pytest.mark.parametrize("strategy", ["hetero", "pipe"])
def test_engine_device_start_chunks_match_reference(pair, strategy):
    """Two prompts on one engine, chunk lengths repeating at other starts
    (a graph's key on the card holds no start): every chunk's last-token
    logits within the fp32 DTYPE_TOL of the reference engine's, greedy
    tokens equal, ``n_compiles`` equal to the reference's jit-cache count.
    On the CPU the calls are the bodies (no graph); one call per key: the
    chunk length over each cache, and for the recurrent families whether
    the chunk starts the prompt."""
    ref_cfg, ref_params, cfg, params = pair
    ref = _recording_reference(ref_cfg, ref_params, strategy)
    eng = _recording_port(cfg, params, strategy)
    for seed, n in enumerate(PROMPT_LENS):
        prompt = _prompt(n, seed)
        want = np.asarray(ref.generate(jnp.asarray(prompt),
                                       NEW_TOKENS)).tolist()
        assert eng.generate(prompt, NEW_TOKENS).tolist() == want
    assert len(eng.seen) == len(ref.seen) > len(PROMPT_LENS)
    for got, ref_logits in zip(eng.seen, ref.seen):
        assert rel_err(got, ref_logits) <= DTYPE_TOL["float32"]
    assert eng.stats.n_compiles == ref.stats.n_compiles \
        == len({c for n in PROMPT_LENS for c, _ in eng._bucket_chunks(n)})
    recurrent = cfg.ssm is not None or cfg.rwkv is not None
    keys = set()
    for n in PROMPT_LENS:
        max_len = n + NEW_TOKENS + (min(BUCKETS) if strategy == "pipe" else 0)
        start = 0
        for c, take in eng._bucket_chunks(n):
            keys.add(eng.call_key(c, 1, max_len, start == 0))
            start += take
    assert set(eng._calls) == keys
    assert len(keys) > len(PROMPT_LENS) + recurrent
    none = {"graphs": 0, "replays": 0, "pool_bytes": 0}
    assert eng.graph_stats()["calls"] == none


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_recurrent_prefill_needs_fresh_with_a_device_start(arch):
    """A recurrent family's prefill at a device start must be told whether
    it starts the prompt (nothing reads the start on the host); an int
    start says so itself and a contradicting ``fresh`` is refused."""
    cfg = get_smoke_config(arch).with_(**FP32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(batch=1, max_len=16, dtype=torch.float32,
                             device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="fresh"):
        model.prefill(params, tokens, cache, start_index=torch.tensor(0))
    with pytest.raises(ValueError, match="fresh"):
        model.prefill(params, tokens, cache, start_index=4, fresh=True)


# ---------------------------------------------- the batcher and SpecDecoder --

def _batch_prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 256, n).astype(np.int32)
            for n in BATCH_PROMPT_LENS]


ARMS = {"window": dict(sync="device"),
        "mixed": dict(sync="device", mixed_batch=True),
        "spec": dict(sync="device", spec=K)}


@pytest.fixture(scope="module")
def llama(smoke_model):
    ref_cfg, _, ref_params = smoke_model
    cfg = get_smoke_config("llama3-8b").with_(**FP32)
    return ref_cfg, ref_params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_paged_batcher_calls_match_reference(llama, arm):
    """The batcher's standalone prefill chunks, verify rounds and their
    acceptance through their calls (one per chunk length, one verify and
    one accept per K + 1), the chunk length 16
    at starts 0 and 16: the reference batcher's tokens and dispatch
    counts."""
    ref_cfg, ref_params, cfg, params = llama
    kw = dict(ARMS[arm])
    ref_kw = dict(kw, spec=RefSpecConfig(k=K)) if arm == "spec" else kw
    ref = RefPagedBatcher(ref_cfg, ref_params, **POOL, **ref_kw)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_batch_prompts())]
    ref.run(ref_reqs)
    pb = PagedBatcher(cfg, params, engine_mode="hetero-tensor",
                      device="cpu", **POOL, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_batch_prompts())]
    pb.run(reqs)
    pb.kv.assert_drained()
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    stats, ref_stats = pb.stats(), ref.stats()
    for key in ("prefill_dispatches", "decode_dispatches", "fused_steps",
                "verify_dispatches"):
        assert stats.get(key) == ref_stats.get(key), key
    kinds = {key[0] for key in pb._calls}
    assert kinds == ({"prefill", "verify", "accept"} if arm == "spec" else
                     {"prefill"} if stats["prefill_dispatches"] else set())
    if arm != "mixed":
        lengths = {key[-1] for key in pb._calls if key[0] == "prefill"}
        assert lengths == {5, 16, 8}
    none = {"graphs": 0, "replays": 0, "pool_bytes": 0}
    assert pb.graph_stats()["calls"] == none


@pytest.mark.parametrize("sync", ["host", "device"])
def test_spec_decoder_calls_match_reference(llama, sync):
    """SpecDecoder's prefill chunks (16 at 0 and 16, then 8), verify
    rounds and their acceptance through its calls: the reference's tokens
    and stats."""
    ref_cfg, ref_params, cfg, params = llama
    prompt = _batch_prompts()[1]
    ref = RefSpecDecoder(ref_cfg, ref_params, spec=RefSpecConfig(k=K),
                         max_len=64, buckets=BUCKETS, sync=sync)
    want = ref.generate(prompt, NEW_TOKENS + 3)
    dec = SpecDecoder(cfg, params, spec=SpecConfig(k=K), max_len=64,
                      buckets=BUCKETS, engine_mode="hetero-tensor",
                      sync=sync, device="cpu")
    assert dec.generate(prompt, NEW_TOKENS + 3) == want
    dec.kv.assert_drained()
    stats, ref_stats = dec.stats(), ref.stats()
    skip = () if sync == "device" else ("draft_dispatches",)
    assert {k: v for k, v in stats.items() if k not in skip} == \
        {k: v for k, v in ref_stats.items() if k not in skip}
    assert set(dec._calls) == {("prefill", 16), ("prefill", 8),
                               ("verify", K + 1), ("accept", K + 1)}


# -------------------------------------------------------- the captured call --

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCall(CapturedCall):
    """CapturedCall with the CUDA parts replaced: the warm-up and the
    capture run the body on the CPU; a replay runs nothing (no Python)."""

    def _warm_up(self, body):
        return body(*self.inputs)

    def _record(self, body, generator):
        return body(*self.inputs), _FakeGraph(), 0


def test_captured_call_first_call_is_its_warm_up(monkeypatch):
    """The first call captures on its own inputs and returns the warm-up's
    outputs (its launches counted once: the capture's are taken off);
    later calls copy their inputs in and replay, each adding the capture's
    launches; the pool given is the capture's. Before its first call a
    call is no graph."""
    monkeypatch.setattr(mxu_matmul, "launches", 7)
    pool = object()

    def body(x, start):
        mxu_matmul.launches += 2            # what a wrapper does at launch
        return x * 2 + start

    call = _FakeCall(body, torch.device("cpu"), pool)
    assert loop_stats([call]) == {"graphs": 0, "replays": 0,
                                  "pool_bytes": 0}
    first = call(torch.ones(3), torch.tensor(5))
    assert torch.equal(first, torch.full((3,), 7.0))
    assert first is not call.outputs and call.pool is pool
    assert isinstance(call, CapturedLoop) and call.warm_outputs is None
    assert call.launches == {mxu_matmul: 2} and mxu_matmul.launches == 9
    for r in range(1, 4):
        out = call(torch.full((3,), float(r)), torch.tensor(r))
        assert out is call.outputs
        assert torch.equal(call.inputs[0], torch.full((3,), float(r)))
        assert int(call.inputs[1]) == r
        assert mxu_matmul.launches == 9 + 2 * r
    assert loop_stats([call, body]) == {"graphs": 1, "replays": 3,
                                        "pool_bytes": 0}


def test_make_call_is_the_body_itself_on_the_cpu():
    def body(x):
        return x + 1

    assert make_call(body, "cpu") is body
    assert make_call(body, torch.device("cpu"), capture=False) is body
    assert graph_pool("cpu") is None
