"""The port's single-request engine against the reference's on the fp32
llama3 smoke model with the reference's own parameters (``smoke_model``,
PRNGKey 7), carried across by ``repro_torch.convert``: the dense-cache
``prefill``/``decode_step`` logits, ``InferenceEngine`` tokens for every
prefill strategy x engine mode x sync arm, the two decode loops, the
solver's predicted prefill latency, ``EngineStats`` under an injected
clock, and the CLI's engine path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.configs import get_config as ref_get_config
from repro.core.engine import InferenceEngine as RefEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import PREFILL_STRATEGIES, InferenceEngine, \
    build_plan
from repro_torch.core.sync import generate_host_loop_eager, \
    generate_on_device_eager
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving.telemetry import Clock, FakeClock, MonotonicClock

# two layers of fp32 sums taken in another order than XLA's
LOGITS_TOL = 1e-4
MODES = ("xla", "mxu", "hetero-layer", "hetero-tensor")
BUCKETS = (32, 64)
PROMPT_LEN, NEW_TOKENS = 77, 4


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
def pair(smoke_model):
    ref_cfg, ref_model, ref_params = smoke_model
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _prompt(n=PROMPT_LEN, seed=3, batch=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(
        np.int32)


# ------------------------------------------------- prefill and decode_step --

@pytest.mark.parametrize("chunks", [(77,), (64, 13), (76, 1)],
                         ids=["one", "bucket+ragged", "then-one-token"])
def test_prefill_and_decode_step_match_reference(pair, chunks):
    """Chunked prefill into the dense cache (a chunk over its prefix, and
    a 1-token chunk through the decode kernel's path), then three decode
    steps at the device index: logits within 1e-4 of the reference's."""
    _, ref_model, ref_params, _, model, params = pair
    ref_prefill, ref_decode = jax.jit(ref_model.prefill), \
        jax.jit(ref_model.decode_step)
    tokens = _prompt()
    rc = ref_model.init_cache(batch=1, max_len=96, dtype=jnp.float32)
    tc = model.init_cache(batch=1, max_len=96, dtype=torch.float32,
                          device="cpu")
    start = 0
    for n in chunks:
        piece = tokens[:, start:start + n]
        rl, rc = ref_prefill(ref_params, jnp.asarray(piece), rc,
                             start_index=start)
        tl, tc = model.prefill(params, torch.from_numpy(piece).long(), tc,
                               start_index=start)
        start += n
        assert tl.shape == (1, 1, 256)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    assert int(tc["index"]) == int(rc["index"]) == PROMPT_LEN
    for tok in (17, 200, 3):
        rl, rc = ref_decode(ref_params, jnp.asarray([[tok]], jnp.int32), rc)
        tl, tc = model.decode_step(params, torch.tensor([[tok]]), tc)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    assert tc["index"].dtype == torch.int32 and tc["index"].ndim == 0
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(rc["k"]),
                               atol=1e-5, rtol=1e-5)


def test_decode_step_refuses_per_slot_indices(pair):
    """Per-slot indices (speculative decoding's draft lanes) are served
    (tests/test_torch_spec.py), but only one per lane: indices for 3 lanes
    with tokens for 2 are refused."""
    model, params = pair[4:]
    cache = model.init_cache(batch=2, max_len=8, dtype=torch.float32,
                             device="cpu")
    cache["index"] = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-slot"):
        model.decode_step(params, torch.zeros((2, 1), dtype=torch.long),
                          cache)


# ------------------------------------------------------------ engine tokens --

@pytest.fixture(scope="module")
def ref_tokens(pair):
    """The reference engine's tokens per prefill strategy (xla mode, as
    tests/test_serving.py runs it), computed once each, on first use."""
    ref_cfg, _, ref_params = pair[:3]
    cache = {}

    def get(strategy):
        if strategy not in cache:
            eng = RefEngine(ref_cfg, ref_params, mode="xla",
                            prefill_strategy=strategy, buckets=BUCKETS,
                            max_len=256)
            cache[strategy] = np.asarray(eng.generate(
                jnp.asarray(_prompt()), max_new_tokens=NEW_TOKENS)).tolist()
        return cache[strategy]
    return get


@pytest.fixture(scope="module")
def plans(pair):
    cfg = pair[3]
    return {fast: build_plan(cfg, sync_mode="fast" if fast else "host")
            for fast in (True, False)}


@pytest.mark.parametrize("fast_sync", [True, False], ids=["fast", "host"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", PREFILL_STRATEGIES)
def test_engine_tokens_match_reference(pair, ref_tokens, plans, strategy,
                                       mode, fast_sync):
    cfg, _, params = pair[3:]
    table, plan = plans[fast_sync]
    eng = InferenceEngine(cfg, params, mode=mode, prefill_strategy=strategy,
                          fast_sync=fast_sync, table=table, plan=plan,
                          buckets=BUCKETS, device="cpu")
    before = (flash_attention.launches, decode_attention.launches)
    out = eng.generate(_prompt(), max_new_tokens=NEW_TOKENS)
    assert out.shape == (1, NEW_TOKENS) and out.device.type == "cpu"
    assert out.tolist() == ref_tokens(strategy)
    assert (flash_attention.launches, decode_attention.launches) == before


def test_engine_chunks_follow_the_reference(pair):
    """The four strategies' chunk lists at the smoke buckets and at
    llama3-8b's standard buckets (prompt 300: 256 then 44)."""
    ref_cfg, _, ref_params, cfg, _, params = pair
    for S in (77, 64, 1, 300):
        for strategy in PREFILL_STRATEGIES:
            for buckets in (BUCKETS, None):
                kw = {} if buckets is None else {"buckets": buckets}
                ref = RefEngine(ref_cfg, ref_params, mode="xla",
                                prefill_strategy=strategy, **kw)
                eng = InferenceEngine(cfg, params, mode="xla",
                                      prefill_strategy=strategy,
                                      device="cpu", **kw)
                assert eng._bucket_chunks(S) == ref._bucket_chunks(S)
    assert InferenceEngine(cfg, params, device="cpu")._bucket_chunks(300) \
        == [(256, 256), (44, 44)]


def test_on_device_loop_matches_host_loop(pair):
    """Fast and host sync give the same tokens from the same cache (B=2,
    as tests/test_core.py holds the reference's two loops)."""
    model, params = pair[4:]
    toks = torch.from_numpy(_prompt(16, seed=0, batch=2)).long()
    outs = []
    for gen in (generate_on_device_eager, generate_host_loop_eager):
        cache = model.init_cache(batch=2, max_len=40, dtype=torch.float32,
                                 device="cpu")
        _, cache = model.prefill(params, toks, cache)
        first = torch.zeros((2, 1), dtype=torch.long)
        out, cache = gen(model, params, first, cache, 8)
        assert out.shape == (2, 8) and int(cache["index"]) == 24
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------------- analytic latency --

@pytest.mark.parametrize("fast_sync", [True, False], ids=["fast", "host"])
def test_predicted_prefill_us_matches_reference(fast_sync):
    """The solver's predicted prefill matmul time at llama3-8b widths
    (params are not read: the prediction is the plan's)."""
    ref = RefEngine(ref_get_config("llama3-8b"), {}, fast_sync=fast_sync)
    eng = InferenceEngine(get_config("llama3-8b"), {}, fast_sync=fast_sync,
                          device="cpu")
    for S in (1, 44, 77, 256, 300, 1000):
        assert eng.predicted_prefill_us(S) == pytest.approx(
            ref.predicted_prefill_us(S), rel=1e-12)


# ------------------------------------------------------------- statistics --

class TickClock(FakeClock):
    """A FakeClock that moves one second each time it is read."""

    def now(self) -> float:
        t = super().now()
        self.advance(1.0)
        return t


def test_engine_stats_under_an_injected_clock(pair):
    cfg, _, params = pair[3:]
    clock = TickClock()
    eng = InferenceEngine(cfg, params, mode="xla", prefill_strategy="hetero",
                          buckets=BUCKETS, clock=clock, device="cpu")
    eng.generate(_prompt(), max_new_tokens=NEW_TOKENS)   # chunks 64, 13
    s = eng.stats
    # reads: t0 0 | chunk 64: 1, 2 | chunk 13: 3, 4 | end 5 | decode 6, 7
    assert (s.n_compiles, s.compile_s, s.prefill_s, s.decode_s) == \
        (2, 2.0, 5.0, 1.0)
    assert (s.prefill_tokens, s.decode_tokens) == (PROMPT_LEN, NEW_TOKENS)
    assert s.tokens_per_s() == {"prefill_tok_s": PROMPT_LEN / 5.0,
                                "decode_tok_s": NEW_TOKENS / 1.0}
    eng.generate(_prompt(), max_new_tokens=NEW_TOKENS)   # lengths seen
    assert (s.n_compiles, s.compile_s, s.prefill_s) == (2, 2.0, 8.0)
    assert isinstance(clock, Clock) and isinstance(MonotonicClock(), Clock)


# -------------------------------------------------------------------- CLI --

def test_cli_engine_path_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--mode", "hetero-tensor",
                "--strategy", "pipe", "--prompt-len", "40",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "mode=hetero-tensor strategy=pipe fast_sync=True out=(1, 3) " \
        "device=cpu" in out and "decode_tok_s" in out
    serve.main(["--smoke", "--device", "cpu", "--mode", "xla",
                "--no-fast-sync", "--prompt-len", "20", "--new-tokens", "2"])
    assert "fast_sync=False out=(1, 2)" in capsys.readouterr().out
    for argv in (["--engine-mode", "xla"], ["--sync", "device"],
                 ["--open-loop"], ["--batched", "--priority-mix", "0.5"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--device", "cpu", *argv])
