"""The port's RWKV-6 against the reference's on the fp32 rwkv6 smoke model
with the reference's own parameters (PRNGKey 7), carried across by
``repro_torch.convert``: ``wkv6_chunked`` against the reference's and
against the exact recurrence, ``prefill`` (one shot, in chunks, with a last
1-token chunk) and ``decode_step`` logits and states, ``InferenceEngine``
tokens for every prefill strategy x sync arm (``pipe`` against the
reference's ``pipe``: its zero-padded tail moves the state), the engine's
reused cache starting each request from zero states, and the registry,
weight bridge, batcher and CLI around them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro import configs as ref_configs
from repro.core.engine import InferenceEngine as RefEngine
from repro.models import rwkv6 as ref_rwkv6
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import PREFILL_STRATEGIES, InferenceEngine, \
    build_plan
from repro_torch.launch import serve
from repro_torch.models import build_model, rwkv6
from repro_torch.serving.scheduler import PagedBatcher

ARCH = "rwkv6-3b"
# two layers of fp32 sums taken in another order than XLA's
LOGITS_TOL = 1e-4
# the scan alone: the reference's own bound between its chunked scan and
# its recurrence (tests/test_attention.py), here relative to the largest
# value over 45 steps of unit-scale inputs
WKV_TOL = 1e-4
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


def _fp32(cfg):
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    ref_cfg = _fp32(ref_configs.get_smoke_config(ARCH))
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = _fp32(get_smoke_config(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _prompt(n=PROMPT_LEN, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(
        np.int32)


# -------------------------------------------------------------- the scan --

def _wkv_inputs(B=2, S=45, H=3, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    # log decays over the model's clipped range, some near -40, most small
    lw = -np.exp(rng.uniform(-6.0, 3.7, (B, S, H, hd))).astype(np.float32)
    lw = np.clip(lw, -40.0, -1e-5)
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    state = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, lw, u, state


@pytest.mark.parametrize("chunk", [16, 45, 64], ids=["padded", "one",
                                                     "longer"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_wkv6_chunked_matches_reference_and_recurrence(chunk, with_state):
    """45 steps in chunks of 16 (the last padded with state-neutral steps),
    in one chunk, and with a chunk longer than the sequence; from zero and
    from a carried state: y and the final state within 1e-4 of the
    reference's chunked scan and of the exact recurrence (the port's and
    the reference's)."""
    r, k, v, lw, u, state = _wkv_inputs()
    st = state if with_state else None
    ref_y, ref_s = ref_rwkv6.wkv6_chunked(
        *map(jnp.asarray, (r, k, v, lw, u)), chunk=chunk,
        state=None if st is None else jnp.asarray(st))
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    ts = None if st is None else torch.from_numpy(st)
    y, s = rwkv6.wkv6_chunked(*t, chunk=chunk, state=ts)
    ry, rs = rwkv6.wkv6_recurrent(*t, state=ts)
    oy, os_ = ref_rwkv6.wkv6_recurrent(
        *map(jnp.asarray, (r, k, v, lw, u)),
        state=None if st is None else jnp.asarray(st))
    assert y.shape == r.shape and s.shape == (2, 3, 8, 8)
    for mine, want in ((y, ref_y), (s, ref_s), (ry, oy), (rs, os_),
                       (y, oy), (s, os_)):
        assert rel_err(mine.numpy(), np.asarray(want)) <= WKV_TOL


# ------------------------------------------------- prefill and decode_step --

@pytest.mark.parametrize("chunks", [(77,), (64, 13), (76, 1)],
                         ids=["one", "bucket+ragged", "then-one-token"])
def test_prefill_and_decode_step_match_reference(pair, chunks):
    """Prefill in one shot (three scan chunks of 32, the last padded), in
    chunks at start_index > 0 (the states carried between prefill calls),
    and with a last 1-token chunk; then three decode steps: logits within
    1e-4 of the reference's, shift and WKV states within 1e-5 of their
    largest value."""
    _, ref_model, ref_params, _, model, params = pair
    ref_prefill = jax.jit(ref_model.prefill, static_argnames="start_index")
    ref_decode = jax.jit(ref_model.decode_step)
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
        assert tl.shape == (1, 1, 256) and tl.dtype == torch.float32
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    assert int(tc["index"]) == int(rc["index"]) == PROMPT_LEN
    for tok in (17, 200, 3):
        rl, rc = ref_decode(ref_params, jnp.asarray([[tok]], jnp.int32), rc)
        tl, tc = model.decode_step(params, torch.tensor([[tok]]), tc)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    assert tc["index"].dtype == torch.int32 and tc["index"].ndim == 0
    assert int(tc["index"]) == PROMPT_LEN + 3
    for name in ("shift1", "shift2", "wkv"):
        assert tuple(tc[name].shape) == rc[name].shape, name
        assert rel_err(tc[name].numpy(), np.asarray(rc[name])) <= 1e-5, \
            name


def test_init_params_and_cache_have_the_reference_layout(pair):
    """The port's own random init and cache: the reference's tree, shapes
    and dtypes, its constants (mix 0.5, w_base -6); the WKV state fp32."""
    ref_cfg, ref_model, ref_params, cfg, model, _ = pair
    mine = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(flat) == len(flat_ref)
    for path, ref in flat_ref:
        t = flat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
    for name in ("mix", "w_base", "mix_ffn", "ln1", "ln2"):
        np.testing.assert_array_equal(mine["layers"][name].numpy(),
                                      np.asarray(ref_params["layers"][name]))
    rc = ref_model.init_cache(batch=2, max_len=40, dtype=jnp.float32)
    tc = model.init_cache(batch=2, max_len=40, dtype=torch.float32,
                          device="cpu")
    assert set(tc) == set(rc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape, name
    assert tc["wkv"].dtype == torch.float32


# ------------------------------------------------------------ engine tokens --

@pytest.fixture(scope="module")
def ref_tokens(pair):
    """The reference engine's tokens per prefill strategy, computed once
    each, on first use."""
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


@pytest.mark.parametrize("fast_sync", [True, False], ids=["fast", "host"])
@pytest.mark.parametrize("strategy", PREFILL_STRATEGIES)
def test_engine_tokens_match_reference(pair, ref_tokens, strategy,
                                       fast_sync):
    """hetero-tensor mode (which RWKV ignores) against the reference
    engine; a second generate on the engine's reused cache (the decode
    loop's state left by the first) gives the first one's tokens: each
    prefill from position 0 starts from zero states."""
    cfg, _, params = pair[3:]
    table, plan = build_plan(cfg, sync_mode="fast" if fast_sync else "host")
    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy=strategy, fast_sync=fast_sync,
                          table=table, plan=plan, buckets=BUCKETS,
                          device="cpu")
    out = eng.generate(_prompt(), max_new_tokens=NEW_TOKENS)
    assert out.shape == (1, NEW_TOKENS) and out.device.type == "cpu"
    assert out.tolist() == ref_tokens(strategy)
    assert eng.generate(_prompt(), NEW_TOKENS).tolist() == out.tolist()
    assert len(eng._caches) == 1


def test_pipe_tail_moves_the_recurrent_state(pair):
    """The pipe strategy pads its tail chunk with token 0, which moves the
    token-shift and WKV states, so its first token's logits differ from
    the hetero strategy's, in both packages by the same amount."""
    _, ref_model, ref_params, cfg, model, params = pair
    prompt = _prompt()

    def first_logits(prefill, cache, pieces):
        idx = 0
        for piece, take in pieces:
            logits, cache = prefill(piece, cache, idx)
            idx += take
        return np.asarray(logits)

    pad = np.zeros((1, 32 - 12), np.int32)
    pipe = [(prompt[:, :64], 64), (np.concatenate([prompt[:, 64:76], pad],
                                                  axis=1), 12),
            (prompt[:, 76:], 1)]
    hetero = [(prompt[:, :64], 64), (prompt[:, 64:], 13)]

    def port(piece, cache, idx):
        return model.prefill(params, torch.from_numpy(piece).long(), cache,
                             start_index=idx)

    ref_prefill = jax.jit(ref_model.prefill, static_argnames="start_index")

    def ref(piece, cache, idx):
        return ref_prefill(ref_params, jnp.asarray(piece), cache,
                           start_index=idx)

    got = {}
    for name, pieces in (("pipe", pipe), ("hetero", hetero)):
        got[name] = (
            first_logits(port, model.init_cache(
                batch=1, max_len=128, dtype=torch.float32, device="cpu"),
                pieces),
            first_logits(ref, ref_model.init_cache(
                batch=1, max_len=128, dtype=jnp.float32), pieces))
    for name in got:
        assert rel_err(*got[name]) <= LOGITS_TOL
    assert rel_err(got["pipe"][0], got["hetero"][0]) > 1e-3


# ------------------------------------------------------- around the model --

def test_registry_batcher_and_bridge(pair):
    """RWKV has no paged trio and no slot prefill: PagedBatcher refuses it
    with the reference's message. The weight bridge counts RWKV layers by
    ``ln1``."""
    ref_params, cfg, model = pair[2], pair[3], pair[4]
    assert model.init_paged_cache is None and model.paged_prefill is None \
        and model.prefill_slot is None and model.encode is None
    with pytest.raises(ValueError, match="paged KV cache requires an "
                                         "attention-family model"):
        PagedBatcher(cfg, device="cpu")
    np_params = jax.tree.map(np.asarray, ref_params)
    with pytest.raises(ValueError, match="params hold 2 layers"):
        params_from_numpy(np_params, cfg.with_(n_layers=3), "cpu")


def test_cli_rwkv_engine_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode",
                "hetero-tensor", "--strategy", "pipe", "--prompt-len", "40",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "mode=hetero-tensor strategy=pipe fast_sync=True out=(1, 3) " \
        "device=cpu" in out
    with pytest.raises(ValueError, match="attention-family"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batched", "--paged", "--requests", "1"])
