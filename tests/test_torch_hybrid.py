"""The port's Mamba2 hybrid (zamba2) against the reference's on the fp32
zamba2 smoke model with the reference's own parameters (PRNGKey 7),
carried across by ``repro_torch.convert``: ``prefill`` (one shot and in
chunks at ``start_index > 0``) and ``decode_step`` logits and the conv / SSM
/ K / V cache, the plan decision for decision, ``InferenceEngine`` tokens
for every prefill strategy x engine mode x sync arm (``pipe`` against the
reference's ``pipe``, whose zero-padded tail moves the recurrent state),
and the registry, weight bridge, batcher and CLI around them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro import configs as ref_configs
from repro.core.engine import InferenceEngine as RefEngine
from repro.core.engine import build_plan as ref_build_plan
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import PREFILL_STRATEGIES, InferenceEngine, \
    build_plan
from repro_torch.kernels.ssm_scan.ops import ssd_chunk
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.mamba2 import init_params
from repro_torch.serving.scheduler import PagedBatcher

ARCH = "zamba2-2.7b"
# four mamba layers and two shared-block passes of fp32 sums taken in
# another order than XLA's
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


def _assert_cache_equal(tc, rc):
    for name in ("conv", "ssm", "k", "v"):
        assert tuple(tc[name].shape) == rc[name].shape, name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


# ------------------------------------------------- prefill and decode_step --

@pytest.mark.parametrize("chunks", [(77,), (64, 13), (76, 1)],
                         ids=["one", "bucket+ragged", "then-one-token"])
def test_prefill_and_decode_step_match_reference(pair, chunks):
    """Prefill in one shot (three SSD chunks of 32, the last padded), in
    chunks at start_index > 0 (the state carried between prefill calls),
    and with a last 1-token chunk; then three decode steps at the device
    index: logits within 1e-4 of the reference's, conv / SSM / K / V caches
    equal."""
    _, ref_model, ref_params, _, model, params = pair
    ref_prefill = jax.jit(ref_model.prefill)
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
    _assert_cache_equal(tc, rc)
    for tok in (17, 200, 3):
        rl, rc = ref_decode(ref_params, jnp.asarray([[tok]], jnp.int32), rc)
        tl, tc = model.decode_step(params, torch.tensor([[tok]]), tc)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    assert tc["index"].dtype == torch.int32 and tc["index"].ndim == 0
    assert int(tc["index"]) == PROMPT_LEN + 3
    _assert_cache_equal(tc, rc)


def test_init_params_and_cache_have_the_reference_layout(pair):
    """The port's own random init and cache: the reference's tree, shapes
    and dtypes, its deterministic A_log / dt_bias / D; the SSM state fp32."""
    ref_cfg, ref_model, ref_params, cfg, model, _ = pair
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(flat) == len(flat_ref)
    for path, ref in flat_ref:
        t = flat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
    for name in ("A_log", "dt_bias", "D"):
        np.testing.assert_allclose(mine["mamba"][name].numpy(),
                                   np.asarray(ref_params["mamba"][name]),
                                   rtol=1e-6, atol=1e-6)
    rc = ref_model.init_cache(batch=2, max_len=40, dtype=jnp.float32)
    tc = model.init_cache(batch=2, max_len=40, dtype=torch.float32,
                          device="cpu")
    assert set(tc) == set(rc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape, name
    assert tc["ssm"].dtype == torch.float32
    assert tc["index"].dtype == torch.int32


# ------------------------------------------------------------------ plan --

def _plan_key(plan):
    return {k: (d.strategy, d.n_split, d.m_bucket)
            for k, d in plan.decisions.items()}


@pytest.mark.parametrize("sync_mode", ["fast", "host"])
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_build_plan_matches_reference(smoke, sync_mode):
    """The hybrid's sites (the shared block's seven, the head, in_proj and
    out_proj) and the plan over them, decision for decision."""
    get, ref_get = ((get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (get_config, ref_configs.get_config))
    cfg, ref = get(ARCH), ref_get(ARCH)
    if smoke:
        cfg, ref = _fp32(cfg), _fp32(ref)
    table, plan = build_plan(cfg, sync_mode=sync_mode)
    ref_table, ref_plan = ref_build_plan(ref, sync_mode=sync_mode)
    assert table.sites == ref_table.sites
    assert {"in_proj", "out_proj"} <= set(table.sites)
    assert _plan_key(plan) == _plan_key(ref_plan)
    for k, d in plan.decisions.items():
        assert d.t_us == pytest.approx(ref_plan.decisions[k].t_us, rel=1e-12)


def test_full_config_in_proj_is_not_128_aligned():
    """zamba2-2.7b's in_proj has N = 10448, which the aligned path pads."""
    table, _ = build_plan(get_config(ARCH))
    assert table.sites["in_proj"] == (2560, 10448) and 10448 % 128
    assert table.sites["out_proj"] == (5120, 2560)


# ------------------------------------------------------------ engine tokens --

@pytest.fixture(scope="module")
def ref_tokens(pair):
    """The reference engine's tokens per prefill strategy (xla mode),
    computed once each, on first use."""
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
    before = ssd_chunk.launches
    out = eng.generate(_prompt(), max_new_tokens=NEW_TOKENS)
    assert out.shape == (1, NEW_TOKENS) and out.device.type == "cpu"
    assert out.tolist() == ref_tokens(strategy)
    assert ssd_chunk.launches == before         # CPU tensors: plain version


def test_pipe_tail_moves_the_recurrent_state(ref_tokens):
    """The reference's pipe strategy pads its tail chunk with token 0; in a
    Mamba2 layer those tokens move the conv and SSM state, so pipe's tokens
    differ from the other strategies' (which agree), in both packages."""
    others = {str(ref_tokens(s)) for s in PREFILL_STRATEGIES if s != "pipe"}
    assert len(others) == 1 and str(ref_tokens("pipe")) not in others


# ------------------------------------------------------- around the model --

def test_registry_and_batcher_refuse_what_is_not_ported(pair):
    cfg, model = pair[3], pair[4]
    assert model.init_paged_cache is None and model.paged_prefill is None \
        and model.paged_decode_step is None
    dense = build_model(get_smoke_config("llama3-8b"))
    assert dense.paged_decode_step is not None
    for family in ("moe", "ssm", "audio"):
        with pytest.raises(NotImplementedError, match=family):
            build_model(cfg.with_(family=family))
    with pytest.raises(ValueError, match="paged KV cache requires an "
                                         "attention-family model"):
        PagedBatcher(cfg, device="cpu")


def test_weight_bridge_checks_the_mamba_stack(pair):
    ref_params, cfg = pair[2], pair[3]
    np_params = jax.tree.map(np.asarray, ref_params)
    with pytest.raises(ValueError, match="params hold 4 layers"):
        params_from_numpy(np_params, cfg.with_(n_layers=6), "cpu")


def test_cli_hybrid_engine_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode",
                "hetero-tensor", "--strategy", "hetero", "--prompt-len", "40",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "mode=hetero-tensor strategy=hetero fast_sync=True out=(1, 3) " \
        "device=cpu" in out
    with pytest.raises(ValueError, match="attention-family"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batched", "--paged", "--requests", "1"])
