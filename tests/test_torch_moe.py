"""The port's MoE family against the reference's, fp32 smoke configs of
qwen2-moe-a2.7b (60 -> 6 routed experts top-2 plus a shared expert with
its sigmoid gate) and dbrx-132b (4 experts top-2, no shared expert), with
the reference's own parameters (``model.init(PRNGKey(7))``) carried across
by ``repro_torch.convert``: ``moe_ffn`` (output and aux loss) with token
drops at the default capacity, without them at ``capacity_factor=8``, over
several dispatch groups, and on the bf16 router path. Then, for both and
for chameleon-34b (the VLM: a dense transformer with qk-norm, served
through the same entry points), the dense and paged entry points' logits
and ``PagedBatcher`` and ``InferenceEngine`` greedy tokens; and the
speculative draft rule of both packages."""
import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.engine import InferenceEngine as RefEngine
from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import (PREFILL_STRATEGIES, InferenceEngine,
                                     build_hetero_ctx, build_plan)
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import layer_params
from repro_torch.serving.scheduler import PagedBatcher, Request
from repro_torch.serving.spec import SpecConfig

ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
SERVED = ARCHS + ("chameleon-34b",)
# fp32 sums over the experts' products taken in another order than XLA's
MOE_TOL = 1e-5
# two layers of fp32 sums taken in another order than XLA's
LOGITS_TOL = 1e-4
# the bf16 path: the reference's conformance bound for bf16
BF16_TOL = 2e-2
PROMPT_LENS = (5, 70, 44)
NEW_TOKENS = 5
POOL = dict(num_blocks=1 + 3 * 4, block_size=32, max_blocks_per_seq=4,
            decode_width=4)
SYNCS = {"host": dict(sync="host"), "device-w3": dict(sync="device",
                                                      window=3)}
BUCKETS = (32, 64)
PROMPT_LEN = 77
_ref_moe_ffn = jax.jit(ref_moe.moe_ffn, static_argnames="cfg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """(reference cfg, model, params; port cfg, model, params), made once
    per config and dtype."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    ref_cfg = ref_get_smoke_config(arch).with_(**kw)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = get_smoke_config(arch).with_(**kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _layer0_moe(arch, dtype="float32"):
    ref_cfg, _, ref_params, cfg, _, params = _pair(arch, dtype)
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"])
    return ref_cfg, ref_p, cfg, layer_params(params["layers"], 0)["moe"]


def _x(cfg, B=2, S=40, seed=0, skew=0.0):
    """Seeded activations; ``skew`` adds one direction shared by every
    token, which sends most tokens to the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model))
    return (x + skew * rng.standard_normal(cfg.d_model)).astype(np.float32)


# ----------------------------------------------------------------- moe_ffn --

@pytest.mark.parametrize("case", ["drops", "cf8", "groups"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    """Output and aux loss within 1e-5 on skewed activations (most tokens
    want the same experts): at the default capacity, where tokens are
    dropped (the output differs from capacity_factor=8's); at
    capacity_factor=8, where none is; and over three dispatch groups of 16
    tokens (group_size=16 on 48 tokens)."""
    ref_cfg, ref_p, cfg, p = _layer0_moe(arch)
    kw = {"drops": {}, "cf8": {"capacity_factor": 8.0},
          "groups": {"group_size": 16}}[case]
    ref_cfg = ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, **kw))
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **kw))
    x = _x(cfg, S=24 if case == "groups" else 40, skew=2.0)
    ref_out, ref_aux = _ref_moe_ffn(ref_p, jnp.asarray(x), ref_cfg)
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert rel_err(out.numpy(), np.asarray(ref_out)) <= MOE_TOL
    assert float(aux) == pytest.approx(float(ref_aux), rel=MOE_TOL)
    if case == "drops":
        roomy = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
        full, _ = moe.moe_ffn(p, torch.from_numpy(x), roomy)
        assert rel_err(out.numpy(), full.numpy()) > 1e-3   # some were dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_router_path(arch):
    """bf16 weights and activations: the router's logits are the fp32
    product of the bf16 operands (the router rounded to bf16 first), so
    the port routes every token as the reference does; the output is
    within the bf16 bound."""
    ref_cfg, ref_p, cfg, p = _layer0_moe(arch, "bfloat16")
    assert p["router"].dtype == torch.float32
    x = torch.from_numpy(_x(cfg, seed=1)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref_out, ref_aux = _ref_moe_ffn(ref_p, xj, ref_cfg)
    out, aux = moe.moe_ffn(p, x, cfg)
    assert out.dtype == torch.bfloat16
    assert rel_err(out.float().numpy(),
                   np.asarray(ref_out.astype(jnp.float32))) <= BF16_TOL
    # the routing: f32 logits of the bf16-rounded operands, top-k equal
    ref_logits = jnp.einsum("gtd,de->gte", xj.reshape(1, -1, cfg.d_model),
                            ref_p["router"].astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
    logits = x.reshape(1, -1, cfg.d_model).float() @ \
        p["router"].to(torch.bfloat16).float()
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(
        torch.topk(logits, cfg.moe.top_k).indices.numpy(),
        np.asarray(jax.lax.top_k(ref_logits, cfg.moe.top_k)[1]))
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)


def test_init_params_have_the_reference_layout():
    """The port's own random init: the reference's tree, shapes and dtypes
    (router and shared gate fp32, the shared gate zero)."""
    _, _, ref_params, cfg, model, _ = _pair("qwen2-moe-a2.7b")
    mine = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(flat) == len(flat_ref)
    for path, ref in flat_ref:
        t = flat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path
    assert not mine["layers"]["moe"]["shared_gate"].any()


# --------------------------------------------------------- dense and paged --

def _prompt(n=PROMPT_LEN, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(
        np.int32)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_logits_match_reference(arch):
    """Dense cache: a prompt in two chunks (64 at 0, 13 at 64), then three
    decode steps; and the same prompt through paged_prefill and three
    paged_decode_steps over a block table: logits within 1e-4."""
    _, ref_model, ref_params, cfg, model, params = _pair(arch)
    tokens = _prompt()
    rc = ref_model.init_cache(batch=1, max_len=96, dtype=jnp.float32)
    tc = model.init_cache(batch=1, max_len=96, dtype=torch.float32,
                          device="cpu")
    ref_prefill = jax.jit(ref_model.prefill, static_argnames="start_index")
    for start, n in ((0, 64), (64, 13)):
        piece = tokens[:, start:start + n]
        rl, rc = ref_prefill(ref_params, jnp.asarray(piece), rc,
                             start_index=start)
        tl, tc = model.prefill(params, torch.from_numpy(piece).long(), tc,
                               start_index=start)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    ref_decode = jax.jit(ref_model.decode_step)
    for tok in (17, 200, 3):
        rl, rc = ref_decode(ref_params, jnp.asarray([[tok]], jnp.int32), rc)
        tl, tc = model.decode_step(params, torch.tensor([[tok]]), tc)
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL

    table = np.array([[1, 2, 3, 0]], np.int32)
    rpool = ref_model.init_paged_cache(num_blocks=6, block_size=32,
                                       dtype=jnp.float32)
    tpool = model.init_paged_cache(num_blocks=6, block_size=32,
                                   dtype=torch.float32, device="cpu")
    rl, rpool = jax.jit(ref_model.paged_prefill)(
        ref_params, jnp.asarray(tokens), rpool, block_table=table)
    tl, tpool = model.paged_prefill(params, torch.from_numpy(tokens).long(),
                                    tpool, block_table=torch.from_numpy(table))
    assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    ref_step = jax.jit(ref_model.paged_decode_step)
    for i, tok in enumerate((17, 200, 3)):
        n = np.array([PROMPT_LEN + i], np.int32)
        rl, rpool = ref_step(ref_params, jnp.asarray([[tok]], jnp.int32),
                             rpool, block_tables=table, lengths=n)
        tl, tpool = model.paged_decode_step(
            params, torch.tensor([[tok]]), tpool,
            block_tables=torch.from_numpy(table), lengths=torch.from_numpy(n))
        assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL


@pytest.mark.parametrize("arch,mode", [(a, "xla") for a in SERVED]
                         + [("qwen2-moe-a2.7b", "mxu")])
def test_verify_and_mixed_step_logits_match_reference(arch, mode):
    """Two lanes prefilled into the pool, then paged_verify of 3 tokens a
    lane at their own starts, and mixed_step (the two lanes decoding, a
    third request's 11-token chunk at start 16; the chunk and the lanes
    form separate capacity groups): every logit within 1e-4, the matmuls
    through the HeteroCtx in ``mode`` (mxu on qwen2-moe: its shared
    expert, wider than the routed expert the plan's site was solved for,
    through the aligned path)."""
    ref_cfg, ref_model, ref_params, cfg, model, params = _pair(arch)
    pairs = ((11, 2),)
    ref_ctx = ref_build_hetero_ctx(ref_cfg, mode, mixed_pairs=pairs,
                                   verify_ks=((2, 2),))
    ctx = build_hetero_ctx(cfg, mode, mixed_pairs=pairs, verify_ks=((2, 2),))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in (9, 20, 16)]
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    rpool = ref_model.init_paged_cache(num_blocks=8, block_size=16,
                                       dtype=jnp.float32)
    tpool = model.init_paged_cache(num_blocks=8, block_size=16,
                                   dtype=torch.float32, device="cpu")
    ref_prefill = jax.jit(ref_model.paged_prefill)
    for p, t in zip(prompts, tables):
        _, rpool = ref_prefill(ref_params, jnp.asarray(p)[None], rpool,
                               block_table=jnp.asarray(t)[None],
                               start_index=0)
        _, tpool = model.paged_prefill(params, torch.as_tensor(p)[None],
                                       tpool,
                                       block_table=torch.as_tensor(t)[None],
                                       start_index=0)
    # verify: 3 positions a lane after each lane's prefix (rolled back
    # afterwards in serving; here the pools are compared after it too)
    draft = rng.integers(0, 256, (2, 3))
    starts = np.array([9, 20], np.int32)
    rl, rpool = jax.jit(partial(ref_model.paged_verify,
                                hetero_ctx=ref_ctx.for_verify(2, 2)))(
        ref_params, jnp.asarray(draft, jnp.int32), rpool,
        block_table=jnp.asarray(tables[:2]), start_index=jnp.asarray(starts))
    tl, tpool = model.paged_verify(
        params, torch.as_tensor(draft), tpool,
        block_table=torch.as_tensor(tables[:2]),
        start_index=torch.as_tensor(starts), hetero_ctx=ctx.for_verify(2, 2))
    assert tl.shape == (2, 3, cfg.vocab_size)
    assert rel_err(tl.numpy(), np.asarray(rl)) <= LOGITS_TOL
    last, lengths = np.array([[7], [200]]), np.array([12, 23])
    chunk = rng.integers(0, 256, (1, 11))
    ref_dl, ref_pl, rpool = jax.jit(partial(ref_model.mixed_step,
                                            hetero_ctx=ref_ctx))(
        ref_params, jnp.asarray(last, jnp.int32),
        jnp.asarray(chunk, jnp.int32), rpool,
        decode_tables=jnp.asarray(tables[:2]),
        decode_lengths=jnp.asarray(lengths, jnp.int32),
        prefill_table=jnp.asarray(tables[2:]),
        prefill_start=jnp.asarray(16, jnp.int32))
    dl, pl, tpool = model.mixed_step(
        params, torch.as_tensor(last), torch.as_tensor(chunk), tpool,
        decode_tables=torch.as_tensor(tables[:2]),
        decode_lengths=torch.as_tensor(lengths),
        prefill_table=torch.as_tensor(tables[2:]),
        prefill_start=torch.tensor(16), hetero_ctx=ctx)
    assert rel_err(dl.numpy(), np.asarray(ref_dl)) <= LOGITS_TOL
    assert rel_err(pl.numpy(), np.asarray(ref_pl)) <= LOGITS_TOL
    for name in ("k", "v"):
        assert rel_err(tpool[name].numpy(), np.asarray(rpool[name])) \
            <= LOGITS_TOL


# ------------------------------------------------------------------ tokens --

def _serving_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("sync", list(SYNCS))
@pytest.mark.parametrize("arch", SERVED)
def test_paged_batcher_tokens_match_reference(arch, sync):
    """PagedBatcher(engine_mode='hetero-tensor'): the reference's greedy
    tokens and dispatch counts. Capacity couples the lanes of one
    dispatch (idle lanes included), so both packages run the same lanes."""
    ref_cfg, _, ref_params, cfg, _, params = _pair(arch)
    ref = RefPagedBatcher(ref_cfg, ref_params, engine_mode="hetero-tensor",
                          **POOL, **SYNCS[sync])
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_serving_prompts())]
    ref.run(ref_reqs)
    cb = PagedBatcher(cfg, params, engine_mode="hetero-tensor", device="cpu",
                      **POOL, **SYNCS[sync])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_serving_prompts())]
    cb.run(reqs)
    cb.kv.assert_drained()
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(len(r.output) == NEW_TOKENS for r in reqs)
    for key in ("decode_dispatches", "decode_steps", "prefill_dispatches"):
        assert cb.stats()[key] == ref.stats()[key], key


@pytest.mark.parametrize("strategy", PREFILL_STRATEGIES)
@pytest.mark.parametrize("arch", SERVED)
def test_engine_tokens_match_reference(arch, strategy):
    """InferenceEngine (hetero-tensor, fast sync) against the reference
    engine (xla) per prefill strategy: each strategy's chunks are the
    capacity groups of its prefill, in both packages alike."""
    ref_cfg, _, ref_params, cfg, _, params = _pair(arch)
    ref = RefEngine(ref_cfg, ref_params, mode="xla", prefill_strategy=strategy,
                    buckets=BUCKETS, max_len=256)
    want = np.asarray(ref.generate(jnp.asarray(_prompt()),
                                   max_new_tokens=NEW_TOKENS)).tolist()
    table, plan = build_plan(cfg, sync_mode="fast")
    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy=strategy, table=table, plan=plan,
                          buckets=BUCKETS, device="cpu")
    assert eng.generate(_prompt(), NEW_TOKENS).tolist() == want


# ------------------------------------------------------------- draft rule --

@pytest.mark.parametrize("draft,ok", [("qwen2-moe-a2.7b", True),
                                      ("chameleon-34b", True),
                                      ("rwkv6-3b", False),
                                      ("zamba2-2.7b", False)])
def test_spec_draft_rule_matches_reference(draft, ok):
    """A draft must be a decoder attention-family model: an MoE or a VLM
    draft resolves, an RWKV or a hybrid one is refused, in both packages."""
    target = get_smoke_config("llama3-8b")
    ref_target = ref_get_smoke_config("llama3-8b")
    spec = SpecConfig(k=2, draft=draft, smoke=True)
    ref_spec = RefSpecConfig(k=2, draft=draft, smoke=True)
    if ok:
        assert spec.resolve_draft(target).name == \
            ref_spec.resolve_draft(ref_target).name
    else:
        for s, t in ((spec, target), (ref_spec, ref_target)):
            with pytest.raises(ValueError, match="attention-family"):
                s.resolve_draft(t)
