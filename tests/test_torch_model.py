"""The port's paged transformer against the reference on the fp32 llama3
smoke model with the reference's own parameters (PRNGKey 7, as
``conftest.smoke_model``), carried across by ``repro_torch.convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import build_hetero_ctx
from repro_torch.core.partition import HeteroCtx
from repro_torch.core.solver import Decision, PartitionPlan
from repro_torch.models import build_model
from repro_torch.models.layers import (blockwise_attention, dense_attention,
                                       rope_freqs)

# two layers of fp32 sums taken in another order than XLA's
LOGITS_TOL = 1e-4
NUM_BLOCKS, BLOCK = 8, 32


@pytest.fixture(scope="module")
def pair(smoke_model):
    ref_cfg, ref_model, ref_params = smoke_model
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


TABLE = np.array([[1, 2, 3, 5, 0]], np.int32)


def _prefill_ref(pair, tokens, ref_ctx=None):
    _, ref_model, ref_params = pair[:3]
    rpool = ref_model.init_paged_cache(num_blocks=NUM_BLOCKS,
                                       block_size=BLOCK, dtype=jnp.float32)
    rl, rpool = ref_model.paged_prefill(ref_params, jnp.asarray(tokens),
                                        rpool, block_table=jnp.asarray(TABLE),
                                        hetero_ctx=ref_ctx)
    return np.asarray(rl), rpool


def _prefill_port(pair, tokens, ctx=None):
    model, params = pair[4:]
    tpool = model.init_paged_cache(num_blocks=NUM_BLOCKS, block_size=BLOCK,
                                   dtype=torch.float32, device="cpu")
    tl, tpool = model.paged_prefill(params, torch.as_tensor(tokens).long(),
                                    tpool, block_table=torch.as_tensor(TABLE),
                                    hetero_ctx=ctx)
    return tl.numpy(), tpool


def test_convert_keeps_values_and_layout(pair):
    _, _, ref_params, cfg, _, params = pair
    for a, b in ((ref_params["embed"], params["embed"]),
                 (ref_params["layers"]["attn"]["wq"],
                  params["layers"]["attn"]["wq"]),
                 (ref_params["layers"]["ffn"]["w_down"],
                  params["layers"]["ffn"]["w_down"])):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_convert_bf16_through_float32():
    """ml_dtypes bfloat16 leaves (what JAX bf16 arrays become) convert
    exactly, keeping their type."""
    w = np.asarray(jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                               ).astype(jnp.bfloat16)).reshape(1, 3, 4)
    cfg = get_smoke_config("llama3-8b").with_(n_layers=1)
    out = params_from_numpy({"layers": {"attn_norm": w}}, cfg, "cpu")
    t = out["layers"]["attn_norm"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))


@pytest.mark.parametrize("n", [5, 70])
def test_paged_prefill_matches_reference(pair, n):
    rl, _ = _prefill_ref(pair, _prompt(n))
    tl, _ = _prefill_port(pair, _prompt(n))
    assert tl.shape == rl.shape == (1, 1, 256)
    assert rel_err(tl, rl) <= LOGITS_TOL


def test_paged_decode_step_matches_reference(pair):
    ref_cfg, ref_model, ref_params, cfg, model, params = pair
    _, rpool = _prefill_ref(pair, _prompt(70))
    _, tpool = _prefill_port(pair, _prompt(70))
    # lane 0 continues the prompt at position 70; lane 1 is inactive
    # (null table, length 0) and sinks its write into the null block
    tables = np.stack([TABLE[0], np.zeros_like(TABLE[0])])
    tok = np.array([[17], [3]], np.int32)
    lengths = np.array([70, 0], np.int32)
    rl, _ = ref_model.paged_decode_step(
        ref_params, jnp.asarray(tok), rpool, block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lengths))
    tl, _ = model.paged_decode_step(
        params, torch.as_tensor(tok).long(), tpool,
        block_tables=torch.as_tensor(tables),
        lengths=torch.as_tensor(lengths).long())
    assert rel_err(tl[:1].numpy(), np.asarray(rl)[:1]) <= LOGITS_TOL


def test_hetero_tensor_prefill_matches_reference_hetero(pair):
    """The slice's prefill under the solver's plan: port HeteroCtx vs the
    reference HeteroCtx (Pallas in interpret mode) on the same plan."""
    ref_cfg, _, _, cfg, _, _ = pair
    rl, _ = _prefill_ref(pair, _prompt(70, seed=4),
                         ref_build_hetero_ctx(ref_cfg, "hetero-tensor"))
    tl, _ = _prefill_port(pair, _prompt(70, seed=4),
                          build_hetero_ctx(cfg, "hetero-tensor"))
    assert rel_err(tl, rl) <= LOGITS_TOL


@pytest.mark.parametrize("mode", ["mxu", "hetero-layer", "hetero-tensor"])
def test_every_mode_matches_xla_mode(pair, mode):
    """Partitioning is an execution schedule: every mode gives xla mode's
    logits (to fp32 summation order) and the same greedy token."""
    cfg = pair[3]
    tokens = _prompt(130, seed=5)
    base, _ = _prefill_port(pair, tokens, build_hetero_ctx(cfg, "xla"))
    other, _ = _prefill_port(pair, tokens, build_hetero_ctx(cfg, mode))
    assert rel_err(other, base) <= 1e-5
    assert other.argmax() == base.argmax()


@pytest.mark.parametrize("strategy", ["xla_only", "mxu_only", "pad",
                                      "weight", "act", "hybrid"])
def test_every_strategy_matches_xla(pair, strategy):
    """A plan forcing one strategy at every site (splits at a 128-aligned
    column and a 64-token bucket) gives xla mode's logits."""
    cfg = pair[3]
    tokens = _prompt(100, seed=6)
    sites = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head")
    plan = PartitionPlan(arch=cfg.name, sync_mode="fast")
    for site in sites:
        plan.decisions[(site, 100)] = Decision(
            site, 100, strategy, 0.0, n_split=128, m_bucket=64)
        plan.decisions[(site, 1)] = Decision(site, 1, "xla_only", 0.0)
    base, _ = _prefill_port(pair, tokens, HeteroCtx(mode="xla"))
    other, _ = _prefill_port(pair, tokens,
                             HeteroCtx(mode="hetero-tensor", plan=plan))
    assert rel_err(other, base) <= 1e-5


def test_blockwise_attention_matches_dense_and_reference():
    from repro.models.layers import blockwise_attention as ref_blockwise
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 9, 4, 16), np.float32)
    k = rng.standard_normal((2, 40, 2, 16), np.float32)
    v = rng.standard_normal((2, 40, 2, 16), np.float32)
    q_pos = np.arange(31, 40, dtype=np.int32)
    kv_pos = np.arange(40, dtype=np.int32)
    for causal in (True, False):
        o = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                q_pos=torch.from_numpy(q_pos).long(),
                                kv_pos=torch.from_numpy(kv_pos).long(),
                                causal=causal, block_k=16)
        d = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            q_pos=torch.from_numpy(q_pos).long(),
                            kv_pos=torch.from_numpy(kv_pos).long(),
                            causal=causal)
        r = ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                          causal=causal, block_k=16)
        assert rel_err(o.numpy(), d.numpy()) <= 1e-5
        assert rel_err(o.numpy(), np.asarray(r)) <= 1e-5


def test_rope_freqs_identical_to_reference():
    from repro.models.layers import rope_freqs as ref_rope_freqs
    np.testing.assert_array_equal(rope_freqs(128, 500000.0),
                                  ref_rope_freqs(128, 500000.0))
