"""The port against the reference on each of the five dense smoke configs:
llama3-8b, smollm-135m (tied embeddings), tinyllama-1.1b, qwen3-1.7b
(qk_norm) and internlm-1.8b, fp32, with the reference's own parameters
(``model.init(PRNGKey(7))``) carried across by ``repro_torch.convert``.
Paged prefill logits within 1e-4 of the reference's, and the
single-request engine's greedy tokens equal to the reference engine's."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.engine import InferenceEngine as RefEngine
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import InferenceEngine, build_plan
from repro_torch.models import build_model

ARCHS = ("llama3-8b", "smollm-135m", "tinyllama-1.1b", "qwen3-1.7b",
         "internlm-1.8b")
# two layers of fp32 sums taken in another order than XLA's
LOGITS_TOL = 1e-4
NUM_BLOCKS, BLOCK = 8, 32
TABLE = np.array([[1, 2, 3, 5, 0]], np.int32)
PROMPT_LEN, NEW_TOKENS = 77, 4
BUCKETS = (32, 64)


@lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, model, params; port cfg, model, params), made once
    per config."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = ref_get_smoke_config(arch).with_(**fp32)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = get_smoke_config(arch).with_(**fp32)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


def _prompt(arch):
    seed = ARCHS.index(arch)
    return np.random.default_rng(seed).integers(0, 256, (1, PROMPT_LEN)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_logits_match_reference(arch):
    _, ref_model, ref_params, _, model, params = _pair(arch)
    tokens = _prompt(arch)
    rpool = ref_model.init_paged_cache(num_blocks=NUM_BLOCKS,
                                       block_size=BLOCK, dtype=jnp.float32)
    rl, _ = ref_model.paged_prefill(ref_params, jnp.asarray(tokens), rpool,
                                    block_table=jnp.asarray(TABLE))
    tpool = model.init_paged_cache(num_blocks=NUM_BLOCKS, block_size=BLOCK,
                                   dtype=torch.float32, device="cpu")
    tl, _ = model.paged_prefill(params, torch.from_numpy(tokens).long(),
                                tpool, block_table=torch.from_numpy(TABLE))
    rl = np.asarray(rl)
    assert tl.shape == rl.shape
    assert rel_err(tl.numpy(), rl) <= LOGITS_TOL
    assert np.array_equal(tl.numpy().argmax(-1), rl.argmax(-1))


@pytest.mark.parametrize("mode", ["xla", "hetero-tensor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(arch, mode):
    """Greedy tokens of the hetero prefill strategy with fast sync, the
    port's engine in ``mode`` against the reference engine in xla mode (the
    modes give the same tokens, tests/test_torch_engine.py)."""
    ref_cfg, _, ref_params, cfg, _, params = _pair(arch)
    tokens = _prompt(arch)
    ref = RefEngine(ref_cfg, ref_params, mode="xla", prefill_strategy="hetero",
                    buckets=BUCKETS, max_len=256)
    want = np.asarray(ref.generate(jnp.asarray(tokens),
                                   max_new_tokens=NEW_TOKENS)).tolist()
    table, plan = build_plan(cfg, sync_mode="fast")
    eng = InferenceEngine(cfg, params, mode=mode, prefill_strategy="hetero",
                          table=table, plan=plan, buckets=BUCKETS,
                          device="cpu")
    out = eng.generate(tokens, max_new_tokens=NEW_TOKENS)
    assert out.shape == (1, NEW_TOKENS)
    assert out.tolist() == want
