"""The port's encoder-only path against the reference's: ``forward_hidden``
(hubert's ``encode``) on the fp32 hubert smoke model with the reference's
own parameters (PRNGKey 7), from token ids and from float frame embeddings
(the audio front end's stub), bidirectional where a decoder's is causal;
chameleon's ``forward_hidden`` from float patch embeddings (the VLM's
stub), causal; and the registry, engine, batchers and CLI refusing to
generate with an encoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import InferenceEngine
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.serving.scheduler import ContinuousBatcher, PagedBatcher

# two layers of fp32 sums taken in another order than XLA's
HIDDEN_TOL = 1e-4
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


def _pair(arch):
    ref_cfg = ref_get_smoke_config(arch).with_(**FP32)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = get_smoke_config(arch).with_(**FP32)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    return ref_cfg, ref_model, ref_params, cfg, build_model(cfg), params


@pytest.fixture(scope="module")
def hubert():
    return _pair("hubert-xlarge")


def _inputs(cfg, kind, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", ["tokens", "frames"])
def test_encode_matches_reference(hubert, kind):
    """hubert's encode from token ids and from frame embeddings [B, S, D]:
    hidden states within 1e-4 of the reference's."""
    _, ref_model, ref_params, cfg, model, params = hubert
    x = _inputs(cfg, kind)
    want = np.asarray(jax.jit(ref_model.encode)(ref_params, jnp.asarray(x)))
    got = model.encode(params, torch.from_numpy(x))
    assert got.shape == (2, 40, cfg.d_model) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= HIDDEN_TOL


def test_encoder_attention_is_bidirectional(hubert):
    """Changing the last frame moves the first position's hidden state in
    the encoder (both packages alike), and not in a causal decoder run of
    the same weights (``encoder_only=False``)."""
    ref_cfg, _, ref_params, cfg, _, params = hubert
    x = _inputs(cfg, "frames")
    y = x.copy()
    y[:, -1] += 1.0
    for enc in (True, False):
        c, rc = cfg.with_(encoder_only=enc), ref_cfg.with_(encoder_only=enc)
        mine = [transformer.forward_hidden(params, torch.from_numpy(a), c)
                for a in (x, y)]
        ref = [np.asarray(ref_transformer.forward_hidden(
            ref_params, jnp.asarray(a), rc)) for a in (x, y)]
        for m, r in zip(mine, ref):
            assert rel_err(m.numpy(), r) <= HIDDEN_TOL
        moved = rel_err(mine[0][:, 0].numpy(), mine[1][:, 0].numpy())
        assert (moved > 1e-3) == enc, (enc, moved)


def test_chameleon_forward_hidden_from_patch_embeddings():
    """The VLM's stub: float patch embeddings [B, S, D] through
    forward_hidden (causal): within 1e-4 of the reference's."""
    ref_cfg, _, ref_params, cfg, _, params = _pair("chameleon-34b")
    x = _inputs(cfg, "frames", S=33, seed=4)
    want = np.asarray(ref_transformer.forward_hidden(ref_params,
                                                     jnp.asarray(x), ref_cfg))
    got = transformer.forward_hidden(params, torch.from_numpy(x), cfg)
    assert rel_err(got.numpy(), want) <= HIDDEN_TOL


def test_init_params_have_the_reference_layout(hubert):
    _, _, ref_params, cfg, model, _ = hubert
    mine = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(flat) == len(flat_ref)
    for path, ref in flat_ref:
        t = flat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), path


def test_nothing_generates_with_an_encoder(hubert, capsys):
    """An encoder-only model has ``encode`` and no cache, prefill or decode
    (as the reference's); the engine, both batchers and the CLI refuse
    it."""
    cfg, model = hubert[3], hubert[4]
    assert model.encode is not None and model.init_cache is None \
        and model.prefill is None and model.decode_step is None \
        and model.paged_prefill is None and model.prefill_slot is None
    with pytest.raises(ValueError, match="encoder-only"):
        InferenceEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        PagedBatcher(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        ContinuousBatcher(cfg, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    assert "encoder-only" in capsys.readouterr().err
