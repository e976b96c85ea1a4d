"""The port's training objective against the reference's: ``loss_fn`` and
every leaf's gradient against ``jax.value_and_grad`` of the reference's
``model.loss`` on the fp32 smoke models of five configs (smollm-135m,
qwen3-1.7b with qk-norm, qwen2-moe-a2.7b with its aux loss, chameleon-34b,
hubert-xlarge from float frames, bidirectional), each with the reference's
own parameters (PRNGKey 7); ``chunked_ce_loss`` against the unchunked
cross-entropy and the reference's; the three remat settings giving the same
gradients; the MoE aux loss that ``transformer._layer`` now returns; and
``score_nll`` on fp, int8 and W4A16 weights against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import rel_err
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models.quant import quantize_params as ref_quantize_params
from repro.models.quant import score_nll as ref_score_nll
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, transformer
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.models.quant import quantize_params, score_nll
from repro_torch.training.tree import tree_flatten

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ("smollm-135m", "qwen3-1.7b", "qwen2-moe-a2.7b", "chameleon-34b",
         "hubert-xlarge")
LOSS_TOL = 1e-5      # relative, on the scalar loss
GRAD_TOL = 1e-4      # rel_err per leaf: two layers of fp32 sums in other
#                      orders than XLA's, through a softmax and a CE
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch(cfg, arch, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    if cfg.encoder_only:          # hubert: float frame embeddings
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs = toks[:, :-1]
    return inputs, toks[:, 1:]


def _ref_value_and_grad(ref_model, ref_params, inputs, targets):
    return jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, jnp.asarray(inputs),
                                 jnp.asarray(targets)),
        has_aux=True))(ref_params)


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the reference's (loss, metrics, grads) on one batch, and
    the port's config, model and params (the reference's, converted)."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_get_smoke_config(arch).with_(**FP32)
        ref_model = ref_build_model(ref_cfg)
        ref_params = ref_model.init(jax.random.PRNGKey(7))
        cfg = get_smoke_config(arch).with_(**FP32)
        inputs, targets = _batch(cfg, arch)
        (loss, metrics), grads = _ref_value_and_grad(ref_model, ref_params,
                                                     inputs, targets)
        out[arch] = dict(
            ref=(float(loss), {k: float(v) for k, v in metrics.items()},
                 jax.tree.map(np.asarray, grads)),
            np_params=jax.tree.map(np.asarray, ref_params),
            cfg=cfg, model=build_model(cfg), batch=(inputs, targets))
    return out


def _port_grads(entry, cfg=None):
    cfg = cfg or entry["cfg"]
    params = params_from_numpy(entry["np_params"], cfg, "cpu")
    leaves = [t.requires_grad_() for _, t in tree_flatten(params)]
    inputs, targets = entry["batch"]
    loss, metrics = build_model(cfg).loss(params, torch.from_numpy(inputs),
                                          torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss, metrics, grads, [p for p, _ in tree_flatten(params)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(pairs, arch):
    """The loss within 1e-5 relative, ce and aux as the reference's, and
    every parameter's gradient within rel_err 1e-4 (a leaf the loss does
    not read, the embedding under float inputs, has the reference's zero
    gradient)."""
    entry = pairs[arch]
    ref_loss, ref_metrics, ref_grads = entry["ref"]
    loss, metrics, grads, paths = _port_grads(entry)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(loss.item() - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert abs(float(metrics["ce"]) - ref_metrics["ce"]) \
        <= LOSS_TOL * abs(ref_metrics["ce"])
    assert abs(float(metrics["aux"]) - ref_metrics["aux"]) \
        <= LOSS_TOL * max(abs(ref_metrics["aux"]), 1.0)
    assert len(paths) == len(jax.tree.leaves(ref_grads))
    for path, g in zip(paths, grads):
        want = _get(ref_grads, path)
        assert g.shape == want.shape, path
        if not np.any(want):
            assert not torch.any(g), path
        else:
            assert rel_err(g.numpy(), want) <= GRAD_TOL, path


def test_moe_aux_is_summed_over_layers(pairs):
    """The repaired ``_layer`` hands the MoE layer's aux loss back: the
    port's summed aux is the reference's (nonzero), and it enters the loss
    as ce + 0.01 * aux / n_layers."""
    entry = pairs["qwen2-moe-a2.7b"]
    _, ref_metrics, _ = entry["ref"]
    cfg = entry["cfg"]
    params = params_from_numpy(entry["np_params"], cfg, "cpu")
    inputs, targets = entry["batch"]
    with torch.no_grad():
        loss, metrics = transformer.loss_fn(
            params, torch.from_numpy(inputs), torch.from_numpy(targets), cfg)
    assert ref_metrics["aux"] > 0
    assert abs(float(metrics["aux"]) - ref_metrics["aux"]) \
        <= LOSS_TOL * ref_metrics["aux"]
    assert torch.allclose(loss, metrics["ce"]
                          + 0.01 * metrics["aux"] / cfg.n_layers)


@pytest.mark.parametrize("chunk", [1, 5, 8, 32, 100])
def test_chunked_ce_equals_unchunked(chunk):
    """Any chunk (the largest divisor of S at most ``chunk``) gives the
    unchunked mean CE and the reference's chunked value, and its gradient
    w.r.t. the hidden states and the head equals the unchunked one's."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 50)) / 5).astype(np.float32)
    t = rng.integers(0, 50, (B, S)).astype(np.int32)
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_ce_loss(wt, ht, torch.from_numpy(t), chunk=chunk)
    g_got = torch.autograd.grad(got, (ht, wt))
    hp, wp = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    plain = F.cross_entropy((hp @ wp).reshape(-1, 50),
                            torch.from_numpy(t).long().reshape(-1))
    g_plain = torch.autograd.grad(plain, (hp, wp))
    ref = float(ref_layers.chunked_ce_loss(jnp.asarray(w), jnp.asarray(h),
                                           jnp.asarray(t), chunk=chunk))
    assert abs(float(got) - float(plain)) <= 1e-6 * float(plain)
    assert abs(float(got) - ref) <= 1e-6 * ref
    for a, b in zip(g_got, g_plain):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5


def test_remat_settings_give_identical_gradients(pairs):
    """remat off, remat with policy "nothing" (each layer recomputed) and
    with "dots" (matmul outputs kept): the same loss and bitwise the same
    gradients on the CPU."""
    entry = pairs["qwen3-1.7b"]
    runs = [_port_grads(entry, entry["cfg"].with_(remat=remat,
                                                  remat_policy=policy))
            for remat, policy in ((False, "nothing"), (True, "nothing"),
                                  (True, "dots"))]
    for loss, _, grads, _ in runs[1:]:
        assert torch.equal(loss.detach(), runs[0][0].detach())
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


def test_loss_of_each_family():
    """``build_model`` gives the transformer family (dense, MoE, VLM,
    encoder) a loss; the hybrid and RWKV have none yet."""
    for arch in ARCHS:
        assert build_model(get_smoke_config(arch)).loss is not None
    for arch in ("zamba2-2.7b", "rwkv6-3b"):
        assert build_model(get_smoke_config(arch)).loss is None


@pytest.mark.parametrize("fmt", [None, "int8", "w4a16"])
def test_score_nll_matches_reference(pairs, fmt):
    """``score_nll`` of the fp32 qwen3 smoke model (its untied head
    quantized too) on fp, int8 and W4A16 weights (the reference's quantized
    params, converted) equals the reference's within 1e-5 relative."""
    entry = pairs["qwen3-1.7b"]
    ref_cfg = ref_get_smoke_config("qwen3-1.7b").with_(**FP32)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = entry["cfg"]
    params = params_from_numpy(entry["np_params"], cfg, "cpu")
    if fmt is not None:
        ref_params = ref_quantize_params(ref_params, ref_cfg, fmt)
        params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   cfg, "cpu")
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    want = ref_score_nll(ref_model, ref_params, jnp.asarray(tokens))
    got = score_nll(entry["model"], params, torch.from_numpy(tokens))
    assert abs(got - want) <= 1e-5 * want
    if fmt is not None:      # the port's own quantizer gives the same codes
        again = score_nll(entry["model"],
                          quantize_params(params_from_numpy(
                              entry["np_params"], cfg, "cpu"), cfg, fmt),
                          torch.from_numpy(tokens))
        assert again == got
