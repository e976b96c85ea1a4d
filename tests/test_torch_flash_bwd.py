"""The flash-attention backward's plain version (``attention_bwd_ref``, what
the hand-written backward kernel computes) against torch autograd of
``attention_ref``, ``jax.grad`` of the reference's attention oracle
(``repro.kernels.flash_attention.ref``) and ``jax.grad`` of the reference's
``layers.blockwise_attention`` (what its training differentiates): GQA with
1 / 2 / 4 query heads per kv head, D = 16, 64, 80 (hubert) and 128, causal
with Sq == Sk and Sq < Sk (bottom-right), and bidirectional, fp32 within
DTYPE_TOL; the 16-bit rounding variant within bf16's; the log-sum-exp the
forward writes; and the wrapper's CPU routing. The kernel itself runs on
the card only (``chip_smoke.py`` phase H0)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DTYPE_TOL, rel_err
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models.layers import blockwise_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref, lse_ref)

MODES = {"causal": (True, 0), "causal_prefix": (True, 13),
         "bidirectional": (False, 0)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(G, D, mode, seed=0, B=2, Sq=16, Hkv=2):
    causal, extra = MODES[mode]
    Sk = Sq + extra
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hkv * G, D)).astype(np.float32)
    return q, k, v, do, causal


def _plain(q, k, v, do, causal, dtype=torch.float32):
    qt, kt, vt, dot = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o = attention_ref(qt, kt, vt, causal=causal)
    lse = lse_ref(qt, kt, causal=causal)
    return attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=causal)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_bwd_ref_matches_autograd_and_jax(G, D, mode):
    """dq, dk, dv of the plain backward against torch autograd of
    attention_ref, jax.grad of the reference's oracle, and jax.grad of
    the reference's blockwise_attention (bottom-right positions for the
    prefix case), each within fp32 DTYPE_TOL."""
    q, k, v, do, causal = _inputs(G, D, mode)
    got = _plain(q, k, v, do, causal)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    attention_ref(*leaves, causal=causal).backward(torch.from_numpy(do))
    want_torch = [t.grad for t in leaves]

    def oracle(q, k, v):
        return jnp.sum(jax_attention(q, k, v, causal=causal) * do)

    Sq, Sk = q.shape[1], k.shape[1]

    def blockwise(q, k, v):
        o = blockwise_attention(
            q, k, v, q_pos=jnp.arange(Sq, dtype=jnp.int32) + (Sk - Sq),
            kv_pos=jnp.arange(Sk, dtype=jnp.int32), causal=causal,
            block_k=16)
        return jnp.sum(o * do)

    def both(q, k, v):         # one compile for the two references
        return (jax.grad(oracle, argnums=(0, 1, 2))(q, k, v),
                jax.grad(blockwise, argnums=(0, 1, 2))(q, k, v))

    want_oracle, want_block = jax.jit(both)(q, k, v)
    tol = DTYPE_TOL["float32"]
    for name, g, wt, wo, wb in zip("qkv", got, want_torch, want_oracle,
                                   want_block):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert rel_err(g.numpy(), wt.numpy()) <= tol, name
        assert rel_err(g.numpy(), np.asarray(wo)) <= tol, name
        assert rel_err(g.numpy(), np.asarray(wb)) <= tol, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bwd_ref_16bit_rounds_p_and_ds(dtype, mode):
    """In 16 bits P and dS are rounded to the input type before their
    products: the gradients stay within the type's DTYPE_TOL of the fp32
    gradients of the same (rounded) inputs, come back in the input type,
    and differ from the unrounded arithmetic."""
    q, k, v, do, causal = _inputs(2, 64, mode, seed=1)
    rounded = [torch.from_numpy(a).to(dtype).float().numpy()
               for a in (q, k, v, do)]
    want = _plain(*rounded, causal)
    got = _plain(q, k, v, do, causal, dtype=dtype)
    dname = str(dtype).split(".")[-1]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert rel_err(g.float().numpy(), w.numpy()) <= DTYPE_TOL[dname]
    assert not all(torch.equal(g.float(), w.to(dtype).float())
                   for g, w in zip(got, want))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lse_ref_normalises_the_probabilities(mode):
    """exp(S - lse) sums to 1 over each row's visible keys, and lse is laid
    out [B, Hq, Sq] (query head h * G + g of kv head h)."""
    q, k, _, _, causal = _inputs(4, 16, mode, seed=2)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    lse = lse_ref(qt, kt, causal=causal)
    B, Sq, Hq, D = q.shape
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", qt,
                     kt.repeat_interleave(Hq // k.shape[2], dim=2))
    s = s / math.sqrt(D)
    if causal:
        Sk = k.shape[1]
        mask = (torch.arange(Sk)[None, :]
                <= torch.arange(Sq)[:, None] + (Sk - Sq))
        s = torch.where(mask, s, -1e30)
    assert torch.allclose(torch.exp(s - lse[..., None]).sum(-1),
                          torch.ones(B, Hq, Sq), atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrapper's gradient is torch autograd of the plain
    version and the backward wrapper is attention_bwd_ref; neither counts a
    launch. The backward wrapper checks its operands."""
    q, k, v, do, causal = _inputs(2, 16, "causal")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    o = ops.flash_attention(*leaves, causal=True)
    o.backward(torch.from_numpy(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = lse_ref(qt, kt, causal=True)
    got = ops.flash_attention_bwd(qt, kt, vt, o.detach(), lse, dot,
                                  causal=True)
    for g, t in zip(got, leaves):
        assert rel_err(g.numpy(), t.grad.numpy()) <= DTYPE_TOL["float32"]
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(qt, kt, vt, o.detach(), lse[:, :, :-1], dot,
                                causal=True)
    with pytest.raises(TypeError):
        ops.flash_attention_bwd(qt, kt, vt, o.detach(), lse.double(), dot,
                                causal=True)


@pytest.mark.parametrize("past", ["packed_rows", "keys"])
def test_bwd_wrapper_refuses_shapes_past_the_entrys_grid(past):
    """More than ``BWD_MAX_ROWS`` packed query rows (Sq * G) or keys raise
    in the wrapper, before any launch or plain computation, as the C entry
    would refuse them (cudaErrorInvalidValue). The operands are stride-0
    views: nothing of their size is allocated."""
    over = ops.BWD_MAX_ROWS + 1
    Sq, Sk, G = ((-(-over // 2), -(-over // 2), 2) if past == "packed_rows"
                 else (8, over, 1))
    D = 16

    def view(*shape, dtype=torch.float32):
        return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)

    q, do, o = (view(1, Sq, G, D) for _ in range(3))
    k, v = view(1, Sk, 1, D), view(1, Sk, 1, D)
    lse = view(1, G, Sq)
    before = ops.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="the backward takes at most"):
        ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert ops.flash_attention_bwd.launches == before

