"""The SSD chunk backward kernel's own arithmetic, on the CPU.

The backward in ``csrc/ssd_chunk.cu`` (``ssd_bwd_tc``) forms every per-head
product on the tensor cores in split fp32, as the forward does: each fp32
operand becomes hi = tf32(x) and lo = tf32(x - hi), and the product is
hi.hi + hi.lo + lo.hi in fp32; dB_ and dC_ are taken per head and then
summed over the heads. ``ssd_chunk_bwd_split_ref`` is the plain version of
that arithmetic (TF32 rounding emulated bit for bit). Here it is held to
``ssd_chunk_bwd_ref`` carried in fp64 within the kernel's 1e-4 at L 1, 17,
88 and 256 with a few heads, hd = N = 64, S_prev zero and not, and decays
steep enough that the upper triangle's exponent overflows fp32; at the smoke
model's width, as the backward of the port's ``ssd_chunked``, to
``jax.vjp`` of the reference's ``ssd_chunked`` within 1e-4 a gradient; and
one pass of TF32 (the lo terms dropped) must miss 1e-4, so that the check
has teeth. The card holds the kernel to ``ssd_chunk_bwd_ref`` in fp64
(chip_smoke.py phase H0). Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (ssd_chunk_bwd_ref,
                                              ssd_chunk_bwd_split_ref)
from repro_torch.models.mamba2 import ssd_chunked

SSD_TOL = 1e-4       # the kernel's bound against the fp64 plain version
GRAD_TOL = 1e-4      # rel_err a gradient, against the reference's vjp
NAMES = ("dxb", "dB_", "dC_", "dseg", "dS_prev")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(seed, L, nh, d, *, state=True, steep=False, B=2):
    """fp32 operands of one chunk, its dy and dS_new. ``steep``: seg falls
    20 a step, exp(seg_i - seg_j) above the diagonal up to e^{20 (L-1)}."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    xb, B_, C_ = r(B, L, nh, d, scale=0.5), r(B, L, d, scale=0.5), \
        r(B, L, d, scale=0.5)
    step = torch.full((B, L, nh), 20.0) if steep else r(B, L, nh).abs() * 0.1
    seg = -torch.cumsum(step, dim=1)
    S_prev = r(B, nh, d, d, scale=0.3) if state else torch.zeros(B, nh, d, d)
    return [xb, B_, C_, seg, S_prev], r(B, L, nh, d), r(B, nh, d, d)


def _errs(ins, dy, dS, *, lo=True):
    """rel_err of each split-fp32 gradient against the plain version carried
    in fp64."""
    got = ssd_chunk_bwd_split_ref(*ins, dy, dS, lo=lo)
    want = ssd_chunk_bwd_ref(*(t.double() for t in (*ins, dy, dS)))
    for name, a in zip(NAMES, got):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
    return {name: rel_err(a.numpy(), b.numpy())
            for name, a, b in zip(NAMES, got, want)}


@pytest.mark.parametrize("steep", [False, True], ids=["gentle", "steep"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("L", [1, 17, 88, 256])
def test_split_backward_holds_the_fp64_plain_version(L, state, steep):
    """Three heads, hd = N = 64: every gradient within 1e-4 of
    ``ssd_chunk_bwd_ref`` in fp64, finite where the upper exponent
    overflows."""
    ins, dy, dS = _chunk(10 * L + 2 * state + steep, L, 3, 64, state=state,
                         steep=steep)
    errs = _errs(ins, dy, dS)
    assert max(errs.values()) <= SSD_TOL, errs


def test_one_pass_of_tf32_misses_the_contract():
    """The lo terms carry the accuracy: without them (one TF32 product
    each) the gradient misses 1e-4 on these inputs, with them it holds."""
    split, one = [], []
    for L in (88, 256):
        ins, dy, dS = _chunk(90 + L, L, 3, 64)
        split.append(max(_errs(ins, dy, dS).values()))
        one.append(max(_errs(ins, dy, dS, lo=False).values()))
    assert max(one) > SSD_TOL, one
    assert max(split) <= SSD_TOL, split


def _split_bwd(xb, B_, C_, seg, S_prev, dy, dS_new):
    return ssd_chunk_bwd_split_ref(xb, B_, C_, seg, S_prev, dy, dS_new)


@pytest.mark.parametrize("S,chunk", [(64, 32), (77, 32)])
def test_split_backward_through_ssd_chunked_matches_jax_vjp(monkeypatch, S,
                                                            chunk):
    """The port's ``ssd_chunked`` at the smoke model's width (four heads,
    hd = N = 16), its chunk backward replaced by the split-fp32 arithmetic:
    the gradients of (y, final state) with respect to xh, dt, A, B_, C_ and
    the initial state within 1e-4 of ``jax.vjp`` of the reference's
    ``ssd_chunked``, over several chunks from a carried state."""
    rng = np.random.default_rng(S + chunk)
    bt, nh, d = 2, 4, 16

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = [r(bt, S, nh, d, scale=0.5),
              np.log1p(np.exp(r(bt, S, nh))).astype(np.float32),
              -np.exp(r(nh, scale=0.5)).astype(np.float32),
              r(bt, S, d, scale=0.5), r(bt, S, d, scale=0.5),
              r(bt, nh, d, d, scale=0.3)]
    dy, ds = r(bt, S, nh, d), r(bt, nh, d, d)

    def ref(xh, dt, A, B_, C_, state):
        return jax_ssd_chunked(xh, dt, A, B_, C_, chunk=chunk,
                               ssm_state=state)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    calls = []
    monkeypatch.setattr(ops, "ssd_chunk_bwd",
                        lambda *a: calls.append(1) or _split_bwd(*a))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, s = ssd_chunked(*leaves[:5], chunk=chunk, ssm_state=leaves[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(),
        leaves)
    assert len(calls) == -(-S // chunk)
    for name, a, b in zip(("xh", "dt", "A", "B_", "C_", "state"), got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert rel_err(a.numpy(), np.asarray(b)) <= GRAD_TOL, name
