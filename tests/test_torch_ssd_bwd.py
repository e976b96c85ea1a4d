"""The SSD chunk's gradient on the CPU.

``ssd_chunk_bwd_ref`` (the backward kernel's plain version, written out term
by term) is held to torch autograd of the clamped ``ssd_chunk_ref`` in fp64
over L in 1 / 17 / 88 / 256, nh in 1 / 3 / 80 and hd = N in 16 / 64, from a
zero and a random incoming state. The port's ``models/mamba2.ssd_chunked``
under autograd (the chunk loop of ``scan_chunks``, the state's gradient
carried back from chunk to chunk) is held to ``jax.vjp`` of the reference's
``ssd_chunked`` over (xh, dt, A, B_, C_, ssm_state), with several chunks, S
not a multiple of the chunk (the dt = 0 padding) and a non-zero initial
state, within rel_err 1e-4 a gradient. A seg that falls steeply enough that
the upper triangle's exponent overflows fp32 keeps every gradient finite
(the clamp before ``exp``). The kernel itself runs on the card only
(``chip_smoke.py`` phase H0). Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rel_err
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from repro_torch.models.mamba2 import ssd_chunked

F64_TOL = 1e-12      # the same sums in fp64, in other orders
GRAD_TOL = 1e-4      # rel_err a gradient, fp32 against the reference's
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
    """fp64 operands of one chunk, its dy and dS_new. ``steep``: seg falls
    20 a step, exp(seg_i - seg_j) above the diagonal up to e^{20 (L-1)}."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale)

    xb, B_, C_ = r(B, L, nh, d, scale=0.5), r(B, L, d, scale=0.5), \
        r(B, L, d, scale=0.5)
    step = torch.full((B, L, nh), 20.0, dtype=torch.float64) if steep \
        else r(B, L, nh).abs() * 0.1
    seg = -torch.cumsum(step, dim=1)
    S_prev = r(B, nh, d, d, scale=0.3) if state else \
        torch.zeros((B, nh, d, d), dtype=torch.float64)
    return [xb, B_, C_, seg, S_prev], r(B, L, nh, d), r(B, nh, d, d)


def _autograd(ins, dy, dS):
    leaves = [t.clone().requires_grad_() for t in ins]
    y, s = ssd_chunk_ref(*leaves)
    return torch.autograd.grad((y * dy).sum() + (s * dS).sum(), leaves)


GRID = [(L, nh, d) for L in (1, 17, 88) for nh in (1, 3, 80)
        for d in (16, 64)] + [(256, 1, 64), (256, 3, 16), (256, 80, 16)]


@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("L,nh,d", GRID)
def test_bwd_ref_matches_autograd_of_the_clamped_chunk(L, nh, d, state):
    """Every one of the five gradients equal to autograd's within fp64
    rounding, fp64 in and fp64 out."""
    ins, dy, dS = _chunk(L * 7 + nh + d, L, nh, d, state=state)
    want = _autograd(ins, dy, dS)
    got = ssd_chunk_bwd_ref(*ins, dy, dS)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        assert rel_err(a.numpy(), b.numpy()) <= F64_TOL, name


def test_bwd_ref_of_fp32_operands_is_fp32():
    ins, dy, dS = _chunk(1, 17, 3, 16)
    got = ssd_chunk_bwd_ref(*(t.float() for t in (*ins, dy, dS)))
    want = ssd_chunk_bwd_ref(*ins, dy, dS)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5, name


@pytest.mark.parametrize("L", [16, 88])
def test_gradient_finite_where_the_upper_exponent_overflows(L):
    """seg falling 20 a step puts exp(seg_i - seg_j) above the diagonal at
    up to e^{20 (L-1)}, far past fp32's e^88: unclamped, its gradient is inf
    times the select's zero, NaN in dseg. Clamped, every gradient of the
    fp32 chunk is finite, and the fp32 plain backward is the fp64 one's
    within 1e-5. (Autograd's dseg is not held to it here: under this decay
    its true value is ~e^-20, and autograd forms it as the difference of
    each diagonal entry's two equal terms, which the plain backward leaves
    out.)"""
    ins, dy, dS = _chunk(3, L, 2, 16, steep=True)
    ins32 = [t.float() for t in ins]
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp((ins32[3][0, 0] - ins32[3][0, -1]).numpy())
                        ).all()
    got = _autograd(ins32, dy.float(), dS.float())
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
    plain = ssd_chunk_bwd_ref(*ins32, dy.float(), dS.float())
    wide = ssd_chunk_bwd_ref(*ins, dy, dS)
    for name, a, b in zip(NAMES, plain, wide):
        assert torch.isfinite(a).all(), name
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5, name


# ------------------------------------------------------------- the scan --

def _scan_inputs(seed, S, nh=4, hd=16, N=16, batch=2):
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((batch, S, nh, hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    B_ = (rng.standard_normal((batch, S, N)) * 0.5).astype(np.float32)
    C_ = (rng.standard_normal((batch, S, N)) * 0.5).astype(np.float32)
    state = (rng.standard_normal((batch, nh, hd, N)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((batch, S, nh, hd)).astype(np.float32)
    ds = rng.standard_normal((batch, nh, hd, N)).astype(np.float32)
    return [xh, dt, A, B_, C_, state], dy, ds


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("S,chunk", [(77, 32), (96, 32), (100, 64), (13, 32)])
def test_ssd_chunked_grads_match_jax_vjp(S, chunk, with_state):
    """The gradients of (y, final state) with respect to xh, dt, A, B_, C_
    and the initial state: several chunks, S not a multiple of the chunk
    (dt = 0 padding) and shorter than it, from zero and from a carried
    state."""
    arrays, dy, ds = _scan_inputs(S + 3 * chunk, S)
    if not with_state:
        arrays[-1] = np.zeros_like(arrays[-1])

    def ref(xh, dt, A, B_, C_, state):
        return jax_ssd_chunked(xh, dt, A, B_, C_, chunk=chunk,
                               ssm_state=state)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, s = ssd_chunked(*leaves[:5], chunk=chunk, ssm_state=leaves[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(),
        leaves)
    for name, a, b in zip(("xh", "dt", "A", "B_", "C_", "state"), got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert rel_err(a.numpy(), np.asarray(b)) <= GRAD_TOL, name


# ------------------------------------------------------------- the wrapper --

def test_wrapper_takes_the_plain_backward_for_cpu_tensors():
    ins, dy, dS = _chunk(4, 13, 2, 16)
    ins, dy, dS = [t.float() for t in ins], dy.float(), dS.float()
    before = ops.ssd_chunk_bwd.launches
    got = ops.ssd_chunk_bwd(*ins, dy, dS)
    want = ssd_chunk_bwd_ref(*ins, dy, dS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.ssd_chunk_bwd.launches == before       # nothing was launched
    # the CPU forward's gradient is autograd of the plain version
    leaves = [t.clone().requires_grad_() for t in ins]
    y, s = ops.ssd_chunk(*leaves)
    grads = torch.autograd.grad((y * dy).sum() + (s * dS).sum(), leaves)
    for name, a, b in zip(NAMES, grads, want):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5, name


def test_wrapper_rejects_bad_gradients():
    ins, dy, dS = _chunk(5, 8, 2, 16)
    ins, dy, dS = [t.float() for t in ins], dy.float(), dS.float()
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_chunk_bwd(*ins, dy[:, :4], dS)
    with pytest.raises(ValueError, match="dS_new"):
        ops.ssd_chunk_bwd(*ins, dy, dS[..., :8])
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_chunk_bwd(*ins, dy.double(), dS)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_chunk_bwd(*(t.double() for t in ins), dy, dS)
