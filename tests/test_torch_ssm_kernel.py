"""The port's SSD chunk step and scan against the reference's.

``ssd_chunk_ref`` (the plain version that the CUDA kernel is held to on the
card, and that ``ssd_chunk`` runs on CPU tensors) is compared with the JAX
package's Pallas kernel in interpret mode at two fp32 chunk lengths, and
with the JAX oracle over ``CONFORMANCE_CASES`` (L the case's M) in fp32,
bf16 and fp16 within the reference's 1e-4 rel_err (the inputs rounded
through the dtype and held in fp32, as tests/test_kernel_conformance.py
makes them). The port's ``ssd_chunked`` and ``ssd_scan`` are compared with
the reference's on sequences that are and are not a multiple of the chunk,
with and without an incoming state, within the max-abs 1e-4 of
tests/test_kernels.py. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CONFORMANCE_CASES, CONFORMANCE_DTYPES, rel_err
from repro.kernels.ssm_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssm_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssm_scan.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref
from repro_torch.models.mamba2 import ssd_chunked

SSD_TOL = 1e-4          # the reference's bound, every dtype row
jax_oracle = jax.jit(jax_ssd_chunk_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk_inputs(seed, L, nh=2, hd=64, N=64, dtype="float32", state=True):
    """fp32 numpy operands of one chunk step, rounded through ``dtype``."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32))

    xb = r(2, L, nh, hd, scale=0.5)
    B_, C_ = r(2, L, N, scale=0.5), r(2, L, N, scale=0.5)
    seg = -np.cumsum(np.abs(r(2, L, nh)) * 0.1, axis=1).astype(np.float32)
    S_prev = r(2, nh, hd, N, scale=0.3) if state else \
        np.zeros((2, nh, hd, N), np.float32)
    return xb, B_, C_, seg, S_prev


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _err(port, ref) -> float:
    return max(rel_err(p.numpy(), np.asarray(r)) for p, r in zip(port, ref))


@pytest.mark.parametrize("L", [77, 128])
def test_plain_chunk_matches_pallas_kernel_and_oracle(L):
    jx, th = _both(_chunk_inputs(L, L))
    port = ssd_chunk_ref(*th)
    assert _err(port, ssd_chunk_pallas(*jx, interpret=True)) <= SSD_TOL
    assert _err(port, jax_oracle(*jx)) <= SSD_TOL


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES,
                         ids=[c.name for c in CONFORMANCE_CASES])
def test_plain_chunk_matches_oracle_on_conformance_grid(case, dtype):
    """L = the case's M; S_prev zero in the fp32 row, random in the rest."""
    arrays = _chunk_inputs(case.M + CONFORMANCE_DTYPES.index(dtype), case.M,
                           dtype=dtype, state=dtype != "float32")
    jx, th = _both(arrays)
    assert _err(ssd_chunk_ref(*th), jax_oracle(*jx)) <= SSD_TOL


def test_plain_chunk_selects_away_the_upper_triangle():
    """A seg that falls steeply along the chunk makes exp(seg_i - seg_j)
    overflow to inf above the diagonal (exp(20 * (j - i))): the select keeps
    y finite, and equal to the oracle's."""
    arrays = list(_chunk_inputs(1, 16, nh=1, hd=16, N=16))
    arrays[3] = -np.cumsum(np.full((2, 16, 1), 20.0, np.float32), axis=1)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(arrays[3][0, 0] - arrays[3][0, -1])).all()
    jx, th = _both(arrays)
    y, s = ssd_chunk_ref(*th)
    assert torch.isfinite(y).all()
    assert rel_err(y.numpy(), np.asarray(jax_oracle(*jx)[0])) <= SSD_TOL


# ------------------------------------------------------------- the scans --

def _scan_inputs(seed, S, nh=4, hd=16, N=16, batch=2):
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((batch, S, nh, hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    B_ = (rng.standard_normal((batch, S, N)) * 0.5).astype(np.float32)
    C_ = (rng.standard_normal((batch, S, N)) * 0.5).astype(np.float32)
    state = (rng.standard_normal((batch, nh, hd, N)) * 0.3).astype(np.float32)
    return (xh, dt, A, B_, C_), state


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("S,chunk", [(77, 32), (13, 32), (100, 64), (1, 32)])
def test_ssd_chunked_matches_reference(S, chunk, with_state):
    """S not a multiple of the chunk (padded with dt = 0 steps), shorter
    than it, and one step; from a zero or an incoming state."""
    args, state = _scan_inputs(S + chunk, S)
    jx, th = _both(args)
    y_ref, s_ref = jax_ssd_chunked(
        *jx, chunk=chunk, ssm_state=jnp.asarray(state) if with_state
        else None)
    y, s = ssd_chunked(*th, chunk=chunk, ssm_state=torch.from_numpy(state)
                       if with_state else None)
    assert y.shape == y_ref.shape and s.shape == s_ref.shape
    assert float(np.abs(y.numpy() - np.asarray(y_ref)).max()) < 1e-4
    assert float(np.abs(s.numpy() - np.asarray(s_ref)).max()) < 1e-4


def test_ssd_scan_matches_the_pallas_scan():
    """Two chunks through the Pallas kernel (interpret) in a lax.scan, and
    through the port's host loop of ssd_chunk calls."""
    args, _ = _scan_inputs(5, 64)
    jx, th = _both(args)
    y_ref, s_ref = jax_ssd_scan(*jx, chunk=32)
    y, s = ops.ssd_scan(*th, chunk=32)
    assert float(np.abs(y.numpy() - np.asarray(y_ref)).max()) < 1e-4
    assert float(np.abs(s.numpy() - np.asarray(s_ref)).max()) < 1e-4
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_scan(*(t[:, :50] if t.ndim > 1 else t for t in th), chunk=32)


# ------------------------------------------------------------- the wrapper --

def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    _, th = _both(_chunk_inputs(2, 13, nh=2, hd=16, N=16))
    before = ops.ssd_chunk.launches
    y, s = ops.ssd_chunk(*th)
    y_ref, s_ref = ssd_chunk_ref(*th)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert y.dtype == s.dtype == torch.float32
    assert ops.ssd_chunk.launches == before      # nothing was launched


def test_wrapper_rejects_bad_operands():
    _, th = _both(_chunk_inputs(3, 8, nh=2, hd=16, N=16))
    xb, B_, C_, seg, S_prev = th
    bad_shapes = [
        (xb[0], B_, C_, seg, S_prev),                 # xb not 4-D
        (xb, B_, C_[:, :4], seg, S_prev),             # C_ unlike B_
        (xb, B_, C_, seg[..., :1], S_prev),           # seg heads
        (xb, B_, C_, seg, S_prev[..., :8]),           # state size
        (xb[:, :0], B_[:, :0], C_[:, :0], seg[:, :0], S_prev),  # empty
    ]
    for args in bad_shapes:
        with pytest.raises(ValueError):
            ops.ssd_chunk(*args)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_chunk(xb.bfloat16(), B_, C_, seg, S_prev)
    meta = [t.to("meta") for t in th]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_chunk(*meta)
