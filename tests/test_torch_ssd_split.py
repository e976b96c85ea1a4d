"""The SSD chunk kernel's own arithmetic, on the CPU.

``csrc/ssd_chunk.cu`` computes C.B^T once per batch and forms every product
on the tensor cores in split fp32: each fp32 operand becomes hi = tf32(x)
and lo = tf32(x - hi), and the product is hi.hi + hi.lo + lo.hi in fp32.
``ssd_chunk_split_ref`` is the plain version of that arithmetic (TF32
rounding emulated bit for bit). Here it is held to the reference's
``ssd_chunk_pallas`` in interpret mode and to the JAX oracle within the
contract's 1e-4: over ``CONFORMANCE_CASES`` (L the case's M) in every dtype
row, at the smoke model's hd = N = 16, and at nh > 1 with B_ and C_ column
slices of a wider tensor, as the model passes them. One pass of TF32 (the lo
terms dropped) must miss 1e-4, so that the check has teeth. The card holds
the kernel to this arithmetic and to ``ssd_chunk_ref`` (chip_smoke.py).
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CONFORMANCE_CASES, CONFORMANCE_DTYPES, rel_err
from repro.kernels.ssm_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssm_scan.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (split_mm, ssd_chunk_ref,
                                              ssd_chunk_split_ref, tf32)

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


def _chunk_inputs(seed, L, nh=2, hd=64, N=64, dtype="float32", state=True,
                  conv_dim=None):
    """fp32 numpy operands of one chunk step, rounded through ``dtype``;
    with ``conv_dim``, B_ and C_ are views of the last 2N columns of one
    wider [2, L, conv_dim] array."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))

    xb = r(2, L, nh, hd, scale=0.5)
    if conv_dim is None:
        B_, C_ = r(2, L, N, scale=0.5), r(2, L, N, scale=0.5)
    else:
        wide = r(2, L, conv_dim, scale=0.5)
        B_ = wide[..., conv_dim - 2 * N:conv_dim - N]
        C_ = wide[..., conv_dim - N:]
    seg = -np.cumsum(np.abs(r(2, L, nh)) * 0.1, axis=1).astype(np.float32)
    S_prev = r(2, nh, hd, N, scale=0.3) if state else \
        np.zeros((2, nh, hd, N), np.float32)
    return xb, B_, C_, seg, S_prev


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _err(port, ref) -> float:
    return max(rel_err(p.numpy(), np.asarray(r)) for p, r in zip(port, ref))


def _against_both(arrays, lo=True):
    """(rel_err vs the Pallas kernel in interpret mode, vs the oracle) of
    ``ssd_chunk_split_ref`` on ``arrays``."""
    jx = [jnp.asarray(np.ascontiguousarray(a)) for a in arrays]
    port = ssd_chunk_split_ref(*_torch(arrays), lo=lo)
    return (_err(port, ssd_chunk_pallas(*jx, interpret=True)),
            _err(port, jax_oracle(*jx)))


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES,
                         ids=[c.name for c in CONFORMANCE_CASES])
def test_split_arithmetic_on_conformance_grid(case, dtype):
    """L = the case's M; S_prev zero in the fp32 row, random in the rest."""
    arrays = _chunk_inputs(case.M + CONFORMANCE_DTYPES.index(dtype), case.M,
                           dtype=dtype, state=dtype != "float32")
    e_kernel, e_oracle = _against_both(arrays)
    assert e_kernel <= SSD_TOL and e_oracle <= SSD_TOL, (e_kernel, e_oracle)


@pytest.mark.parametrize("L", [32, 13, 1])
def test_split_arithmetic_at_the_smoke_models_width(L):
    """hd = N = 16, eight heads: the zamba2 smoke model's chunk."""
    arrays = _chunk_inputs(50 + L, L, nh=8, hd=16, N=16)
    e_kernel, e_oracle = _against_both(arrays)
    assert e_kernel <= SSD_TOL and e_oracle <= SSD_TOL, (e_kernel, e_oracle)


@pytest.mark.parametrize("L", [88, 128])
def test_split_arithmetic_with_strided_projections(L):
    """Four heads, B_ and C_ sliced out of one wider array (a view each on
    the port's side, as the model's conv split hands them over)."""
    arrays = _chunk_inputs(60 + L, L, nh=4, hd=32, N=32, conv_dim=200)
    xb, B_, C_, seg, S_prev = arrays
    tB, tC = torch.from_numpy(B_), torch.from_numpy(C_)     # views
    assert not tB.is_contiguous() and tB.stride(1) == tC.stride(1) == 200
    port = ssd_chunk_split_ref(*_torch([xb]), tB, tC, *_torch([seg, S_prev]))
    jx = [jnp.asarray(np.ascontiguousarray(a)) for a in arrays]
    assert _err(port, ssd_chunk_pallas(*jx, interpret=True)) <= SSD_TOL
    assert _err(port, jax_oracle(*jx)) <= SSD_TOL


def test_one_pass_of_tf32_misses_the_contract():
    """The lo terms carry the accuracy: without them (one TF32 product
    each) the step misses 1e-4 on these inputs, with them it holds."""
    errs = []
    for L in (88, 256):
        arrays = _chunk_inputs(70 + L, L)
        errs.append((_against_both(arrays, lo=False)[1],
                     _against_both(arrays)[1]))
    assert max(one for one, _ in errs) > SSD_TOL, errs
    assert max(split for _, split in errs) <= SSD_TOL, errs


# ------------------------------------------------------------ the rounding --

def test_tf32_rounds_to_nearest_with_ties_away():
    """10 stored mantissa bits: the ulp at 1 is 2^-10; a tie (2^-11) goes
    away from zero, less than a tie goes down, in either sign."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -12,
                      -(1 + 2 ** -11), -(1 + 2 ** -12), 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -10,
                         -(1 + 2 ** -10), -1.0, 0.0])
    assert torch.equal(tf32(x), want)
    g = torch.Generator().manual_seed(0)
    bits = tf32(torch.randn(1000, generator=g)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0


def test_split_keeps_fp32_accuracy():
    """hi + lo recovers x to about 2^-22 of |x|; split_mm is within a few
    fp32 roundings of the fp64 product, one pass only within TF32's."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    hi = tf32(a)
    lo = tf32(a - hi)
    assert float(((hi + lo) - a).abs().max() / a.abs().max()) < 2 ** -21
    exact = (a.double() @ b.double()).float()
    assert rel_err(split_mm("ik,kj->ij", a, b).numpy(), exact.numpy()) < 1e-6
    assert rel_err(split_mm("ik,kj->ij", a, b, lo=False).numpy(),
                   exact.numpy()) > 1e-4


def test_the_wrapper_keeps_the_reference_plain_version():
    """On CPU tensors the wrapper runs ``ssd_chunk_ref``, not the kernel's
    arithmetic: the two agree within the contract, not bit for bit."""
    th = _torch(_chunk_inputs(9, 77))
    y, s = ops.ssd_chunk(*th)
    y_ref, s_ref = ssd_chunk_ref(*th)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    y_split, s_split = ssd_chunk_split_ref(*th)
    assert _err((y_split, s_split), (y_ref.numpy(), s_ref.numpy())) <= SSD_TOL
