"""The port's aligned-path GEMM (repro_torch.kernels.hetero_matmul) against
the reference Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes its plain version, so these tests hold the
plain version, the wrapper's shape/stride policy and HeteroCtx's padding
and order exchange against ``matmul_pallas``; the CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL,
                      pad_to, rel_err)
from repro.core.partition import HeteroCtx as RefHeteroCtx
from repro.kernels.hetero_matmul.kernel import matmul_pallas
from repro_torch.configs import dtype_of
from repro_torch.core.partition import HeteroCtx, _pad_to
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.kernels.hetero_matmul.ref import matmul_ref

ALIGN = 128


def _operands(M, K, N, dtype, seed=0):
    """The same seeded inputs for both packages (cast from fp32 in each)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), np.float32)
    w = rng.standard_normal((K, N), np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tx = torch.from_numpy(x).to(dtype_of(dtype))
    tw = torch.from_numpy(w).to(dtype_of(dtype))
    return jx, jw, tx, tw


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("stationary", ["output", "weight"])
@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=lambda c: c.name)
def test_plain_matches_pallas(case, dtype, stationary):
    """Port (plain version behind the wrapper, production pad policy) vs
    ``matmul_pallas(..., interpret=True)`` within DTYPE_TOL."""
    jx, jw, tx, tw = _operands(case.M, case.K, case.N, dtype)
    jxp = pad_to(pad_to(jx, ALIGN, 0), ALIGN, 1)
    jwp = pad_to(pad_to(jw, ALIGN, 0), ALIGN, 1)
    ref = matmul_pallas(jxp, jwp, stationary=stationary,
                        interpret=True)[:case.M, :case.N]
    txp = _pad_to(_pad_to(tx, ALIGN, 0), ALIGN, 1)
    twp = _pad_to(_pad_to(tw, ALIGN, 0), ALIGN, 1)
    y = ops.mxu_matmul(txp, twp, stationary=stationary)[:case.M, :case.N]
    assert y.dtype == dtype_of(dtype)
    assert rel_err(_np(y), np.asarray(ref, np.float32)) <= DTYPE_TOL[dtype]


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
def test_exchanged_order_matches_pallas(dtype):
    """The NPU-2 order exchange y = (w^T @ x^T)^T, operands passed as
    transposed views of a column slice (as HeteroCtx passes them), vs the
    same exchange through ``matmul_pallas``."""
    M, K, N = 64, 96, 256
    jx, jw, tx, tw = _operands(M, K, 2 * N, dtype, seed=1)
    jxp = pad_to(pad_to(jx, ALIGN, 0), ALIGN, 1)
    jwp = pad_to(jw[:, :N], ALIGN, 0)
    ref = matmul_pallas(jwp.T, jxp.T, interpret=True).T[:M]
    txp = _pad_to(_pad_to(tx, ALIGN, 0), ALIGN, 1)
    twp = _pad_to(tw[:, :N], ALIGN, 0)
    y = ops.mxu_matmul(twp.T, txp.T).T[:M]
    assert rel_err(_np(y), np.asarray(ref, np.float32)) <= DTYPE_TOL[dtype]


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
def test_hetero_ctx_mxu_matches_reference(dtype):
    """HeteroCtx._mxu (stage padding, exchange predicate, slicing back),
    port vs reference on a ragged shape."""
    M, K, N = 77, 96, 192
    jx, jw, tx, tw = _operands(M, K, N, dtype, seed=3)
    ref = RefHeteroCtx(mode="mxu", interpret=True)._mxu(jx, jw)
    y = HeteroCtx(mode="mxu")._mxu(tx, tw)
    assert tuple(y.shape) == (M, N)
    assert rel_err(_np(y), np.asarray(ref, np.float32)) <= DTYPE_TOL[dtype]


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    _, _, tx, tw = _operands(128, 256, 384, "float32", seed=2)
    before = ops.mxu_matmul.launches
    y = ops.mxu_matmul(tx, tw)
    assert ops.mxu_matmul.launches == before
    assert torch.equal(y, matmul_ref(tx, tw))
    # leading dims flatten like the reference wrapper
    y3 = ops.mxu_matmul(tx.reshape(2, 64, 256), tw)
    assert tuple(y3.shape) == (2, 64, 384)
    assert torch.equal(y3.reshape(128, 384), y)


@pytest.mark.parametrize("bad", ["misaligned", "dtype_mismatch", "int",
                                 "stationary", "contraction"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((128, 128))
    w = torch.zeros((128, 128))
    kw = {}
    if bad == "misaligned":
        x = torch.zeros((100, 128))
    elif bad == "dtype_mismatch":
        w = w.bfloat16()
    elif bad == "int":
        x, w = x.int(), w.int()
    elif bad == "stationary":
        kw["stationary"] = "diagonal"
    else:
        w = torch.zeros((256, 128))
    with pytest.raises((ValueError, TypeError)):
        ops.mxu_matmul(x, w, **kw)


def test_operand_layout_strides():
    """Leading dimension + transpose flag, as the kernel reads operands:
    column slices and transposes pass as views, other strides raise."""
    w = torch.zeros((256, 512))
    assert ops.operand_layout(w) == (512, 0)
    assert ops.operand_layout(w[:, 128:384]) == (512, 0)
    assert ops.operand_layout(w.T) == (512, 1)
    assert ops.operand_layout(w[:, :256].T) == (512, 1)
    with pytest.raises(ValueError):
        ops.operand_layout(w[::2, ::2])
