"""The port's weight quantizers and quantized aligned-path GEMMs
(repro_torch.kernels.hetero_matmul) against the reference, on the CPU.

Codes and scales must be the reference's byte for byte. On CPU tensors the
GEMM wrappers take their plain versions, so these tests hold the plain
versions, the wrappers' shape policy and HeteroCtx._mxu_quant's padding
against ``quant_matmul_pallas`` / ``q4_matmul_pallas`` in interpret mode;
the CUDA kernels are held against the same plain versions on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL,
                      pad_to, rel_err)
from repro.core.partition import HeteroCtx as RefHeteroCtx
from repro.core.partition import QuantWeight as RefQuantWeight
from repro.kernels.hetero_matmul import ops as ref_ops
from repro.kernels.hetero_matmul.kernel import (q4_matmul_pallas,
                                                quant_matmul_pallas)
from repro_torch.configs import dtype_of
from repro_torch.core.partition import HeteroCtx, QuantWeight, _pad_to
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.kernels.hetero_matmul.ref import (q4_matmul_ref,
                                                   quant_matmul_ref,
                                                   unpack_int4)

ALIGN = 128
FORMATS = {"int8": (ops.quantize_weight, ref_ops.quantize_weight),
           "w4a16": (ops.quantize_weight_int4, ref_ops.quantize_weight_int4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weight(K, N, seed=0):
    """Seeded weights with the quantizers' edge columns: all zero, a
    negative extreme (int4 takes amax/8), a negative extreme whose positive
    side would clip at amax/8 (int4 keeps amax/7), and exact half-steps."""
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = -np.abs(w[:, 1])
    w[0, 1] = -4.0
    w[:, 2] = 0.1
    w[0, 2], w[1, 2] = -0.8, 0.78          # pos = 0.975 * neg
    # exact half-steps: int8 scale 1.0 in column 3, int4 scale 1.0 in 4
    w[:, 3] = np.arange(K, dtype=np.float32) % 16 - 7.5
    w[0, 3] = 127.0
    w[:, 4] = np.arange(K, dtype=np.float32) % 8 - 3.5
    w[0, 4] = 7.0
    return w


def _codes(fmt, w_np, dtype="float32"):
    port, ref = FORMATS[fmt]
    pq, ps = port(torch.tensor(w_np).to(dtype_of(dtype)))
    rq, rs = ref(jnp.asarray(w_np).astype(dtype))
    return (pq, ps), (np.asarray(rq), np.asarray(rs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [95, 128, 97])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_codes_and_scales_byte_identical(fmt, K, dtype):
    (pq, ps), (rq, rs) = _codes(fmt, _weight(K, 192, seed=K), dtype)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert pq.numpy().tobytes() == rq.tobytes()
    assert ps.numpy().tobytes() == rs.tobytes()
    assert tuple(pq.shape) == rq.shape
    if fmt == "w4a16":
        assert pq.shape[0] == -(-K // 2)
        if K % 2:                     # the pad row dequantizes to exactly 0
            assert torch.all(unpack_int4(pq)[K] == 0)


def test_int4_scale_rule_edge_columns():
    """The asymmetric [-8, 7] range: a negative extreme maps to code -8
    exactly; a column whose positive side would clip keeps amax/7; an
    all-zero column gets scale 1.0."""
    w = _weight(64, 8)
    q, s = ops.quantize_weight_int4(torch.from_numpy(w))
    codes = unpack_int4(q)
    assert float(s[0]) == 1.0 and torch.all(codes[:, 0] == 0)
    assert float(s[1]) == np.float32(4.0) / np.float32(8.0)
    assert int(codes[0, 1]) == -8
    assert float(s[2]) == np.float32(0.8) / np.float32(7.0)


def test_dequant_int4_ref_matches_reference():
    (pq, ps), (rq, rs) = _codes("w4a16", _weight(95, 128, seed=2))
    ref = np.asarray(ref_ops.dequant_int4_ref(jnp.asarray(rq),
                                              jnp.asarray(rs), 95))
    np.testing.assert_array_equal(ops.dequant_int4_ref(pq, ps, 95).numpy(),
                                  ref)


def _operands(case, dtype, fmt, seed=0):
    """x in ``dtype`` and codes from the padded fp32 weight, for both."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((case.M, case.K)).astype(np.float32)
    w = rng.standard_normal((case.K, case.N)).astype(np.float32)
    wp = np.asarray(pad_to(pad_to(jnp.asarray(w), ALIGN, 0), ALIGN, 1))
    (pq, ps), (rq, rs) = _codes(fmt, wp)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(dtype_of(dtype))
    return jx, tx, (pq, ps), (jnp.asarray(rq), jnp.asarray(rs))


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_plain_matches_pallas(fmt, case, dtype):
    """Wrapper (plain version on the CPU) on the production pad policy vs
    ``quant_matmul_pallas`` / ``q4_matmul_pallas`` in interpret mode."""
    jx, tx, (pq, ps), (rq, rs) = _operands(case, dtype, fmt)
    jxp = pad_to(pad_to(jx, ALIGN, 0), ALIGN, 1)
    txp = _pad_to(_pad_to(tx, ALIGN, 0), ALIGN, 1)
    pallas = quant_matmul_pallas if fmt == "int8" else q4_matmul_pallas
    wrapper = ops.mxu_quant_matmul if fmt == "int8" else ops.mxu_q4_matmul
    ref = np.asarray(pallas(jxp, rq, rs, interpret=True)[:case.M, :case.N],
                     np.float32)
    y = wrapper(txp, pq, ps)[:case.M, :case.N]
    assert y.dtype == tx.dtype
    assert rel_err(y.float().numpy(), ref) <= DTYPE_TOL[dtype]


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_mxu_quant_padding_matches_reference(fmt, dtype):
    """HeteroCtx._mxu_quant on a ragged shape (M 77, odd K 95, N 320) and
    on column slices of the codes, vs the reference HeteroCtx._mxu."""
    rng = np.random.default_rng(5)
    M, K, N = 77, 95, 320
    x = rng.standard_normal((M, K)).astype(np.float32)
    (pq, ps), (rq, rs) = _codes(fmt, _weight(K, N, seed=5))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(dtype_of(dtype))
    rw = RefQuantWeight(jnp.asarray(rq), jnp.asarray(rs), fmt, K)
    tw = QuantWeight(pq, ps, fmt, K)
    for a, b in ((0, N), (0, 192), (192, N)):
        ref = RefHeteroCtx(mode="mxu", interpret=True)._mxu(
            jx, rw.slice_n(a, b))
        y = HeteroCtx(mode="mxu")._mxu(tx, tw.slice_n(a, b))
        assert tuple(y.shape) == (M, b - a)
        assert rel_err(y.float().numpy(), np.asarray(ref, np.float32)) \
            <= DTYPE_TOL[dtype]


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quant_weight_dequant_and_slice_match_reference(fmt):
    K, N = 95, 256
    (pq, ps), (rq, rs) = _codes(fmt, _weight(K, N, seed=3))
    tw = QuantWeight(pq, ps, fmt, K)
    rw = RefQuantWeight(jnp.asarray(rq), jnp.asarray(rs), fmt, K)
    assert tw.shape == rw.shape and tw.n == rw.n
    for dt in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            tw.dequant(dtype_of(dt)).float().numpy(),
            np.asarray(rw.dequant(jnp.dtype(dt)).astype(jnp.float32)))
    ts, rs_ = tw.slice_n(64, 200), rw.slice_n(64, 200)
    assert ts.shape == rs_.shape == (K, 136)
    assert ts.wq.data_ptr() == pq[:, 64:].data_ptr()          # a view
    np.testing.assert_array_equal(ts.dequant().numpy(),
                                  np.asarray(rs_.dequant()))
    # stacked layers index to per-layer views
    stacked = QuantWeight(torch.stack([pq, pq]), torch.stack([ps, 2 * ps]),
                          fmt, K)
    assert stacked.shape == (2, K, N)
    moved = stacked.to("cpu")
    assert moved.fmt == fmt and moved.k == K
    assert torch.equal(moved.wq, stacked.wq)
    np.testing.assert_array_equal(stacked[1].dequant().numpy(),
                                  2 * tw.dequant().numpy())


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 64, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32))
    for wrapper, quant, plain in (
            (ops.mxu_quant_matmul, ops.quantize_weight, quant_matmul_ref),
            (ops.mxu_q4_matmul, ops.quantize_weight_int4, q4_matmul_ref)):
        wq, s = quant(w)
        before = wrapper.launches
        y = wrapper(x, wq, s)
        assert wrapper.launches == before
        assert tuple(y.shape) == (2, 64, 384)
        assert torch.equal(y.reshape(128, 384), plain(x.reshape(128, 256),
                                                      wq, s))


@pytest.mark.parametrize("bad", ["misaligned", "codes_dtype", "scale_dtype",
                                 "scale_len", "contraction", "x_int"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_wrappers_reject_what_the_kernels_do_not_take(fmt, bad):
    wrapper = ops.mxu_quant_matmul if fmt == "int8" else ops.mxu_q4_matmul
    rows = 128 if fmt == "int8" else 64
    x = torch.zeros((128, 128))
    wq = torch.zeros((rows, 128), dtype=torch.int8)
    s = torch.ones(128)
    if bad == "misaligned":
        x = torch.zeros((100, 128))
    elif bad == "codes_dtype":
        wq = wq.float()
    elif bad == "scale_dtype":
        s = s.bfloat16()
    elif bad == "scale_len":
        s = torch.ones(256)
    elif bad == "contraction":
        wq = torch.zeros((2 * rows, 128), dtype=torch.int8)
    else:
        x = x.int()
    with pytest.raises((ValueError, TypeError)):
        wrapper(x, wq, s)


def test_quant_operands_row_major_with_leading_dimension():
    """The quantized kernels read x and the codes row-major with a leading
    dimension: a column slice of wider codes passes as a view, a transpose
    or a doubly strided view raises."""
    wq = torch.zeros((256, 512), dtype=torch.int8)
    assert ops._row_major_ld(wq) == 512
    assert ops._row_major_ld(wq[:, 128:384]) == 512
    for bad in (wq.T, wq[::2, ::2]):
        with pytest.raises(ValueError):
            ops._row_major_ld(bad)
