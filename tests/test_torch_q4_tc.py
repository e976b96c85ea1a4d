"""The W4A16 GEMM's tensor-core order, nibble convert and operand rules, on
the CPU.

For bf16 / fp16 activations ``csrc/quant_matmul.cu`` runs the int8 kernel's
tensor-core body on packed int4 codes: each packed byte becomes two codes,
exact in x's type; the product accumulates in fp32 over the plan's split of
K (partials summed in split order) and the per-column scale is applied once,
after the sum. ``quant_matmul_colscale_ref`` on the unpacked codes is the
plain version of that order; here it is held to the reference's
``q4_matmul_pallas`` in interpret mode, under the production padding, at
every split ``gemm_splits`` allows. The converter's bit operations are
emulated in numpy over every byte value. The packed codes reach the kernel
through TMA: the quantized path's own operands, recorded at llama3-8b's full
width on meta tensors, meet ``int8_operand``'s rules as views. Inputs are
made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL,
                      KernelCase, pad_to, rel_err)
from repro.kernels.hetero_matmul import ops as ref_ops
from repro.kernels.hetero_matmul.kernel import q4_matmul_pallas
from repro_torch.configs import dtype_of, get_config
from repro_torch.core import partition
from repro_torch.core.engine import build_plan
from repro_torch.core.partition import HeteroCtx, QuantWeight, _pad_to
from repro_torch.core.profiler import model_weight_shapes
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.kernels.hetero_matmul.ref import (q4_matmul_ref,
                                                   quant_matmul_colscale_ref,
                                                   unpack_int4)

ALIGN = 128
# the conformance grid, and a K deep enough for the kernel to split (16
# k-steps: splits 1, 2 and 4)
CASES = CONFORMANCE_CASES + (KernelCase("deep_k", 128, 1024, 256),)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(case, dtype, seed):
    """x and the packed codes of the padded weight, for both frameworks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((case.M, case.K)).astype(np.float32)
    w = rng.standard_normal((case.K, case.N)).astype(np.float32)
    wp = np.array(pad_to(pad_to(jnp.asarray(w), ALIGN, 0), ALIGN, 1))
    rq, rs = ref_ops.quantize_weight_int4(jnp.asarray(wp))
    pq, ps = ops.quantize_weight_int4(torch.from_numpy(wp))
    assert pq.numpy().tobytes() == np.asarray(rq).tobytes()
    jx = pad_to(pad_to(jnp.asarray(x).astype(dtype), ALIGN, 0), ALIGN, 1)
    tx = _pad_to(_pad_to(torch.from_numpy(x).to(dtype_of(dtype)), ALIGN, 0),
                 ALIGN, 1)
    return (jx, rq, rs), (tx, pq, ps)


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_colscale_order_matches_pallas(case, dtype):
    """x . code in fp32 over each split of K, summed in split order, then
    times the scale, then the cast: equal to ``q4_matmul_pallas``'s
    x . (code . s) within DTYPE_TOL at every split the kernel may take."""
    i = [c.name for c in CASES].index(case.name)
    (jx, rq, rs), (tx, pq, ps) = _operands(case, dtype, 700 + i)
    want = np.asarray(q4_matmul_pallas(jx, rq, rs, interpret=True),
                      np.float32)[:case.M, :case.N]
    codes = unpack_int4(pq)
    for split in ops.gemm_splits(tx.shape[1]):
        y = quant_matmul_colscale_ref(tx, codes, ps, split=split)
        assert y.dtype == tx.dtype
        err = rel_err(y[:case.M, :case.N].float().numpy(), want)
        assert err <= DTYPE_TOL[dtype], (split, err)


def test_the_deep_case_splits():
    assert ops.gemm_splits(1024) == (1, 2, 4)


# ------------------------------------------------------------ the convert --

def _emulate(words: np.ndarray, fmt: str) -> np.ndarray:
    """The converter's bit operations on uint32 words of codes, as
    quant_matmul.cu writes them: int8, the byte ^ 0x80; int4, the low
    nibbles (w & 0x0F0F0F0F) ^ 0x08080808 and the high ones (w >> 4, the
    same); each offset byte permuted into the low mantissa bits of 2^23
    (0x4B000000), viewed as fp32, minus 2^23 + the offset. Returns the
    codes [rows, 4 * len(words)]: one row for int8, the low then the high
    nibbles' rows for int4."""
    def floats(u, bias):
        out = []
        for i in range(4):
            bits = np.uint32(0x4B000000) | ((u >> np.uint32(8 * i))
                                            & np.uint32(0xFF))
            out.append(bits.view(np.float32) - np.float32(8388608 + bias))
        return np.stack(out, axis=-1).reshape(-1)     # byte order
    if fmt == "int8":
        return floats(words ^ np.uint32(0x80808080), 128)[None]
    lo = (words & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    hi = ((words >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) \
        ^ np.uint32(0x08080808)
    return np.stack([floats(lo, 8), floats(hi, 8)])


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_nibble_convert_matches_unpack_int4(fmt):
    """Every byte value: the emulated convert gives the codes the plain
    versions read (int8: the byte itself; int4: ``unpack_int4``'s K rows
    2r and 2r + 1 of packed row r), exact in bf16 and fp16."""
    raw = np.arange(256, dtype=np.uint8)
    words = raw.view(np.uint32)
    got = _emulate(words, fmt)
    codes = torch.from_numpy(raw.view(np.int8).copy())[None]
    want = (codes if fmt == "int8" else unpack_int4(codes)).float().numpy()
    np.testing.assert_array_equal(got, want)
    for dt in (torch.bfloat16, torch.float16):
        t = torch.from_numpy(got)
        assert torch.equal(t.to(dt).float(), t)


# ------------------------------------------------------------- wrappers --

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_wrapper_on_cpu_takes_the_plain_version_at_any_plan(dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(
        np.float32)).to(dtype_of(dtype))
    wq4, s = ops.quantize_weight_int4(torch.from_numpy(
        rng.standard_normal((512, 384)).astype(np.float32)))
    before = ops.mxu_q4_matmul.launches
    for plan in (None, (128, 128, 1), (128, 64, 2), (128, 128, 2)):
        y = ops.mxu_q4_matmul(x, wq4, s, plan=plan)
        assert torch.equal(y, q4_matmul_ref(x, wq4, s))
    assert ops.mxu_q4_matmul.launches == before


def test_wrapper_refuses_plans_it_cannot_run():
    x = torch.zeros((128, 256), dtype=torch.bfloat16)
    wq4, s = torch.zeros((128, 384), dtype=torch.int8), torch.ones(384)
    with pytest.raises(ValueError):
        ops.mxu_q4_matmul(x, wq4, s, plan=(128, 128, 3))     # N % 128
    with pytest.raises(ValueError):
        ops.mxu_q4_matmul(x, wq4, s, plan=(128, 64, 8))      # 4 k-steps
    with pytest.raises(ValueError):
        ops.mxu_q4_matmul(x, wq4, s, plan=(64, 64, 1))       # BM
    with pytest.raises(ValueError):
        ops.mxu_q4_matmul(x.float(), wq4, s, plan=(128, 64, 1))


def test_quantized_path_operands_meet_the_rules():
    """Every W4A16 launch llama3-8b's fast-sync W4A16 plan makes at the
    batcher's and the engine's chunk lengths, recorded on meta tensors at
    full width: x passes TMA's rules, the packed codes ``int8_operand`` as
    views (column splits on multiples of 128), and the plan fits the
    shape."""
    cfg = get_config("llama3-8b")
    _, plan = build_plan(cfg, sync_mode="fast", weight_quant="w4a16")
    ctx = HeteroCtx(mode="hetero-tensor", plan=plan)
    seen = []

    def record(x, wq4, scale, **kw):
        seen.append((x, wq4, scale))
        return torch.empty((x.shape[0], wq4.shape[1]), dtype=x.dtype,
                           device="meta")

    inner = partition.mxu_q4_matmul
    partition.mxu_q4_matmul = record
    try:
        for site, (K, N) in model_weight_shapes(cfg).items():
            wq4 = torch.empty((2, K // 2, N), dtype=torch.int8,
                              device="meta")[1]
            qw = QuantWeight(wq4, torch.empty((N,), device="meta"), "w4a16",
                             K)
            for M in (37, 44, 128, 193, 256):
                x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
                ctx.matmul(x, qw, name=site)
    finally:
        partition.mxu_q4_matmul = inner
    assert seen, "the W4A16 plan sends no site to the aligned path"
    for x, wq4, scale in seen:
        ops.tma_operand(x)
        ld = ops.int8_operand(wq4)
        assert wq4.storage_offset() % 128 == 0 and ld % 128 == 0
        M, K = x.shape
        assert wq4.shape[0] * 2 == K
        ops.check_plan(ops.gemm_plan(M, wq4.shape[1], K), M, wq4.shape[1], K)
