"""The int8 weight GEMM's tensor-core order and operand rules, on the CPU.

For bf16 / fp16 activations ``csrc/quant_matmul.cu`` multiplies x by the
int8 codes converted exactly to x's type on the tensor cores, accumulates in
fp32 over the plan's split of K (partials summed in split order) and applies
the per-column scale once, after the sum. ``quant_matmul_colscale_ref`` is
the plain version of that order; here it is held to the reference's
``quant_matmul_pallas`` in interpret mode over ``CONFORMANCE_CASES`` under
the production padding, at split 1, the plan's and the largest split K
allows. The card holds the kernel to it (chip_smoke.py). The codes reach the
kernel through TMA: ``int8_operand`` takes the weight strategy's column
slice of a padded code tensor as a view and refuses what TMA cannot read,
and the quantized path's own operands, recorded at llama3-8b's full width on
meta tensors, meet it. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL,
                      pad_to, rel_err)
from repro.kernels.hetero_matmul import ops as ref_ops
from repro.kernels.hetero_matmul.kernel import quant_matmul_pallas
from repro_torch.configs import dtype_of, get_config
from repro_torch.core import partition
from repro_torch.core.engine import build_plan
from repro_torch.core.partition import HeteroCtx, QuantWeight, _pad_to
from repro_torch.core.profiler import model_weight_shapes
from repro_torch.kernels.hetero_matmul import ops
from repro_torch.kernels.hetero_matmul.ref import (quant_matmul_colscale_ref,
                                                   quant_matmul_ref)

ALIGN = 128


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
    """x and the codes of the padded weight, for both frameworks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((case.M, case.K)).astype(np.float32)
    w = rng.standard_normal((case.K, case.N)).astype(np.float32)
    wp = np.array(pad_to(pad_to(jnp.asarray(w), ALIGN, 0), ALIGN, 1))
    rq, rs = ref_ops.quantize_weight(jnp.asarray(wp))
    pq, ps = ops.quantize_weight(torch.from_numpy(wp))
    assert pq.numpy().tobytes() == np.asarray(rq).tobytes()
    jx = pad_to(pad_to(jnp.asarray(x).astype(dtype), ALIGN, 0), ALIGN, 1)
    tx = _pad_to(_pad_to(torch.from_numpy(x).to(dtype_of(dtype)), ALIGN, 0),
                 ALIGN, 1)
    return (jx, rq, rs), (tx, pq, ps)


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=lambda c: c.name)
def test_colscale_order_matches_pallas(case, dtype):
    """x . code in fp32 over each split of K, summed in split order, then
    times the scale, then the cast: equal to ``quant_matmul_pallas``'s
    x . (code . s) within DTYPE_TOL at every split the kernel may take."""
    i = [c.name for c in CONFORMANCE_CASES].index(case.name)
    (jx, rq, rs), (tx, pq, ps) = _operands(case, dtype, 500 + i)
    want = np.asarray(quant_matmul_pallas(jx, rq, rs, interpret=True),
                      np.float32)[:case.M, :case.N]
    M, K = tx.shape
    _, _, plan_split = ops.gemm_plan(M, pq.shape[1], K)
    for split in sorted({1, plan_split, ops.gemm_splits(K)[-1]}):
        y = quant_matmul_colscale_ref(tx, pq, ps, split=split)
        assert y.dtype == tx.dtype
        err = rel_err(y[:case.M, :case.N].float().numpy(), want)
        assert err <= DTYPE_TOL[dtype], (split, err)


@pytest.mark.parametrize("split", [1, 2, 4])
def test_colscale_order_close_to_plain_version(split):
    """In fp32 the kernel's order and the plain version's (the scale in the
    weight) differ only by rounding."""
    rng = np.random.default_rng(split)
    x = torch.from_numpy(rng.standard_normal((128, 512)).astype(np.float32))
    wq, s = ops.quantize_weight(torch.from_numpy(
        rng.standard_normal((512, 256)).astype(np.float32)))
    a = quant_matmul_colscale_ref(x, wq, s, split=split)
    b = quant_matmul_ref(x, wq, s)
    assert rel_err(a.numpy(), b.numpy()) <= DTYPE_TOL["float32"]


# ------------------------------------------------------------- wrappers --

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_wrapper_on_cpu_takes_the_plain_version_at_any_plan(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(
        np.float32)).to(dtype_of(dtype))
    wq, s = ops.quantize_weight(torch.from_numpy(
        rng.standard_normal((512, 384)).astype(np.float32)))
    before = ops.mxu_quant_matmul.launches
    for plan in (None, (128, 128, 1), (128, 64, 2), (128, 128, 2)):
        y = ops.mxu_quant_matmul(x, wq, s, plan=plan)
        assert torch.equal(y, quant_matmul_ref(x, wq, s))
    assert ops.mxu_quant_matmul.launches == before


def test_wrapper_refuses_plans_it_cannot_run():
    x = torch.zeros((128, 256), dtype=torch.bfloat16)
    wq, s = torch.zeros((256, 384), dtype=torch.int8), torch.ones(384)
    with pytest.raises(ValueError):
        ops.mxu_quant_matmul(x, wq, s, plan=(128, 128, 3))     # N % 128
    with pytest.raises(ValueError):
        ops.mxu_quant_matmul(x, wq, s, plan=(128, 64, 8))      # 4 k-steps
    with pytest.raises(ValueError):
        ops.mxu_quant_matmul(x.float(), wq, s, plan=(128, 64, 1))


def test_int8_operand_takes_column_slices_as_views():
    """The weight strategy's slice wq[:, :n] of padded codes keeps its
    parent's leading dimension and base: no copy."""
    wq = torch.zeros((4096, 14336), dtype=torch.int8)
    view = QuantWeight(wq, torch.ones(14336), "int8", 4096).slice_n(0, 8960)
    padded = _pad_to(_pad_to(view.wq, ALIGN, 0), ALIGN, 1)
    assert padded.data_ptr() == wq.data_ptr()
    assert ops.int8_operand(padded) == 14336
    assert ops.int8_operand(wq[:, 1024:2048]) == 14336
    layers = torch.zeros((2, 256, 384), dtype=torch.int8)
    assert ops.int8_operand(layers[1][:, 128:]) == 384


@pytest.mark.parametrize("bad", ["base", "ld", "transposed"])
def test_int8_operand_refuses_what_tma_cannot_read(bad):
    if bad == "base":             # a column slice 8 bytes into its row
        t = torch.zeros((128, 272), dtype=torch.int8)[:, 8:136]
    elif bad == "ld":             # rows 136 bytes apart
        t = torch.zeros((128, 136), dtype=torch.int8)[:, :128]
    else:
        t = torch.zeros((128, 256), dtype=torch.int8).T
    with pytest.raises(ValueError):
        ops.int8_operand(t)


def test_quantized_path_operands_meet_the_rules():
    """Every int8 launch llama3-8b's fast-sync int8 plan makes at the
    batcher's and the engine's chunk lengths, recorded on meta tensors at
    full width: x passes TMA's rules, the codes ``int8_operand``, column
    splits land on multiples of 128, and the plan fits the shape."""
    cfg = get_config("llama3-8b")
    _, plan = build_plan(cfg, sync_mode="fast", weight_quant="int8")
    ctx = HeteroCtx(mode="hetero-tensor", plan=plan)
    seen = []

    def record(x, wq, scale, **kw):
        seen.append((x, wq, scale))
        return torch.empty((x.shape[0], wq.shape[1]), dtype=x.dtype,
                           device="meta")

    inner = partition.mxu_quant_matmul
    partition.mxu_quant_matmul = record
    try:
        for site, (K, N) in model_weight_shapes(cfg).items():
            wq = torch.empty((2, K, N), dtype=torch.int8, device="meta")[1]
            qw = QuantWeight(wq, torch.empty((N,), device="meta"), "int8", K)
            for M in (37, 44, 128, 193, 256):
                x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
                ctx.matmul(x, qw, name=site)
    finally:
        partition.mxu_quant_matmul = inner
    assert seen, "the int8 plan sends no site to the aligned path"
    for x, wq, scale in seen:
        ops.tma_operand(x)
        ld = ops.int8_operand(wq)
        assert wq.storage_offset() % 128 == 0 and ld % 128 == 0
        M, K = x.shape
        ops.check_plan(ops.gemm_plan(M, wq.shape[1], K), M, wq.shape[1], K)
