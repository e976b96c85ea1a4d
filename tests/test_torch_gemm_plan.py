"""The tensor-core GEMM's launch plan and TMA operand rules, on the CPU.

``gemm_plan`` picks the tile width and the split of K of the bf16 / fp16
output-stationary kernel (``csrc/hetero_matmul.cu``); ``tma_operand`` holds
an operand to TMA's rules (16-byte-aligned base and leading dimension); the
kernel itself is held to its plain version on the card by chip_smoke.py.
The path's own operands are recorded by running ``HeteroCtx`` on meta
tensors at full width (no memory), under llama3-8b's and zamba2-2.7b's
fast-sync plans, at the chunk lengths the engine and the batcher give.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import partition
from repro_torch.core.engine import build_plan
from repro_torch.core.partition import HeteroCtx
from repro_torch.core.profiler import model_weight_shapes
from repro_torch.kernels import build
from repro_torch.kernels.hetero_matmul import ops

N_SM = ops.H100_SMS

# (M, K, N) as the kernel sees them at the path's sites: llama3-8b's wk and
# wq/wo at the engine's 44-token chunk (padded to 128), wq at a 128-token
# chunk, w_gate and w_down at 256; zamba2-2.7b's exchanged sites at its
# 512-token chunk (the kernel's M is the weight's N)
PATH_SHAPES = {
    "llama3_wk_m44": (128, 4096, 128),
    "llama3_wq_m44": (128, 4096, 512),
    "llama3_wq_m128": (128, 4096, 2048),
    "llama3_wgate_m256": (256, 4096, 7168),
    "llama3_wdown_m256": (256, 14336, 2048),
    "zamba2_inproj_m512": (6528, 2560, 512),
    "zamba2_outproj_m512": (1536, 5120, 512),
    "zamba2_wgate_m512": (6400, 2560, 512),
    "zamba2_wdown_m512": (1536, 10240, 512),
    "zamba2_wq_m512": (2560, 2560, 512),
}


def _blocks(M, N, bn, split):
    return (M // ops.TILE_M) * (N // bn) * split


def _most_blocks(M, N, K):
    """The most blocks any tile width and allowed split gives."""
    return max(_blocks(M, N, bn, ops.gemm_splits(K)[-1])
               for bn in ops.TILE_NS if N % bn == 0)


def _check_plan(M, N, K, n_sm=N_SM):
    bm, bn, split = ops.gemm_plan(M, N, K, n_sm)
    steps = K // ops.TILE_K
    assert bm == ops.TILE_M and M % bm == 0
    assert bn in ops.TILE_NS and N % bn == 0
    # the split divides K into whole 64-deep steps, each split deep enough
    assert steps % split == 0
    assert split == 1 or steps // split >= ops.MIN_SPLIT_STEPS
    blocks = _blocks(M, N, bn, split)
    if _most_blocks(M, N, K) >= n_sm:
        assert blocks >= n_sm                       # the card is filled
        # ... with the least split any width needs for that
        assert all(_blocks(M, N, w, s) < n_sm
                   for w in ops.TILE_NS for s in ops.gemm_splits(K)
                   if s < split)
    else:
        assert blocks == _most_blocks(M, N, K)      # as far as K allows
    assert ops.check_plan((bm, bn, split), M, N, K) == (bm, bn, split)
    return bm, bn, split


@pytest.mark.parametrize("name", sorted(PATH_SHAPES))
def test_plan_at_path_shapes(name):
    M, K, N = PATH_SHAPES[name]
    _check_plan(M, N, K)


def test_thin_wk_block_is_split():
    """llama3's wk at the 44-token chunk is one 128 x 128 tile: the plan
    spreads it over more than one block (split of K and the narrow tile)."""
    M, K, N = PATH_SHAPES["llama3_wk_m44"]
    _, bn, split = ops.gemm_plan(M, N, K)
    assert _blocks(M, N, bn, split) > 1
    assert (bn, split) == (64, 16)


def test_wide_sites_fill_the_card_without_a_split():
    """Where the tiles alone fill 132 SMs the plan adds no fp32 partials."""
    for name in ("llama3_wgate_m256", "zamba2_inproj_m512",
                 "zamba2_wgate_m512"):
        M, K, N = PATH_SHAPES[name]
        assert ops.gemm_plan(M, N, K)[2] == 1, name


@pytest.mark.parametrize("seed", range(4))
def test_plan_seeded_sweep(seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(200):
        m, n, k = (int(v) for v in torch.randint(1, 96, (3,), generator=g))
        n_sm = (132, 114, 78, 16)[int(torch.randint(0, 4, (1,), generator=g))]
        _check_plan(128 * m, 128 * n, 128 * k, n_sm)


def test_plan_hypothesis_sweep():
    """The property sweep once drawn by hypothesis, now seeded so that it
    runs wherever numpy does: 600 draws over m 1-64, n 1-256, k 1-128 tiles
    and 132 / 114 / 78 SMs, plus the domain's corners."""
    rng = np.random.default_rng(2024)
    draws = zip(rng.integers(1, 65, 600), rng.integers(1, 257, 600),
                rng.integers(1, 129, 600), rng.choice([132, 114, 78], 600))
    corners = [(m, n, k, s) for m in (1, 64) for n in (1, 256)
               for k in (1, 128) for s in (132, 114, 78)]
    for m, n, k, n_sm in [*draws, *corners]:
        _check_plan(128 * int(m), 128 * int(n), 128 * int(k), int(n_sm))


@pytest.mark.parametrize("plan", [(64, 64, 1), (128, 96, 1), (128, 128, 3),
                                  (128, 128, 32), (128, 256, 1)])
def test_check_plan_rejects(plan):
    with pytest.raises(ValueError):
        ops.check_plan(plan, 256, 384, 4096)


def test_wrapper_plan_policy():
    """A plan is the tensor-core kernel's: refused for fp32 and the
    weight-stationary order; on CPU tensors it is validated and the plain
    version answers, with no launch counted."""
    x = torch.randn(128, 256).bfloat16()
    w = torch.randn(256, 384).bfloat16()
    before = ops.mxu_matmul.launches
    y = ops.mxu_matmul(x, w, plan=(128, 128, 1))
    assert ops.mxu_matmul.launches == before
    assert torch.equal(y, ops.matmul_ref(x, w))
    with pytest.raises(ValueError):
        ops.mxu_matmul(x, w, plan=(128, 128, 3))
    with pytest.raises(ValueError):
        ops.mxu_matmul(x, w, plan=(128, 128, 1), stationary="weight")
    with pytest.raises(ValueError):
        ops.mxu_matmul(x.float(), w.float(), plan=(128, 128, 1))


# ----------------------------------------------------------- TMA operands --

def test_tma_operand_accepts_slices_and_transposes():
    w = torch.zeros((256, 1024), dtype=torch.bfloat16)
    assert ops.tma_operand(w) == (1024, 0)
    assert ops.tma_operand(w[:, 128:640]) == (1024, 0)
    assert ops.tma_operand(w.T) == (1024, 1)
    assert ops.tma_operand(w[:, 384:].T) == (1024, 1)
    layers = torch.zeros((2, 128, 384), dtype=torch.float16)
    assert ops.tma_operand(layers[1][:, 256:]) == (384, 0)


@pytest.mark.parametrize("bad", ["base", "ld", "transposed_ld"])
def test_tma_operand_rejects_misalignment(bad):
    if bad == "base":           # a column slice 2 bytes into its row
        t = torch.zeros((128, 264), dtype=torch.bfloat16)[:, 1:129]
    elif bad == "ld":           # rows 260 bytes apart
        t = torch.zeros((128, 130), dtype=torch.bfloat16)[:, :128]
    else:                       # w.T of a weight with 260-byte rows
        t = torch.zeros((128, 130), dtype=torch.float16)[:, :128].T
    with pytest.raises(ValueError):
        ops.tma_operand(t)


def _record_operands(arch, ms):
    """(site, M, a, b) of every aligned-path launch HeteroCtx makes for
    ``arch``'s sites at token counts ``ms`` under its fast-sync plan, on
    meta tensors at full width; weights are layer 1 of a stacked pair, as
    the model passes them."""
    cfg = get_config(arch)
    _, plan = build_plan(cfg, sync_mode="fast")
    ctx = HeteroCtx(mode="hetero-tensor", plan=plan)
    seen = []

    def record(a, b, **kw):
        seen.append((site, M, a, b))
        return torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                           device="meta")

    inner = partition.mxu_matmul
    partition.mxu_matmul = record
    try:
        for site, (K, N) in model_weight_shapes(cfg).items():
            w = torch.empty((2, K, N), dtype=torch.bfloat16, device="meta")[1]
            for M in ms:
                x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
                ctx.matmul(x, w, name=site)
    finally:
        partition.mxu_matmul = inner
    return seen


@pytest.mark.parametrize("arch,ms", [
    ("llama3-8b", (37, 44, 128, 193, 256)),
    ("zamba2-2.7b", (88, 512)),
])
def test_path_operands_meet_tma_rules(arch, ms):
    """Every operand the path gives the kernel meets TMA's rules: leading
    dimensions 4096, 14336, 128256, 10448 or 2560 (and the padded
    activations' own), column splits at multiples of 128; and its plan is
    valid, filling the card where K allows."""
    seen = _record_operands(arch, ms)
    assert seen, "the plan sends no site to the aligned path"
    lds, exchanged = set(), 0
    for site, M, a, b in seen:
        for t in (a, b):
            ld, _ = ops.tma_operand(t)
            assert (ld * 2) % 16 == 0 and (t.storage_offset() * 2) % 16 == 0
            # a layer view or a column split lands on a multiple of 128
            assert t.storage_offset() % 128 == 0, (site, M, t.stride())
            lds.add(ld)
        exchanged += a.stride(0) == 1
        _check_plan(a.shape[0], b.shape[1], a.shape[1])
    weight_lds = {4096, 14336, 128256, 10448, 2560, 5120, 10240}
    assert lds & weight_lds
    assert all(ld in weight_lds or ld % 128 == 0 for ld in lds), lds
    if arch == "zamba2-2.7b":
        assert exchanged > 0            # zamba2 runs the exchanged form


# ------------------------------------------------------------------ build --

def test_stale_sees_every_shared_header(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, common, hopper = (csrc / "k.cu", csrc / "common.cuh",
                           csrc / "hopper.cuh")
    lib = tmp_path / "libk.so"
    for p in (src, common, hopper):
        p.write_text("//\n")
    assert build._stale("k", csrc, lib)            # not built yet
    lib.write_text("")
    for p, t in ((src, 100), (common, 100), (hopper, 100), (lib, 200)):
        os.utime(p, (t, t))
    assert not build._stale("k", csrc, lib)
    os.utime(hopper, (300, 300))                   # a new shared header
    assert build._stale("k", csrc, lib)
    os.utime(lib, (400, 400))
    (csrc / "later.cuh").write_text("//\n")        # one added later
    os.utime(csrc / "later.cuh", (500, 500))
    assert build._stale("k", csrc, lib)
