"""Wrappers of the aligned-path GEMMs (``csrc/hetero_matmul.cu``,
``csrc/quant_matmul.cu``) and the weight quantizers.

``mxu_matmul(x, w)`` is the port of ``repro.kernels.hetero_matmul.ops
.mxu_matmul``: ``[..., K] @ [K, N]`` with fp32 accumulation, all of M, K and
N multiples of 128. In bf16 / fp16 and the output-stationary order it runs
the tensor-core kernel on the launch plan of :func:`gemm_plan` (tile width
and split of K); its operands go through TMA, so they must pass
:func:`tma_operand`. ``mxu_quant_matmul(x, wq, scale)`` and
``mxu_q4_matmul(x, wq4, scale)`` are the weight-only quantized versions
(int8 codes ``[K, N]``, packed int4 codes ``[K/2, N]``, fp32 scale ``[N]``);
with bf16 / fp16 activations both run a tensor-core kernel on the same
launch plan, their codes through TMA under :func:`int8_operand`.
Each wrapper calls its ``repro_torch`` operator (``kernels/library.py``):
a CUDA tensor launches the kernel or raises; only tensors that lie on the
CPU take the plain version (``ref.py``); fake tensors get outputs of the
right shape, and the work of ``kernels/work.py``. Each wrapper's
``.launches`` counts its kernel's launches.

``quantize_weight`` / ``quantize_weight_int4`` give the reference's codes
and scales byte for byte (``repro.kernels.hetero_matmul.ops``).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable

import torch

from .. import work
from ..build import counted, entry
from ..library import kernel_op, routed
from .ref import matmul_ref, q4_matmul_ref, quant_matmul_ref, unpack_int4

ALIGN = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STATIONARY_CODE = {"output": 0, "weight": 1}
_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

# the tensor-core kernel's tiles: 128 rows, 64 or 128 columns, 64-deep k
# steps; a split of K takes at least MIN_SPLIT_STEPS of them
TILE_M, TILE_K = 128, 64
TILE_NS = (128, 64)
MIN_SPLIT_STEPS = 4
H100_SMS = 132


@lru_cache(maxsize=None)
def gemm_splits(K: int) -> tuple[int, ...]:
    """The splits of K the kernel may take, ascending: divisors of K's
    64-deep steps that leave each split at least ``MIN_SPLIT_STEPS`` steps
    (1 always)."""
    steps = K // TILE_K
    return tuple(s for s in range(1, steps + 1) if steps % s == 0
                 and (s == 1 or steps // s >= MIN_SPLIT_STEPS))


@lru_cache(maxsize=None)
def gemm_plan(M: int, N: int, K: int, n_sm: int = H100_SMS
              ) -> tuple[int, int, int]:
    """(BM, BN, split) of the tensor-core GEMM at an aligned shape. For each
    tile width, the smallest split whose blocks (tiles x split) fill the
    ``n_sm`` SMs; of the widths that fill them, the one with the smaller
    split (fewer fp32 partial bytes), the wider tile on a tie. Where no
    split K allows fills the card, the most blocks."""
    splits = gemm_splits(K)
    cands = []
    for bn in TILE_NS:
        tiles = (M // TILE_M) * (N // bn)
        split = next((s for s in splits if tiles * s >= n_sm), splits[-1])
        cands.append((bn, split, tiles * split))
    full = [c for c in cands if c[2] >= n_sm]
    bn, split, _ = (min(full, key=lambda c: c[1]) if full
                    else max(cands, key=lambda c: c[2]))
    return TILE_M, bn, split


def check_plan(plan, M: int, N: int, K: int) -> tuple[int, int, int]:
    """``plan`` as a (BM, BN, split) the kernel takes at (M, N, K), or
    ValueError."""
    bm, bn, split = plan
    if bm != TILE_M or bn not in TILE_NS or M % bm or N % bn \
            or split not in gemm_splits(K):
        raise ValueError(f"plan {tuple(plan)} does not fit ({M},{K},{N}): "
                         f"BM {TILE_M}, BN one of {TILE_NS} dividing N, "
                         f"split one of {gemm_splits(K)}")
    return bm, bn, split


@lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The SM count of CUDA device ``index`` (the plans' ``n_sm``)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, w: torch.Tensor, stationary: str) -> None:
    if stationary not in _STATIONARY_CODE:
        raise ValueError(f"stationary must be 'output' or 'weight', "
                         f"got {stationary!r}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    (M, K), (K2, N) = x.shape, w.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if M % ALIGN or K % ALIGN or N % ALIGN:
        raise ValueError(f"misaligned ({M},{K},{N}): every dim must be a "
                         f"multiple of {ALIGN}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"unsupported dtypes x={x.dtype}, w={w.dtype}: both "
                        "must be one of float32, bfloat16, float16")
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}")


def operand_layout(t: torch.Tensor) -> tuple[int, int]:
    """(leading dimension, trans) of a 2-D operand as the kernel reads it:
    row-major with leading dimension ``ld`` (trans 0), or the transpose of a
    row-major array (trans 1) — a column slice ``w[:, a:b]`` is the first,
    ``w.T`` the second. Raises for any other stride pattern."""
    R, C = t.shape
    s0, s1 = t.stride()
    if s1 == 1 and s0 >= C:
        return s0, 0
    if s0 == 1 and s1 >= R:
        return s1, 1
    raise ValueError(f"operand strides {t.stride()} for shape {tuple(t.shape)}"
                     " are neither row- nor column-major")


def tma_operand(t: torch.Tensor) -> tuple[int, int]:
    """:func:`operand_layout` of a 16-bit operand that the tensor-core
    kernel reads through TMA, which needs a 16-byte-aligned base and a
    leading dimension of a multiple of 16 bytes. Raises otherwise: the
    wrapper never copies an operand to make it fit."""
    ld, trans = operand_layout(t)
    if t.data_ptr() % 16 or (ld * t.element_size()) % 16:
        raise ValueError(f"operand at byte offset {t.data_ptr() % 16} mod 16"
                         f" with leading dimension {ld} ({t.dtype}): TMA "
                         "needs a 16-byte-aligned base and leading dimension")
    return ld, trans


def _launch(x: torch.Tensor, w: torch.Tensor, stationary: str,
            plan) -> torch.Tensor:
    launch = entry("hetero_matmul", "hetero_matmul",
                   *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 3,
                   *[ctypes.c_longlong] * 2, *[ctypes.c_int] * 6)
    M, K = x.shape
    N = w.shape[1]
    scratch, bn, split = None, 0, 0
    if stationary == "output" and x.dtype in _TENSOR_CORE_DTYPES:
        lda, trans_a = tma_operand(x)
        ldb, trans_b = tma_operand(w)
        _, bn, split = plan or gemm_plan(M, N, K, sm_count(x.device.index))
        if split > 1:
            scratch = torch.empty((split, M, N), dtype=torch.float32,
                                  device=x.device)
    else:
        lda, trans_a = operand_layout(x)
        ldb, trans_b = operand_layout(w)
        if stationary == "weight" and x.dtype != torch.float32:
            scratch = torch.empty((M, N), dtype=torch.float32,
                                  device=x.device)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch(x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(),
           scratch.data_ptr() if scratch is not None else None,
           M, N, K, lda, ldb, trans_a, trans_b, _DTYPE_CODE[x.dtype],
           _STATIONARY_CODE[stationary], bn, split)
    mxu_matmul.launches += 1
    return y


def _gemm_work(x, w, *args) -> tuple[int, int]:
    return work.gemm(x.shape[0], x.shape[1], w.shape[1], x.element_size())


_mxu_matmul = kernel_op(
    "mxu_matmul(Tensor x, Tensor w, str stationary, int[]? plan) -> Tensor",
    cpu=lambda x, w, stationary, plan: matmul_ref(x, w),
    cuda=_launch,
    fake=lambda x, w, stationary, plan: x.new_empty((x.shape[0],
                                                      w.shape[1])),
    work=_gemm_work)


def mxu_matmul(x: torch.Tensor, w: torch.Tensor, *,
               stationary: str = "output", plan=None) -> torch.Tensor:
    """``[..., K] @ [K, N]`` on the aligned path, output in ``x.dtype``.
    Shapes must be aligned; operands may be strided (see
    :func:`operand_layout`). ``plan`` overrides :func:`gemm_plan`'s
    (BM, BN, split) for the bf16 / fp16 output-stationary kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim != 2 else x
    _check(x2, w, stationary)
    if plan is not None:
        if stationary != "output" or x2.dtype not in _TENSOR_CORE_DTYPES:
            raise ValueError("a plan applies to the bf16 / fp16 "
                             "output-stationary kernel only")
        check_plan(plan, x2.shape[0], w.shape[1], x2.shape[1])
    if not routed(x2):
        raise ValueError(f"unsupported device {x2.device}")
    y = _mxu_matmul(x2, w, stationary, None if plan is None else list(plan))
    return y.reshape(*lead, w.shape[1])


counted(mxu_matmul)


# ------------------------------------------------------------ quantizers --

def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: codes ``[K, N]`` in [-127, 127],
    scale f32 ``[N]`` = amax / 127 (1.0 for an all-zero column)."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    wq = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return wq.to(torch.int8), scale


def quantize_weight_int4(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """W4A16: per-column symmetric int4 codes in [-8, 7], two per byte along
    K (rows 2r, 2r+1 -> low, high nibble); odd K is zero-padded first, so
    the pad row is code 0. A column whose extreme is negative, and whose
    largest positive still rounds inside +7 at the wider step
    (``pos < 0.9375 * neg``), takes scale amax / 8, else amax / 7."""
    w = w.float()
    K, N = w.shape
    if K % 2:
        w = torch.cat([w, w.new_zeros((1, N))], dim=0)
    pos = w.clamp(min=0.0).amax(dim=0)
    neg = (-w).clamp(min=0.0).amax(dim=0)
    amax = torch.maximum(pos, neg)
    scale = torch.where(pos < 0.9375 * neg, amax / 8.0, amax / 7.0)
    scale = torch.where(amax > 0, scale, 1.0)
    q = torch.clamp(torch.round(w / scale[None, :]), -8, 7).to(torch.int32)
    byte = (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)           # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8), scale


def dequant_int4_ref(wq4: torch.Tensor, scale: torch.Tensor,
                     k: int | None = None) -> torch.Tensor:
    """Unpack-and-dequantize oracle; ``k`` recovers an odd logical K."""
    q = unpack_int4(wq4).float()
    if k is not None:
        q = q[:k]
    return q * scale.float()[None, :]


# --------------------------------------------------- quantized GEMM wrappers --

def _check_quant(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 rows_per_k: int) -> None:
    """``rows_per_k`` is 1 for int8 codes, 2 for packed int4 (K/2 rows)."""
    if x.ndim != 2 or wq.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"expected x [M,K], codes 2-D, scale 1-D; got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x.shape
    N = wq.shape[1]
    if K % rows_per_k or wq.shape[0] != K // rows_per_k:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, codes "
                         f"{tuple(wq.shape)} ({rows_per_k} K rows per row)")
    if scale.shape[0] != N:
        raise ValueError(f"scale {tuple(scale.shape)} for {N} columns")
    if M % ALIGN or K % ALIGN or N % ALIGN:
        raise ValueError(f"misaligned ({M},{K},{N}): every dim must be a "
                         f"multiple of {ALIGN}")
    if x.dtype not in _DTYPE_CODE or wq.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"unsupported dtypes x={x.dtype}, codes={wq.dtype}, "
                        f"scale={scale.dtype}: x float32/bfloat16/float16, "
                        "codes int8, scale float32")
    if not (x.device == wq.device == scale.device):
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{wq.device}, {scale.device}")


def _row_major_ld(t: torch.Tensor) -> int:
    """Leading dimension of a row-major 2-D operand (a column slice keeps
    its parent's); the quantized kernels take no transposed operand."""
    ld, trans = operand_layout(t)
    if trans:
        raise ValueError(f"operand strides {t.stride()} for shape "
                         f"{tuple(t.shape)} are not row-major")
    return ld


def int8_operand(t: torch.Tensor) -> int:
    """Leading dimension of row-major int8 codes that the tensor-core kernel
    reads through TMA, which needs a 16-byte-aligned base and a leading
    dimension of a multiple of 16 bytes (a column slice ``wq[:, :n]`` of
    codes with such rows passes as a view). Raises otherwise: the wrapper
    never copies the codes to make them fit."""
    ld = _row_major_ld(t)
    if t.data_ptr() % 16 or ld % 16:
        raise ValueError(f"int8 codes at byte offset {t.data_ptr() % 16} mod "
                         f"16 with leading dimension {ld}: TMA needs a "
                         "16-byte-aligned base and leading dimension")
    return ld


def _launch_quant(symbol: str, counter, x: torch.Tensor, wq: torch.Tensor,
                  scale: torch.Tensor, plan) -> torch.Tensor:
    """One launch of ``csrc/quant_matmul.cu``'s ``symbol`` (int8 or packed
    int4 codes): bf16 / fp16 x runs the tensor-core kernel on ``plan`` (or
    :func:`gemm_plan`'s), its operands under TMA's rules; fp32 x the FMA
    body."""
    if scale.stride(0) != 1:
        raise ValueError(f"scale stride {scale.stride()} is not unit")
    launch = entry("quant_matmul", symbol, *[ctypes.c_void_p] * 5,
                   *[ctypes.c_int] * 3, *[ctypes.c_longlong] * 2,
                   *[ctypes.c_int] * 3)
    M, K = x.shape
    N = wq.shape[1]
    scratch, bn, split = None, 0, 0
    ldx = _row_major_ld(x)
    if x.dtype in _TENSOR_CORE_DTYPES:
        tma_operand(x)
        ldw = int8_operand(wq)
        _, bn, split = plan or gemm_plan(M, N, K, sm_count(x.device.index))
        if split > 1:
            scratch = torch.empty((split, M, N), dtype=torch.float32,
                                  device=x.device)
    else:
        ldw = _row_major_ld(wq)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch(x.device, x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
           y.data_ptr(), scratch.data_ptr() if scratch is not None else None,
           M, N, K, ldx, ldw, _DTYPE_CODE[x.dtype], bn, split)
    counter.launches += 1
    return y


def _quant_op(name: str, symbol: str, plain, w_bytes_per_el: float,
              counter: Callable):
    """The ``repro_torch::<name>`` operator of a quantized GEMM whose
    launches ``counter.launches`` counts."""
    return kernel_op(
        f"{name}(Tensor x, Tensor wq, Tensor scale, int[]? plan) -> Tensor",
        cpu=lambda x, wq, scale, plan: plain(x, wq, scale),
        cuda=lambda x, wq, scale, plan: _launch_quant(symbol, counter(), x,
                                                      wq, scale, plan),
        fake=lambda x, wq, scale, plan: x.new_empty((x.shape[0],
                                                     wq.shape[1])),
        work=lambda x, wq, scale, plan: work.quant_gemm(
            x.shape[0], x.shape[1], wq.shape[1], x.element_size(),
            w_bytes_per_el))


def _quant_dispatch(x, wq, scale, rows_per_k, op, plan):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim != 2 else x
    _check_quant(x2, wq, scale, rows_per_k)
    if not routed(x2):
        raise ValueError(f"unsupported device {x2.device}")
    y = op(x2, wq, scale, None if plan is None else list(plan))
    return y.reshape(*lead, wq.shape[1])


def _check_quant_plan(x: torch.Tensor, wq: torch.Tensor, plan) -> None:
    if plan is not None:
        if x.dtype not in _TENSOR_CORE_DTYPES:
            raise ValueError("a plan applies to bf16 / fp16 activations only")
        check_plan(plan, x.numel() // x.shape[-1], wq.shape[1], x.shape[-1])


_mxu_quant_matmul = _quant_op("mxu_quant_matmul", "quant_matmul_int8",
                              quant_matmul_ref, 1.0,
                              lambda: mxu_quant_matmul)
_mxu_q4_matmul = _quant_op("mxu_q4_matmul", "quant_matmul_q4",
                           q4_matmul_ref, 0.5, lambda: mxu_q4_matmul)


def mxu_quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     *, plan=None) -> torch.Tensor:
    """``[..., K] @ (wq * scale)`` on the aligned path: wq int8 ``[K, N]``
    (row-major, may be a column slice), scale f32 ``[N]``; output in
    ``x.dtype``. Shapes must be aligned. ``plan`` overrides
    :func:`gemm_plan`'s (BM, BN, split) for bf16 / fp16 ``x``."""
    _check_quant_plan(x, wq, plan)
    return _quant_dispatch(x, wq, scale, 1, _mxu_quant_matmul, plan)


def mxu_q4_matmul(x: torch.Tensor, wq4: torch.Tensor, scale: torch.Tensor,
                  *, plan=None) -> torch.Tensor:
    """The W4A16 version of :func:`mxu_quant_matmul`: ``wq4`` int8
    ``[K/2, N]`` holds two int4 codes per byte along K. bf16 / fp16 ``x``
    runs the same tensor-core kernel and plan, the packed codes through TMA
    under :func:`int8_operand`."""
    _check_quant_plan(x, wq4, plan)
    return _quant_dispatch(x, wq4, scale, 2, _mxu_q4_matmul, plan)


counted(mxu_quant_matmul)
counted(mxu_q4_matmul)
