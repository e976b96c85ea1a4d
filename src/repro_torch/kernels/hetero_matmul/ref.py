"""Plain PyTorch versions of the aligned-path GEMMs (the kernels' oracles)."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """fp32 product, then a cast to ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def matmul_split_ref(x: torch.Tensor, w: torch.Tensor, split: int, *,
                     out_dtype=None) -> torch.Tensor:
    """The tensor-core kernel's split of K: ``split`` equal fp32 partial
    products over consecutive slices of K, summed in split order in fp32,
    then cast to ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    K = x.shape[-1]
    if K % split:
        raise ValueError(f"split {split} does not divide K = {K}")
    step = K // split
    acc = None
    for s in range(split):
        p = torch.matmul(x[..., s * step:(s + 1) * step].float(),
                         w[s * step:(s + 1) * step].float())
        acc = p if acc is None else acc + p
    return acc.to(out_dtype)


def quant_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     *, out_dtype=None) -> torch.Tensor:
    """Weight-only int8 product: wq int8 ``[K, N]``, scale f32 ``[N]``;
    ``x @ (code * scale)`` in fp32, cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    w = wq.float() * scale.float()[None, :]
    return torch.matmul(x.float(), w).to(out_dtype)


def quant_matmul_colscale_ref(x: torch.Tensor, wq: torch.Tensor,
                              scale: torch.Tensor, *, split: int = 1,
                              out_dtype=None) -> torch.Tensor:
    """The bf16 / fp16 int8 kernel's order: ``x @ code`` in fp32 (codes are
    exact in x's type, so no weight is rounded), over ``split`` equal slices
    of K summed in split order, then times the column scale once, then
    the cast to ``out_dtype`` (default ``x.dtype``)."""
    return (matmul_split_ref(x, wq, split, out_dtype=torch.float32)
            * scale.float()[None, :]).to(out_dtype or x.dtype)


def unpack_int4(wq4: torch.Tensor) -> torch.Tensor:
    """Packed int4 codes ``[K/2, N]`` -> int8 codes ``[K, N]``: packed row
    ``r`` holds K rows ``2r`` (low nibble) and ``2r + 1`` (high nibble),
    each sign-extended."""
    w = wq4.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8            # the low nibble, sign-extended
    hi = w >> 4                         # arithmetic shift of the byte
    K2, N = wq4.shape[-2], wq4.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(
        *wq4.shape[:-2], 2 * K2, N).to(torch.int8)


def q4_matmul_ref(x: torch.Tensor, wq4: torch.Tensor, scale: torch.Tensor,
                  *, out_dtype=None) -> torch.Tensor:
    """W4A16 product: unpack ``wq4`` (int8 ``[K/2, N]``), dequantize against
    ``scale`` (f32 ``[N]``), fp32 product, cast to ``out_dtype``."""
    return quant_matmul_ref(x, unpack_int4(wq4), scale, out_dtype=out_dtype)
