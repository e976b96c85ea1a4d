"""Plain PyTorch version of the aligned-path GEMM (the kernel's oracle)."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """fp32 product, then a cast to ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), w.float()).to(out_dtype)
