"""Gradient compression for data-parallel reductions, the reference's
``repro.distributed.compression``: int8 symmetric quantization with a
per-tensor scale and error feedback (the quantization residual is carried
and added back next step, so compression accumulates no bias).

``compress_grads_with_feedback`` is what the trainer applies to every
gradient before a reduction; ``compressed_psum`` is the collective that
moves the int8 payload over a ``torch.distributed`` group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..training.tree import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x.float() / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_grads_with_feedback(grads: dict, error: dict
                                 ) -> tuple[dict, dict]:
    """(the int8-rounded gradients in their own types, the new fp32
    residuals)."""
    out = tree_map(_one, grads, error)
    return (tree_map(lambda t: t[0], out),
            tree_map(lambda t: t[1], out))


def _one(g: torch.Tensor, e: torch.Tensor):
    g32 = g.float() + e
    q, s = quantize_int8(g32)
    deq = dequantize_int8(q, s)
    return deq.to(g.dtype), g32 - deq


def init_error(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks through int8 codes: the
    ranks' amax is max-combined first and the scale widened by the group
    size, so the int32 sum of the codes stays in range; then dequantized to
    ``x``'s dtype. The reference's arithmetic, op for op."""
    n = float(dist.get_world_size(group))
    amax = x.abs().amax().float().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax > 0, amax / 127.0, 1.0) * n
    q = torch.clamp(torch.round(x.float() / scale * n), -127, 127
                    ).to(torch.int32)
    dist.all_reduce(q, group=group)
    return (q.float() * scale / n).to(x.dtype)
