"""Plain PyTorch versions of the flash-attention kernel (its oracles): dense
GQA attention in fp32, the reference's ``attention_ref``, and the same with
the tensor-core kernel's rounding of the probabilities."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool) -> torch.Tensor:
    """fp32 scores ``[B, Sq, Hkv, G, Sk]`` scaled by 1/sqrt(D), the causal
    future (aligned bottom-right) at NEG_INF."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / math.sqrt(D)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None] + (Sk - Sq)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Hkv,D]`` -> ``[B,Sq,Hq,D]``. The
    causal mask is aligned bottom-right: key ``j`` is visible to query
    ``i`` when ``j <= i + (Sk - Sq)``."""
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def attention_rounded_p_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> torch.Tensor:
    """``attention_ref`` with the bf16 / fp16 kernel's rounding: the
    unnormalised probabilities exp(s - max) are rounded to q's type before
    the P V product on the tensor cores, and divided afterwards by their
    fp32 row sum. In fp32 it is ``attention_ref`` up to fp32 rounding."""
    s = _scores(q, k, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(q.dtype).float(), v.float())
    return (o / l).reshape(q.shape).to(q.dtype)
