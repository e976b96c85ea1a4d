"""Plain PyTorch version of the flash-attention kernel (its oracle): dense
GQA attention in fp32, the reference's ``attention_ref``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Hkv,D]`` -> ``[B,Sq,Hq,D]``. The
    causal mask is aligned bottom-right: key ``j`` is visible to query
    ``i`` when ``j <= i + (Sk - Sq)``."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / math.sqrt(D)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None] + (Sk - Sq)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
