"""Plain PyTorch version of the decode-attention kernel (its oracle): the
reference's ``decode_attention_ref``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length) -> torch.Tensor:
    """q ``[B,Hq,D]``; caches ``[B,Smax,Hkv,D]``; ``length`` (an int or a
    one-element integer tensor) is the valid prefix. Returns ``[B,Hq,D]``."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(D)
    length = torch.as_tensor(length, device=q.device).reshape(())
    valid = torch.arange(S, device=q.device)[None, None, None, :] < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)
