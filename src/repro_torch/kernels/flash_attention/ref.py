"""Plain PyTorch versions of the flash-attention kernel (its oracles): dense
GQA attention in fp32, the reference's ``attention_ref``, and the same with
the tensor-core kernel's rounding of the probabilities; the device-start
entry's ``attention_at_ref`` (a chunk at a start tensor over the whole
cache); the rows' log-sum-exp that the forward writes for the backward,
and the backward itself step by step (``attention_bwd_ref``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
BK = 256           # keys a tile of the plain versions' sums


def _acc(t: torch.Tensor) -> torch.dtype:
    """The accumulation type: fp32, or fp64 for fp64 operands (an fp32
    kernel's result held to the same arithmetic carried in fp64)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, causal: bool, shift=None) -> torch.Tensor:
    """fp32 (fp64 for fp64 operands) scores ``[B, Sq, Hkv, G, Sk]`` scaled
    by 1/sqrt(D), the causal future at NEG_INF: key ``j`` is visible to
    query ``i`` when ``j <= i + shift``, ``shift`` an int or a 0-dim
    tensor (None: ``Sk - Sq``, aligned bottom-right)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    acc = _acc(q)
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).to(acc)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(acc)) / math.sqrt(D)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None] + (Sk - Sq if shift is None
                                                 else shift)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    return s


def _attend(q, s, v) -> torch.Tensor:
    """softmax(s) v over masked scores ``s`` ``[B, Sq, Hkv, G, Sk]``, summed
    over tiles of ``BK`` keys, as a kernel sweeps them: the row max, then
    each tile's exp(s - max) sum and P V product in order, a last short
    tile padded with zero probabilities. Every sum runs over a whole tile
    and masked keys add exact zeros, so the output is the same bitwise
    whatever number of masked keys (or zero tiles) follows the visible
    ones."""
    Sk = s.shape[-1]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    v = v.to(p.dtype)
    l = o = 0.0
    for t in range(0, Sk, BK):
        pt, vt = p[..., t:t + BK], v[:, t:t + BK]
        if pt.shape[-1] < BK:
            pad = BK - pt.shape[-1]
            pt, vt = F.pad(pt, (0, pad)), F.pad(vt, (0, 0, 0, 0, 0, pad))
        l = l + pt.sum(dim=-1, keepdim=True)
        o = o + torch.einsum("bqhgk,bkhd->bqhgd", pt, vt)
    return (o / l).reshape(q.shape).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Hkv,D]`` -> ``[B,Sq,Hq,D]``. The
    causal mask is aligned bottom-right: key ``j`` is visible to query
    ``i`` when ``j <= i + (Sk - Sq)``."""
    return _attend(q, _scores(q, k, causal), v)


def attention_at_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     start: torch.Tensor) -> torch.Tensor:
    """The device-start entry's plain version: a chunk q ``[B,Sq,Hq,D]``
    at positions ``[start, start + Sq)`` attending causally over the whole
    cache k/v ``[B,Smax,Hkv,D]`` (key ``j`` visible to query ``i`` when
    ``j <= start + i``); ``start`` a one-element tensor, never read on the
    host. The keys past the chunk are masked, not sliced off: their
    probabilities are exact zeros and ``_attend``'s sums do not depend on
    how many there are, so the output is bitwise ``attention_ref`` on
    ``k[:, :start + Sq]``."""
    return _attend(q, _scores(q, k, True, start.reshape(())), v)


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


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True
            ) -> torch.Tensor:
    """Each row's natural log-sum-exp of the scaled, masked scores, fp32
    ``[B, Hq, Sq]``: what the forward writes for the backward."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)    # [B,Sq,Hkv,G]
    return lse.reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of ``attention_ref`` step by step in fp32, as the
    backward kernel computes them: P = exp(S - lse) from the forward's
    log-sum-exp (``[B, Hq, Sq]``), delta = rowsum(dO * O) from its output,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - delta), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D); the GQA sum over a kv head's G query heads is
    taken inside the products. For bf16 / fp16 inputs P and dS are rounded
    to the input type before their products (the tensor-core kernel's
    operands); in fp32 the rounding is the identity. fp64 operands carry
    the same arithmetic in fp64. Each gradient in its input's type."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    acc = _acc(q)
    rnd = lambda t: t.to(q.dtype).to(acc)                    # noqa: E731
    s = _scores(q, k, causal)                                # [B,Sq,Hkv,G,Sk]
    lse_g = lse.to(acc).permute(0, 2, 1).reshape(B, Sq, Hkv, G)[..., None]
    p = torch.exp(s - lse_g)
    qg = q.reshape(B, Sq, Hkv, G, D).to(acc)
    dog = do.reshape(B, Sq, Hkv, G, D).to(acc)
    delta = (dog * o.reshape(B, Sq, Hkv, G, D).to(acc)).sum(-1, keepdim=True)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", rnd(p), dog)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v.to(acc))
    ds = rnd(p * (dp - delta))
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
