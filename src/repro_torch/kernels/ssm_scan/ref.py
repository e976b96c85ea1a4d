"""Plain PyTorch versions of the SSD chunk kernel: one Mamba2 chunk step in
fp32. ``ssd_chunk_ref`` is the reference's ``ssd_chunk_ref`` (the kernel's
oracle, and what the wrapper runs on CPU tensors); ``ssd_chunk_split_ref``
repeats the kernel's own arithmetic (split fp32 on TF32 products, C.B^T
once per batch) so that its accuracy can be checked off the card.

Given a chunk of dt-weighted inputs xb ``[B,L,nh,hd]``, the in/out
projections B_, C_ ``[B,L,N]``, the inclusive log-decay cumsum seg
``[B,L,nh]`` and the incoming state S_prev ``[B,nh,hd,N]``, it returns
(y ``[B,L,nh,hd]``, S_new ``[B,nh,hd,N]``). The upper triangle of the decay
is removed by a select, never multiplied by 0: ``exp(seg_i - seg_j)`` may
be inf there.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(xb, B_, C_, seg, S_prev):
    xb, B_, C_, seg, S_prev = (t.float() for t in (xb, B_, C_, seg, S_prev))
    L = xb.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril()
    CB = torch.einsum("bin,bjn->bij", C_, B_)
    dec = torch.exp(seg[:, :, None, :] - seg[:, None, :, :])     # [B,L,L,nh]
    att = CB[..., None] * torch.where(tri[None, :, :, None], dec, 0.0)
    y = torch.einsum("bijh,bjhp->bihp", att, xb)
    y = y + torch.einsum("bin,bhpn->bihp", C_, S_prev) * \
        torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    w_in = torch.exp(tot[:, None, :] - seg)
    S_new = (torch.exp(tot)[:, :, None, None] * S_prev
             + torch.einsum("bjhp,bjn,bjh->bhpn", xb, B_, w_in))
    return y, S_new


def tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, the low 13 mantissa bits cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(eq: str, a: torch.Tensor, b: torch.Tensor, *,
             lo: bool = True) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernel forms it on the tensor cores: each
    fp32 operand split as hi = tf32(x), lo = tf32(x - hi), and the product
    hi.hi + hi.lo + lo.hi summed in fp32. ``lo=False`` keeps hi.hi alone:
    one pass of TF32."""
    ah, bh = tf32(a), tf32(b)
    y = torch.einsum(eq, ah, bh)
    if lo:
        y = y + torch.einsum(eq, ah, tf32(b - bh)) \
            + torch.einsum(eq, tf32(a - ah), bh)
    return y


def ssd_chunk_split_ref(xb, B_, C_, seg, S_prev, *, lo: bool = True):
    """``ssd_chunk_ref`` in the kernel's arithmetic: C.B^T once per batch
    and the three per-head products (att . xb, C . S_prev^T and
    (xb . w)^T B) each through :func:`split_mm`; the decay, the mask (a
    select) and the scalings in fp32. ``lo=False`` is one pass of TF32."""
    xb, B_, C_, seg, S_prev = (t.float() for t in (xb, B_, C_, seg, S_prev))
    L = xb.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril()
    CB = split_mm("bin,bjn->bij", C_, B_, lo=lo)
    dec = torch.exp(seg[:, :, None, :] - seg[:, None, :, :])     # [B,L,L,nh]
    att = torch.where(tri[None, :, :, None], CB[..., None] * dec, 0.0)
    y = split_mm("bijh,bjhp->bihp", att, xb, lo=lo)
    y = y + split_mm("bin,bhpn->bihp", C_, S_prev, lo=lo) * \
        torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    xw = xb * torch.exp(tot[:, None, :] - seg)[..., None]
    S_new = (torch.exp(tot)[:, :, None, None] * S_prev
             + split_mm("bjhp,bjn->bhpn", xw, B_, lo=lo))
    return y, S_new
