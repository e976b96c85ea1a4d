"""Plain PyTorch versions of the SSD chunk kernel: one Mamba2 chunk step in
fp32. ``ssd_chunk_ref`` is the reference's ``ssd_chunk_ref`` (the kernel's
oracle, and what the wrapper runs on CPU tensors); ``ssd_chunk_split_ref``
repeats the kernel's own arithmetic (split fp32 on TF32 products, C.B^T
once per batch) so that its accuracy can be checked off the card.

Given a chunk of dt-weighted inputs xb ``[B,L,nh,hd]``, the in/out
projections B_, C_ ``[B,L,N]``, the inclusive log-decay cumsum seg
``[B,L,nh]`` and the incoming state S_prev ``[B,nh,hd,N]``, it returns
(y ``[B,L,nh,hd]``, S_new ``[B,nh,hd,N]``). The decay exponent is clamped
to <= 0 before ``exp``, as the reference's ``ssd_chunked`` clamps it: exact
on the lower triangle (seg is a cumsum of log decays <= 0), and finite
above it, where ``exp(seg_i - seg_j)`` would overflow to inf and its
gradient, inf times the select's zero, would be NaN. The upper triangle is
then removed by a select. fp64 operands are computed in fp64, all others in
fp32.

``ssd_chunk_bwd_ref`` is the chunk step's gradient written out term by
term (not through autograd): the backward kernel's plain version and its
oracle on the card.
"""
from __future__ import annotations

import torch


def _wide(*ts):
    """The operands in fp64 if any is fp64, else in fp32."""
    dt = (torch.float64 if any(t.dtype == torch.float64 for t in ts)
          else torch.float32)
    return tuple(t.to(dt) for t in ts)


def _decay(seg):
    """exp(min(seg_i - seg_j, 0)) ``[B,L,L,nh]`` and the causal mask."""
    L = seg.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool, device=seg.device).tril()
    expo = torch.clamp(seg[:, :, None, :] - seg[:, None, :, :], max=0.0)
    return torch.exp(expo), tri[None, :, :, None]


def ssd_chunk_ref(xb, B_, C_, seg, S_prev):
    xb, B_, C_, seg, S_prev = _wide(xb, B_, C_, seg, S_prev)
    CB = torch.einsum("bin,bjn->bij", C_, B_)
    dec, tri = _decay(seg)                                      # [B,L,L,nh]
    att = CB[..., None] * torch.where(tri, dec, 0.0)
    y = torch.einsum("bijh,bjhp->bihp", att, xb)
    y = y + torch.einsum("bin,bhpn->bihp", C_, S_prev) * \
        torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    w_in = torch.exp(tot[:, None, :] - seg)
    S_new = (torch.exp(tot)[:, :, None, None] * S_prev
             + torch.einsum("bjhp,bjn,bjh->bhpn", xb, B_, w_in))
    return y, S_new


def ssd_chunk_bwd_ref(xb, B_, C_, seg, S_prev, dy, dS_new):
    """The gradient of :func:`ssd_chunk_ref` given dy ``[B,L,nh,hd]`` and
    dS_new ``[B,nh,hd,N]``: (dxb, dB_, dC_, dseg, dS_prev). Per (b, h),
    with M = C.B^T * dec on the causal triangle, w_j = exp(tot - seg_j)
    and tot = seg_{L-1}: dM = tril(dy xb^T); dxb = M^T dy + w * (B dS^T);
    dC and dB the sums over heads of (dM * dec) B and (dM * dec)^T C plus
    the state terms exp(seg) * (dy S_prev) and w * (xb dS); dS_prev =
    exp(tot) dS + (exp(seg) * dy)^T C; dseg the row sums minus the column
    sums of dM * M, plus the exp(seg), w and exp(tot) terms. Terms that
    cancel exactly are left out (the diagonal's in the row and column sums,
    key L - 1's w dw), so no output is a difference of equal terms."""
    xb, B_, C_, seg, S_prev, dy, dS = _wide(xb, B_, C_, seg, S_prev, dy,
                                            dS_new)
    CB = torch.einsum("bin,bjn->bij", C_, B_)
    dec, tri = _decay(seg)
    dec = torch.where(tri, dec, 0.0)
    M = CB[..., None] * dec                                     # [B,i,j,nh]
    dA = torch.einsum("bihp,bjhp->bijh", dy, xb) * dec          # dM * dec
    # dM * M below the diagonal: a diagonal entry's row and column terms
    # of dseg cancel, and are left out of both (as the kernel leaves them)
    strict = torch.ones(seg.shape[1], seg.shape[1], dtype=torch.bool,
                        device=seg.device).tril(-1)[None, :, :, None]
    dMM = torch.where(strict, dA * CB[..., None], 0.0)
    e_s = torch.exp(seg)                                        # [B,L,nh]
    tot = seg[:, -1, :]
    w = torch.exp(tot[:, None, :] - seg)
    BdS = torch.einsum("bjn,bhpn->bjhp", B_, dS)
    dxb = torch.einsum("bijh,bihp->bjhp", M, dy) + w[..., None] * BdS
    dC = (torch.einsum("bijh,bjn->bin", dA, B_)
          + torch.einsum("bih,bihp,bhpn->bin", e_s, dy, S_prev))
    dB = (torch.einsum("bijh,bin->bjn", dA, C_)
          + torch.einsum("bjh,bjhp,bhpn->bjn", w, xb, dS))
    dS_prev = (torch.exp(tot)[:, :, None, None] * dS
               + torch.einsum("bih,bihp,bin->bhpn", e_s, dy, C_))
    # w dw: key L - 1's (w = 1) goes to dseg_{L-1} with - and through dtot
    # with +: left out of both
    wdw = w * torch.einsum("bjhp,bjhp->bjh", xb, BdS)
    wdw = torch.cat([wdw[:, :-1], torch.zeros_like(wdw[:, -1:])], dim=1)
    dseg = (dMM.sum(2) - dMM.sum(1) - wdw
            + e_s * torch.einsum("bihp,bin,bhpn->bih", dy, C_, S_prev))
    dtot = wdw.sum(1) + torch.exp(tot) * (S_prev * dS).sum((2, 3))
    dseg = torch.cat([dseg[:, :-1], dseg[:, -1:] + dtot[:, None]], dim=1)
    return dxb, dB, dC, dseg, dS_prev


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
    CB = split_mm("bin,bjn->bij", C_, B_, lo=lo)
    dec, tri = _decay(seg)                                      # [B,L,L,nh]
    att = torch.where(tri, CB[..., None] * dec, 0.0)
    y = split_mm("bijh,bjhp->bihp", att, xb, lo=lo)
    y = y + split_mm("bin,bhpn->bihp", C_, S_prev, lo=lo) * \
        torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    xw = xb * torch.exp(tot[:, None, :] - seg)[..., None]
    S_new = (torch.exp(tot)[:, :, None, None] * S_prev
             + split_mm("bjhp,bjn->bhpn", xw, B_, lo=lo))
    return y, S_new
