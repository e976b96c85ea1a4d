"""Plain PyTorch version of the SSD chunk kernel (its oracle): one Mamba2
chunk step in fp32, the reference's ``ssd_chunk_ref``.

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
