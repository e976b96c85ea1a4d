"""Plain PyTorch versions of the decode-attention kernel: its oracle, the
reference's ``decode_attention_ref``, and the kernel's split arithmetic,
``decode_attention_split_ref`` (per-split partials, then their combine in
split order)."""
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


def decode_split_shares(length: int, n_split: int) -> list[tuple[int, int]]:
    """[start, stop) of each split's keys at ``length`` valid rows: equal
    shares of ceil(length / n_split), the last ones short or empty, as each
    block of the kernel takes its own."""
    share = -(-length // n_split)
    return [(min(i * share, length), min((i + 1) * share, length))
            for i in range(n_split)]


def split_partials(s: torch.Tensor, v: torch.Tensor, shares):
    """Per-split softmax partials of scores ``s`` ``[B,Hkv,G,S]`` (fp32)
    over values ``v`` ``[B,S,Hkv,D]``: (m, l, acc), stacked over the splits
    ``[n, B,Hkv,G]``, ``[n, B,Hkv,G]``, ``[n, B,Hkv,G,D]``. An empty share
    gives m = -inf, l = 0, acc = 0."""
    B, Hkv, G, _ = s.shape
    D = v.shape[-1]
    ms, ls, accs = [], [], []
    for a, b in shares:
        if b <= a:
            ms.append(s.new_full((B, Hkv, G), -math.inf))
            ls.append(s.new_zeros((B, Hkv, G)))
            accs.append(s.new_zeros((B, Hkv, G, D)))
            continue
        m = s[..., a:b].amax(dim=-1)
        p = torch.exp(s[..., a:b] - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, v[:, a:b].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m: torch.Tensor, l: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """The kernel's second pass: M = max m_i, L = sum l_i e^(m_i - M),
    o = sum acc_i e^(m_i - M) / L, summed in split order, 0 where L is 0."""
    M = m.amax(dim=0)
    L = torch.zeros_like(M)
    o = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        w = torch.where(l[i] == 0, torch.zeros_like(M),
                        torch.exp(m[i] - torch.where(torch.isinf(M), 0.0, M)))
        L = L + l[i] * w
        o = o + acc[i] * w[..., None]
    return torch.where(L[..., None] == 0, torch.zeros_like(o),
                       o / torch.where(L == 0, 1.0, L)[..., None])


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, length,
                               n_split: int) -> torch.Tensor:
    """The kernel's arithmetic: the valid prefix in ``n_split`` equal
    shares, each a softmax partial in fp32, combined in split order; rows
    with no valid key give 0 (the Pallas kernel's guard). ``length`` is an
    int or a one-element integer tensor, read on the host."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    n = min(max(int(torch.as_tensor(length).reshape(())), 0), S)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(D)
    o = combine_partials(*split_partials(s, v_cache,
                                         decode_split_shares(n, n_split)))
    return o.reshape(B, Hq, D).to(q.dtype)
