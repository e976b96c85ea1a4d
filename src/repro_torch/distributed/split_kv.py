"""Split-KV decode attention over the mesh (flash-decoding across ranks),
the reference's ``repro.distributed.split_kv``.

The dense KV cache shards its SEQUENCE axis over the mesh's ``model`` axis
and its batch over ``data``; each rank holds its block, cut by
:func:`local_shard`. Per decode step:

  * the rank whose block holds the position writes the new K/V there; on
    every other rank the write changes nothing;
  * every rank attends over its own block;
  * the ranks' softmax partials combine with one max and two sums over the
    ``model`` group, of ``[B, Hkv, G]`` and ``[B, Hq, D]`` sizes.

Scores and sums accumulate in fp32 from the cache's own dtype, one block of
``_BLOCK`` keys at a time, so no fp32 copy of the cache is made. Plain
torch, as the reference's einsums are plain ``jnp``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .sharding import axis_rank, axis_size

NEG_INF = -1e30
_BLOCK = 512            # keys a block: the fp32 staging of one block only


def local_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a full ``[B, Smax, ...]`` tensor: the batch
    over the mesh's ``data`` axis, the sequence over ``model``. Raises when
    ``Smax`` is not a multiple of the ``model`` width (the trailing slots
    would never be attended over) or ``B`` of the ``data`` width."""
    n_model, n_data = axis_size(mesh, "model"), axis_size(mesh, "data")
    B, Smax = x.shape[:2]
    if Smax % n_model:
        raise ValueError(
            f"split-KV cache length Smax={Smax} is not divisible by the "
            f"model-axis size {n_model}: the trailing {Smax % n_model} "
            "slots would never be attended over and writes to them would "
            "be silently dropped. Pad Smax to a multiple of the shard count.")
    if B % n_data:
        raise ValueError(f"batch {B} is not divisible by the data-axis "
                         f"size {n_data}")
    b, s = B // n_data, Smax // n_model
    i, j = axis_rank(mesh, "data"), axis_rank(mesh, "model")
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def combine_split_softmax(s: torch.Tensor, v_local: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Softmax-weighted sum of the ranks' partials: a max of the local
    maxima, then sums of the numerator and the denominator over ``group``.

    ``s``: local masked scores [B, Hkv, G, K_local] fp32 (NEG_INF outside
    range); ``v_local``: local values [B, K_local, Hkv, D]. With
    ``group=None`` it is the local blockwise-stable softmax sum. The
    probabilities are rounded to the values' dtype before the product, as
    the reference's ``p.astype(v_local.dtype)``. Returns fp32
    [B, Hkv, G, D]."""
    m = s.amax(dim=-1)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    pv = p.to(v_local.dtype)
    K = v_local.shape[1]
    num = sum(torch.einsum("bhgk,bkhd->bhgd", pv[..., i:i + _BLOCK].float(),
                           v_local[:, i:i + _BLOCK].float())
              for i in range(0, K, _BLOCK))
    if group is not None:
        dist.all_reduce(den, group=group)
        dist.all_reduce(num, group=group)
    return num / torch.where(den == 0.0, 1.0, den)[..., None]


def split_kv_decode_update_attend(q, k_new, v_new, k_cache, v_cache, idx,
                                  mesh=None):
    """One decode step over this rank's block of a sequence-sharded cache.

    q, k_new, v_new: [B, 1, H*, D] (Hq for q, Hkv for K/V), this rank's
    batch; k_cache, v_cache: [B, Smax / n, Hkv, D], this rank's block
    (:func:`local_shard`), written IN PLACE; idx: the write slot (= the
    query position), an int or a one-element device tensor, never read on
    the host. ``mesh=None``: one shard holds the whole cache. Returns (out
    [B, 1, Hq, D] in q's dtype, k_cache, v_cache)."""
    group = None if mesh is None else mesh.get_group("model")
    B, _, Hq, D = q.shape
    Hkv = k_new.shape[2]
    chunk = k_cache.shape[1]
    start = 0 if mesh is None else axis_rank(mesh, "model") * chunk
    idx = torch.as_tensor(idx, device=q.device).reshape(()).long()
    pos = idx - start
    owner = (pos >= 0) & (pos < chunk)
    at = pos.clamp(0, chunk - 1).reshape(1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        kept = cache.index_select(1, at)
        cache.index_copy_(1, at, torch.where(owner, new.to(cache.dtype), kept))

    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.cat([torch.einsum("bhgd,bkhd->bhgk", qg,
                                k_cache[:, i:i + _BLOCK].float())
                   for i in range(0, chunk, _BLOCK)], dim=-1)
    s = s * (1.0 / math.sqrt(D))
    kv_pos = start + torch.arange(chunk, device=q.device)
    s = torch.where(kv_pos <= idx, s, NEG_INF)
    out = combine_split_softmax(s, v_cache, group)
    return out.reshape(B, 1, Hq, D).to(q.dtype), k_cache, v_cache
