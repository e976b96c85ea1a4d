"""Shared model layers (plain functions over parameter dicts).

Attention over the paged pool is blockwise with an online softmax in fp32,
written as plain torch ops (einsum, masking) the way ``repro.models.layers``
computes it. Attention over the dense cache goes through the flash- and
decode-attention kernels, but for per-slot indices (one position a lane,
``slot_attention``), which is plain torch too. Products that the
reference takes with ``preferred_element_type=float32`` are taken here on
fp32 copies of the operands, which gives the same exact products of
bf16/fp16 values.

Tensor parallelism (serving/layout.py): with ``tp_group`` given, the layer
holds its rank's column slices of every matrix and the config's local
head counts; :func:`tp_all_gather` reassembles a column-sharded activation
in rank order, so every output column is one rank's full-depth reduction
and the result is the single-device one bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import _disable_current_modes
import torch.distributed as dist
import torch.nn.functional as F

from ..configs import dtype_of
from ..core.partition import matmul_any
from ..distributed.sharding import (activation_sharding, active_plan,
                                    current_activation, split_kv_active,
                                    split_kv_mesh)
from ..distributed.split_kv import split_kv_decode_update_attend
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30
_POS_PAD = int(np.iinfo(np.int32).max)     # kv_pos of padded slots: masked


def tp_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate the ranks' slices of a column-sharded ``x`` along its
    last axis, in rank order within ``group``: the reference's tiled
    ``all_gather``. Issued at every group size, one included, so a
    one-rank group runs the same collectives as a wider one. The gather
    lands rank-major on axis 0 (the form gloo takes as well as NCCL) and is
    moved to the last axis by one copy."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view(n, *x.shape).movedim(0, -2).reshape(
        *x.shape[:-1], n * x.shape[-1])


def _out_proj(o, p, mm, tp_group):
    """``o @ wo`` of attention output ``o`` [B, S, H*D]: under tensor
    parallelism the local heads are gathered before the product and wo's
    output columns after it."""
    if tp_group is not None:
        o = tp_all_gather(o, tp_group)
    out = mm(o, p["wo"], name="wo")
    return out if tp_group is None else tp_all_gather(out, tp_group)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics; the scaled tensor stays in the compute dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def rope_freqs(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


_ROPE_TABLES: dict = {}


def rope_table(cfg, device) -> torch.Tensor:
    """The :func:`rope_freqs` table of ``cfg`` on ``device``, copied there
    once per process: a forward pass reads it without a host-to-device
    copy, which a decode loop with no host sync cannot afford."""
    key = (cfg.head_dim, cfg.rope_theta, torch.device(device))
    table = _ROPE_TABLES.get(key)
    if table is None:                   # made outside any mode: real, uncounted
        with _disable_current_modes():
            table = torch.from_numpy(rope_freqs(cfg.head_dim, cfg.rope_theta)
                                     ).to(device)
        _ROPE_TABLES[key] = table
    # under a fake-tensor trace (launch/dryrun.py) the real table's fake
    # twin: the cache holds real tensors only, and a trace reads it as a
    # real run does, dispatching nothing
    fake_mode = detect_fake_mode()
    return fake_mode.from_tensor(table) if fake_mode is not None else table


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [S] or [B, S]; freqs: [D/2] fp32, the
    :func:`rope_freqs` table on x's device (built once per forward pass by
    the caller, so no layer copies it to the device again)."""
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # [B, S, D/2]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(q, k, v, *, q_pos, kv_pos, causal: bool = True,
                        block_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks (GQA-aware), fp32 accumulation.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; q_pos: [Sq] or [B, Sq]
    absolute positions; kv_pos: [Sk]. Causal masking is positional
    (kv_pos <= q_pos), which also masks unwritten cache slots.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    if q_pos.ndim == 1:
        q_pos = q_pos[None, :].expand(B, Sq)

    block_k = min(block_k, Sk)
    pad = (block_k - Sk % block_k) % block_k
    if pad:                               # pad KV to a block multiple; padded
        k = F.pad(k, (0, 0, 0, 0, 0, pad))  # slots get kv_pos = INT_MAX
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=_POS_PAD)
        Sk += pad
    max_kv_pos = None if causal else kv_pos[-1 - pad]
    masked = causal or bool(pad)

    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=q.device)
    for i in range(Sk // block_k):
        sl = slice(i * block_k, (i + 1) * block_k)
        k_b, v_b, p_b = k[:, sl], v[:, sl], kv_pos[sl]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_b.float()) * scale
        if masked:
            if causal:
                mask = p_b[None, None, :] <= q_pos[:, :, None]      # [B,Sq,bk]
            else:  # bidirectional but padded: validity only
                mask = (p_b <= max_kv_pos)[None, None, :].expand(B, Sq, block_k)
            mask = mask[:, :, None, None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if masked:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v_b.dtype).float(), v_b.float())
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def dense_attention(q, k, v, *, q_pos, kv_pos, causal: bool = True) -> torch.Tensor:
    """Reference O(S^2)-memory attention (oracle for tests)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) / math.sqrt(D)
    if causal:
        if q_pos.ndim == 1:
            q_pos = q_pos[None, :].expand(B, Sq)
        mask = kv_pos[None, None, :] <= q_pos[:, :, None]
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------- attention --

def init_attention(cfg, generator: torch.Generator, device, n_layers: int) -> dict:
    """Stacked ``[L, ...]`` attention weights, ``[K, N]`` layout, drawn one
    layer at a time so the fp32 draw never exceeds one layer's size."""
    d, hd = cfg.d_model, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    p = {name: normal_stack(n_layers, shape, s, cfg.param_dtype, generator,
                            device)
         for name, shape in shapes.items()}
    if cfg.qk_norm:
        dt = dtype_of(cfg.param_dtype)
        p["q_norm"] = torch.ones((n_layers, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n_layers, hd), dtype=dt, device=device)
    return p


def normal_stack(n: int, shape, scale: float, dtype_name: str,
                 generator: torch.Generator, device) -> torch.Tensor:
    """``n`` stacked draws of ``N(0, 1) * scale``, cast to ``dtype_name``."""
    out = torch.empty((n, *shape), dtype=dtype_of(dtype_name), device=device)
    for i in range(n):
        out[i] = torch.randn(shape, generator=generator, device=device) * scale
    return out


def _qkv_rope(p: dict, x, cfg, positions, hetero_ctx, freqs):
    """Shared projection front-end: q/k/v matmuls, qk-norm, RoPE at the
    tokens' absolute positions."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    mm = hetero_ctx.matmul if hetero_ctx is not None else matmul_any
    q = mm(x, p["wq"], name="wq").reshape(B, S, cfg.n_heads, hd)
    k = mm(x, p["wk"], name="wk").reshape(B, S, cfg.n_kv_heads, hd)
    v = mm(x, p["wv"], name="wv").reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    return q, k, v, mm


def attention(p: dict, x, cfg, *, positions, cache: dict | None,
              cache_index, freqs, hetero_ctx=None, tp_group=None):
    """GQA attention over one layer of the dense KV cache, or over the
    call's own tokens when ``cache`` is None (``forward_hidden``): the
    flash kernel over the whole sequence, bidirectional for an
    encoder-only config, else causal.

    cache: {"k","v": [B, Smax, Hkv, D]}; new K/V are written at
    ``cache_index`` IN PLACE (the reference's functional
    ``dynamic_update_slice``). ``cache_index`` is an int (a prompt chunk's
    start) or a one-element device tensor (the decode position, never read
    on the host: the write is an ``index_copy_`` at that position). One
    token (decode, or the pipe strategy's last 1-token chunk) attends over
    the whole cache masked at ``cache_index + 1`` with the decode kernel; a
    chunk of S > 1 tokens at an int start attends over the prefix
    ``[0, start + S)`` with the causal flash kernel, aligned bottom-right.

    Under ``distributed.sharding.split_kv_enabled`` a one-token step
    takes the split-KV path instead (``distributed/split_kv.py``): the
    cache is this rank's sequence shard, the owner of the position writes,
    and the shards' softmax partials combine over the mesh's ``model``
    group. ``tp_group``: the layer is this rank's head slice (see
    :func:`tp_all_gather`). Returns (out, cache)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v, mm = _qkv_rope(p, x, cfg, positions, hetero_ctx, freqs)
    if cache is None:
        o = flash_attention(q, k, v, causal=not cfg.encoder_only)
        return _out_proj(o.reshape(B, S, cfg.n_heads * hd), p, mm,
                         tp_group), None
    if S == 1 and split_kv_active():
        o, _, _ = split_kv_decode_update_attend(
            q, k, v, cache["k"], cache["v"], cache_index, split_kv_mesh())
        return _out_proj(o.reshape(B, S, cfg.n_heads * hd), p, mm,
                         tp_group), cache
    ck, cv = cache["k"], cache["v"]
    plan = active_plan()
    if S > 1 and plan is not None and plan.kv_seq:
        o = _seq_sharded_prefill(q, k, v, ck, cv, cache_index, plan)
        return _out_proj(o.reshape(B, S, cfg.n_heads * hd), p, mm,
                         tp_group), cache
    if isinstance(cache_index, torch.Tensor):
        if S != 1:
            raise ValueError("a device cache index takes one token, got "
                             f"{S}")
        at = cache_index.reshape(1).long()
        ck.index_copy_(1, at, k.to(ck.dtype))
        cv.index_copy_(1, at, v.to(cv.dtype))
    else:
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
    # a cache narrower than the activations (the dense batcher's bf16 cache
    # under an fp32 model, the reference's default) is widened for the
    # kernels, which take one dtype (the reference's plain attention also
    # rounds its probabilities to the cache's dtype); else ``to`` is a no-op
    if S == 1:
        o = decode_attention(q[:, 0], ck.to(q.dtype), cv.to(q.dtype),
                             cache_index + 1)[:, None]
    else:
        end = cache_index + S
        o = flash_attention(q, ck[:, :end].to(q.dtype),
                            cv[:, :end].to(q.dtype), causal=True)
    return _out_proj(o.reshape(B, S, cfg.n_heads * hd), p, mm,
                     tp_group), cache


def _seq_sharded_prefill(q, k, v, ck, cv, start: int, plan):
    """A prompt chunk at host position ``start`` over a cache layer whose
    SEQUENCE is sharded over the step's ``model`` axis (split-KV serving):
    this rank writes the positions its block holds, and the chunk attends
    (causal flash kernel) over the prefix as the cache stores it — the
    chunk's own K/V rounded to the cache's dtype, after the earlier
    positions gathered from the ranks' blocks when ``start > 0``."""
    S, chunk = q.shape[1], ck.shape[1]
    lo = plan.kv_seq_chunk(ck)
    a, b = max(start, lo), min(start + S, lo + chunk)
    if a < b:
        ck[:, a - lo:b - lo] = k[:, a - start:b - start].to(ck.dtype)
        cv[:, a - lo:b - lo] = v[:, a - start:b - start].to(cv.dtype)
    kk, vv = k.to(ck.dtype), v.to(cv.dtype)
    if start:
        kk = torch.cat([plan.gather_seq_cache(ck)[:, :start], kk], dim=1)
        vv = torch.cat([plan.gather_seq_cache(cv)[:, :start], vv], dim=1)
    return flash_attention(q, kk.to(q.dtype), vv.to(q.dtype), causal=True)


def slot_attention(p: dict, x, cfg, *, lengths, cache: dict, freqs,
                   hetero_ctx=None):
    """GQA attention of one token per lane over one layer of the dense
    cache with per-slot indices: lane ``b`` writes its K/V at
    ``lengths[b]`` IN PLACE (a scatter on the sequence axis, the write
    clamped into the cache as the reference's ``dynamic_update_slice``
    clamps it) and attends over the whole cache masked at its own
    position. The attention is plain torch (``blockwise_attention``), as
    the reference computes it: kernel 2.5 takes one length for the whole
    batch, in both packages. ``lengths`` is a [B] device tensor, never read
    on the host. Returns (out, cache)."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"per-slot indices take one token a lane, got {S}")
    positions = lengths[:, None].long()
    q, k, v, mm = _qkv_rope(p, x, cfg, positions, hetero_ctx, freqs)
    ck, cv = cache["k"], cache["v"]
    Smax, Hkv, D = ck.shape[1:]
    at = positions.clamp(max=Smax - 1)[:, :, None, None].expand(B, 1, Hkv, D)
    ck.scatter_(1, at, k.to(ck.dtype))
    cv.scatter_(1, at, v.to(cv.dtype))
    kv_pos = torch.arange(Smax, dtype=torch.long, device=x.device)
    o = blockwise_attention(q, ck, cv, q_pos=positions, kv_pos=kv_pos,
                            causal=True, block_k=cfg.attn_block_k)
    out = mm(o.reshape(B, S, cfg.n_heads * cfg.head_dim), p["wo"], name="wo")
    return out, cache


def quantize_kv_slot(x: torch.Tensor, scale_dtype=torch.bfloat16,
                     tp_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-slot symmetric int8 KV quantization: x ``[T, Hkv, D]`` ->
    (codes int8 ``[T, Hkv, D]``, scale ``[T]`` in ``scale_dtype``).

    The scale is rounded to its storage type BEFORE the codes are computed,
    so codes quantize against the value the gather multiplies by and any
    chunking of the same token stream writes the same bytes. An all-zero
    slot stores scale 0 and dequantizes to exactly 0. With ``tp_group``
    ``x`` holds this rank's KV heads, and the slot's amax is the maximum
    over the group's (a max of maxes is exact), so codes and scales are the
    single-device pool's byte for byte."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    if tp_group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=tp_group)
    s_stored = torch.where(amax > 0, amax / 127.0, 0.0).to(scale_dtype)
    denom = torch.where(s_stored == 0, 1.0, s_stored.float())
    codes = torch.clamp(torch.round(xf / denom[..., None, None]), -127, 127)
    return codes.to(torch.int8), s_stored


def dequant_kv_ref(codes: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Expansion of int8 KV (codes ``[..., T, Hkv, D]`` x scale ``[..., T]``),
    the gather's arithmetic."""
    return (codes.float() * scale.float()[..., None, None]).to(dtype)


def paged_attention(p: dict, x, cfg, *, positions, pool: dict, block_table,
                    freqs, hetero_ctx=None, tp_group=None):
    """GQA attention over one layer of the paged KV pool.

    Logical position ``t`` of request ``b`` lives at physical slot
    ``block_table[b, t // BS] * BS + t % BS`` of the flat pool. New K/V are
    written there IN PLACE (the pool tensors are updated, not copied — the
    reference's functional ``.at[idx].set``); reads gather the request's
    pages into a ``[B, NBmax*BS]`` view whose slot index is the logical
    position, so the positional causal mask hides stale contents and the
    null block. pool: {"k","v": [NB, BS, Hkv, D]}, plus {"k_scale",
    "v_scale": [NB, BS]} for an int8 pool, which quantizes on the write and
    dequantizes in the gather; block_table: [B, NBmax] (0 = null block);
    freqs: the RoPE table. With ``tp_group`` the pool holds this rank's KV
    heads and the layer its head slice: the scatter, gather and softmax run
    on the local heads, and the only collectives are the int8 slot scale's
    max and the two gathers around wo. Returns (out, pool).
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    NB, BS, Hkv, D = pool["k"].shape
    q, k, v, mm = _qkv_rope(p, x, cfg, positions, hetero_ctx, freqs)

    pos = (positions if positions.ndim == 2
           else positions[None, :].expand(B, S)).long()
    table = block_table.long()
    blk = torch.gather(table, 1, pos // BS)                   # [B, S]
    flat_idx = (blk * BS + pos % BS).reshape(-1)              # [B*S]
    # an int8 pool is recognised before any write: casting floats into its
    # codes would silently truncate them
    quant = "k_scale" in pool
    for name, new in (("k", k), ("v", v)):
        flat = pool[name].view(NB * BS, Hkv, D)
        new = new.reshape(B * S, Hkv, D)
        if quant:
            sc = pool[f"{name}_scale"]
            new, new_sc = quantize_kv_slot(new, sc.dtype, tp_group)
            sc.view(NB * BS)[flat_idx] = new_sc
        flat[flat_idx] = new.to(flat.dtype)

    NBmax = table.shape[1]
    ck = pool["k"][table].reshape(B, NBmax * BS, Hkv, D)
    cv = pool["v"][table].reshape(B, NBmax * BS, Hkv, D)
    if quant:
        ck = dequant_kv_ref(ck, pool["k_scale"][table].reshape(
            B, NBmax * BS), q.dtype)
        cv = dequant_kv_ref(cv, pool["v_scale"][table].reshape(
            B, NBmax * BS), q.dtype)
    kv_pos = torch.arange(NBmax * BS, dtype=torch.long, device=x.device)
    o = blockwise_attention(q, ck, cv, q_pos=pos, kv_pos=kv_pos, causal=True,
                            block_k=cfg.attn_block_k)
    return _out_proj(o.reshape(B, S, cfg.n_heads * hd), p, mm,
                     tp_group), pool


# ---------------------------------------------------------------------- ffn --

def init_swiglu(cfg, generator: torch.Generator, device, n_layers: int) -> dict:
    d, d_ff = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "w_gate": normal_stack(n_layers, (d, d_ff), s, cfg.param_dtype,
                               generator, device),
        "w_up": normal_stack(n_layers, (d, d_ff), s, cfg.param_dtype,
                             generator, device),
        "w_down": normal_stack(n_layers, (d_ff, d), 1.0 / math.sqrt(d_ff),
                               cfg.param_dtype, generator, device),
    }


def swiglu(p: dict, x, hetero_ctx=None, tp_group=None) -> torch.Tensor:
    """SwiGLU FFN. With ``tp_group`` w_gate / w_up hold this rank's d_ff
    columns and w_down its output columns: the hidden activation is
    gathered before w_down and the output after it, never a sum of
    row-parallel partials (which would reassociate the d_ff reduction)."""
    mm = hetero_ctx.matmul if hetero_ctx is not None else matmul_any
    g = mm(x, p["w_gate"], name="w_gate")
    u = mm(x, p["w_up"], name="w_up")
    h = F.silu(g) * u
    if tp_group is not None:
        h = tp_all_gather(h, tp_group)
    out = mm(h, p["w_down"], name="w_down")
    return out if tp_group is None else tp_all_gather(out, tp_group)


# ----------------------------------------------------------------- training --

_SAVED_DOTS = ("mm", "bmm", "addmm")


def remat_policy_of(cfg):
    """``torch.utils.checkpoint``'s ``context_fn`` of the config's
    rematerialisation policy: ``"dots"`` keeps the matmul outputs
    (``aten.mm`` / ``bmm`` / ``addmm``) and recomputes the rest, as the
    reference's ``checkpoint_dots_with_no_batch_dims`` does; ``"nothing"``
    (None: the default context) keeps nothing, the whole layer is
    recomputed in backward."""
    if cfg.remat_policy != "dots":
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, name).default for name in _SAVED_DOTS}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat`` recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant, with
    :func:`remat_policy_of`'s context), as the reference's
    ``jax.checkpoint`` of a scanned layer or period."""
    if not cfg.remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    context = remat_policy_of(cfg)
    kw = {} if context is None else {"context_fn": context}
    return checkpoint(_in_context(fn), *args, use_reentrant=False, **kw)


def _in_context(fn):
    """``fn`` run under the activation context of this call: a
    checkpointed function's recompute runs in backward, on the autograd
    engine's thread, where the caller's context variables are not set."""
    act = current_activation()
    if act is None:
        return fn

    def run(*args):
        with activation_sharding(*act):
            return fn(*args)
    return run


def _ce_chunk(h, targets, emb_out):
    logits = matmul_any(h, emb_out).float()
    plan = active_plan()
    if plan is not None and plan.tp_blocks["vocab"]:
        return plan.vocab_ce(logits, targets)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_ce_loss(emb_out, h: torch.Tensor, targets: torch.Tensor, *,
                    chunk: int) -> torch.Tensor:
    """Mean cross-entropy (fp32) without materialising ``[B, S, V]``: a loop
    over sequence chunks, the largest divisor of S at most ``chunk``. Each
    chunk is recomputed in backward (``torch.utils.checkpoint``, as the
    reference's ``@jax.checkpoint``), so only one chunk's fp32 logits are
    alive at a time. emb_out: the head ``[D, V]`` (an untied head, possibly
    a QuantWeight, or the embedding's transpose); h: [B, S, D]; targets:
    [B, S] ids. In a sharded step a vocabulary-sharded head takes the
    log-sum-exp across ranks, and the mean is over the global token count
    (``StepPlan.vocab_ce`` / ``token_mean``)."""
    from torch.utils.checkpoint import checkpoint
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    ce_chunk = _in_context(_ce_chunk)
    for i in range(0, S, chunk):
        total = total + checkpoint(ce_chunk, h[:, i:i + chunk],
                                   targets[:, i:i + chunk], emb_out,
                                   use_reentrant=False)
    plan = active_plan()
    return total / (B * S) if plan is None else plan.token_mean(total, B * S)
