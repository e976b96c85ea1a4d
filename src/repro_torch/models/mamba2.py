"""Mamba2 (SSD) blocks and the zamba2-style hybrid over a dense cache.

SSD runs as a chunked scan: each chunk of a prefill goes through the SSD
chunk kernel (``kernels/ssm_scan``), which takes the intra-chunk pairwise
decay and the state passed in from the previous chunk. Decode is the exact
one-step recurrence in plain torch, as in the reference. The hybrid model
interleaves a SHARED attention + FFN block (one parameter set) after every
``ssm.attn_every`` mamba layers.

Parameters are a dict shaped like the reference's pytree: the mamba layers
stacked under ``mamba`` (leading axis ``n_layers``), the shared block under
``shared``, weights in ``[K, N]`` layout. The cache's conv and SSM states
and the shared block's K/V are written in place, as the dense transformer
writes its cache. ``loss_fn`` is training's cache-free path: periods of
``attn_every`` mamba layers and the shared block over the whole sequence,
each period recomputed in backward under ``cfg.remat``; its SSD scan goes
through the chunk kernel's autograd Function (``kernels/ssm_scan``), its
attention through the flash kernel's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs import dtype_of
from ..core.partition import matmul_any
from ..device import resolve_device
from ..distributed.sharding import (gather_layer, hidden_constraint,
                                    hidden_enter, hidden_gather,
                                    logits_constraint, tp_slice)
from ..kernels.ssm_scan.ops import chunk_inputs, scan_chunks
from .layers import (attention, chunked_ce_loss, init_attention, init_swiglu,
                     normal_stack, remat, rms_norm, rope_table, swiglu)
from .transformer import (chunk_end, chunk_positions, layer_params,
                          starts_prompt, unstack_layers)


# ------------------------------------------------------------- mamba2 block --

def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return d_in, nh, conv_dim


def init_mamba_block(cfg, generator: torch.Generator, device,
                     n_layers: int) -> dict:
    """Stacked ``[n_layers, ...]`` mamba block weights: random projections
    and conv (the reference's scales), the reference's deterministic
    ``A_log``, ``dt_bias`` and ``D``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    proj_out = 2 * d_in + 2 * s.d_state + nh     # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones((n_layers, d), dtype=dt, device=device),
        "in_proj": normal_stack(n_layers, (d, proj_out), 1.0 / math.sqrt(d),
                                cfg.param_dtype, generator, device),
        "conv_w": normal_stack(n_layers, (s.d_conv, conv_dim), 0.1,
                               cfg.param_dtype, generator, device),
        "conv_b": torch.zeros((n_layers, conv_dim), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)).expand(
            n_layers, nh).clone(),
        "dt_bias": torch.zeros((n_layers, nh), **f32),
        "D": torch.ones((n_layers, nh), **f32),
        "gate_norm": torch.ones((n_layers, d_in), dtype=dt, device=device),
        "out_proj": normal_stack(n_layers, (d_in, d), 1.0 / math.sqrt(d_in),
                                 cfg.param_dtype, generator, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as the reference takes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time, as the reference's sum of K shifted
    products (so low-precision sums run in its order). xbc: [B,S,C]; w:
    [K,C]. Returns (out [B,S,C], new_state [B,K-1,C])."""
    K, S = w.shape[0], xbc.shape[1]
    if state is None:
        state = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([state, xbc], dim=1)                   # [B, S+K-1, C]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else state
    return F.silu(out + b[None, None, :]), new_state


def ssd_chunked(xh, dt, A, B_, C_, *, chunk: int, ssm_state=None):
    """Chunked SSD scan, one SSD chunk kernel launch per chunk.

    xh: [B,S,nh,hd]  dt: [B,S,nh] (post-softplus)  A: [nh] (negative)
    B_, C_: [B,S,N]; ``ssm_state`` [B,nh,hd,N] fp32 or None (zeros).
    Returns (y [B,S,nh,hd] fp32, final_state [B,nh,hd,N] fp32)."""
    Bb, S, nh, hd = xh.shape
    L = min(chunk, S)
    S_orig = S
    if S % L:       # pad with dt=0 steps: decay=1, input weight=0 -> state-neutral
        pad = L - S % L
        xh, dt, B_, C_ = (F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
                          for a in (xh, dt, B_, C_))
    if ssm_state is None:
        ssm_state = torch.zeros((Bb, nh, hd, B_.shape[-1]),
                                dtype=torch.float32, device=xh.device)
    y, state = scan_chunks(*chunk_inputs(xh, dt, A, B_, C_, L), L, ssm_state)
    return y[:, :S_orig], state


def _in_proj(p, x, cfg, mm):
    """Shared front end: norm, in_proj, split, causal conv input."""
    d_in, nh, conv_dim = _dims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = mm(h, p["in_proj"], name="in_proj")
    return torch.split(zxbcdt, [d_in, conv_dim, nh], dim=-1)


def _out_proj(p, x, y, z, cfg, mm):
    """The gated norm, then ``out_proj`` into the residual: in a sharded
    step, this rank's rows of ``out_proj`` on its columns of the normed
    output, summed over ``model`` (``hidden_constraint``)."""
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = mm(tp_slice(y, "mamba"), p["out_proj"], name="out_proj")
    return x + hidden_constraint(out, "mamba")


def mamba_block(p, x, cfg, *, conv_state=None, ssm_state=None,
                hetero_ctx=None):
    """x: [B,S,D] -> (y, new_conv_state, new_ssm_state)."""
    s = cfg.ssm
    d_in, nh, _ = _dims(cfg)
    p = gather_layer(p, "mamba")
    h = hidden_gather(x)
    B, S, _ = h.shape
    mm = hetero_ctx.matmul if hetero_ctx is not None else matmul_any
    z, xbc, dt = _in_proj(p, h, cfg, mm)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B_, C_ = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, nh, s.head_dim)
    y, new_ssm = ssd_chunked(xh, dt, A, B_, C_, chunk=s.chunk,
                             ssm_state=ssm_state)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    return _out_proj(p, x, y, z, cfg, mm), new_conv, new_ssm


def mamba_decode_step(p, x, cfg, conv_state, ssm_state, hetero_ctx=None):
    """Exact single-step recurrence. x: [B,1,D]."""
    s = cfg.ssm
    d_in, nh, _ = _dims(cfg)
    p = gather_layer(p, "mamba")
    B = x.shape[0]
    mm = hetero_ctx.matmul if hetero_ctx is not None else matmul_any
    z, xbc, dt = _in_proj(p, x, cfg, mm)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B_, C_ = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])[:, 0]
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, nh, s.head_dim).float()
    da = torch.exp(dt * A[None, :])                         # [B,nh]
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, B_[:, 0].float(), dt)
    new_ssm = da[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(), new_ssm)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    return _out_proj(p, x, y, z, cfg, mm), new_conv, new_ssm


# ----------------------------------------------------------- hybrid (zamba2) --

def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda") -> dict:
    """Random-init parameters on ``device`` (the card unless ``"cpu"`` is
    asked for), drawn from ``generator`` — a generator on that device,
    seeded 0 when None. The reference's initializer scales; not the
    reference's random numbers."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size

    def one(stacked: dict) -> dict:
        return {k: t[0] for k, t in stacked.items()}

    return {
        "embed": normal_stack(1, (v, d), 0.02, cfg.param_dtype, generator,
                              device)[0],
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "head": normal_stack(1, (d, v), 1.0 / math.sqrt(d), cfg.param_dtype,
                             generator, device)[0],
        # ONE shared attention + ffn block (zamba2)
        "shared": {
            "attn_norm": torch.ones((d,), dtype=dt, device=device),
            "attn": one(init_attention(cfg, generator, device, 1)),
            "ffn_norm": torch.ones((d,), dtype=dt, device=device),
            "ffn": one(init_swiglu(cfg, generator, device, 1)),
        },
        "mamba": init_mamba_block(cfg, generator, device, cfg.n_layers),
    }


def _n_attn(cfg) -> int:
    """The number of periods (each ``attn_every`` mamba layers, then the
    shared block)."""
    ae = cfg.ssm.attn_every
    if cfg.n_layers % ae:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"multiple of attn_every={ae}")
    return cfg.n_layers // ae


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> dict:
    """The shared block's K/V ``[n_attn, batch, max_len, Hkv, D]``, the conv
    state ``[L, batch, d_conv - 1, conv_dim]`` (in ``dtype``), the SSM state
    ``[L, batch, nh, hd, N]`` (fp32) and the write position ``index``, an
    int32 scalar, all on ``device`` (the card unless ``"cpu"`` is asked
    for)."""
    device = resolve_device(device)
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    kv = (_n_attn(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _shared_block(sp, x, cfg, *, positions, kv, cache_index, freqs,
                  hetero_ctx):
    sp = gather_layer(sp, "shared", stacked=False)
    h = hidden_gather(rms_norm(x, sp["attn_norm"], cfg.norm_eps))
    a, _ = attention(sp["attn"], h, cfg, positions=positions, cache=kv,
                     cache_index=cache_index, freqs=freqs,
                     hetero_ctx=hetero_ctx)
    x = x + hidden_constraint(a, "attn")
    h = hidden_gather(rms_norm(x, sp["ffn_norm"], cfg.norm_eps))
    return x + hidden_constraint(swiglu(sp["ffn"], h, hetero_ctx=hetero_ctx),
                                 "ffn")


def _run(params, x, cfg, *, positions, cache, cache_index, decode=False,
         fresh=False, hetero_ctx=None):
    """Period structure: ``attn_every`` mamba layers then the shared block,
    over the cache, which is updated in place. A ``fresh`` prefill (from
    position 0) starts from zero conv and SSM states, whatever the cache
    held (the state of a fresh cache, so a reused cache carries nothing of
    an earlier request)."""
    ae = cfg.ssm.attn_every
    freqs = rope_table(cfg, x.device)
    for i in range(_n_attn(cfg)):
        for j in range(ae):
            layer = i * ae + j
            lp = layer_params(params["mamba"], layer)
            conv_s, ssm_s = cache["conv"][layer], cache["ssm"][layer]
            if decode:
                x, new_conv, new_ssm = mamba_decode_step(
                    lp, x, cfg, conv_s, ssm_s, hetero_ctx=hetero_ctx)
            else:
                x, new_conv, new_ssm = mamba_block(
                    lp, x, cfg, conv_state=None if fresh else conv_s,
                    ssm_state=None if fresh else ssm_s,
                    hetero_ctx=hetero_ctx)
            conv_s.copy_(new_conv)
            ssm_s.copy_(new_ssm)
        x = _shared_block(params["shared"], x, cfg, positions=positions,
                          kv={"k": cache["k"][i], "v": cache["v"][i]},
                          cache_index=cache_index, freqs=freqs,
                          hetero_ctx=hetero_ctx)
    return x


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _train_period(x, layers, shared, cfg, positions, freqs):
    """One period with no cache: its mamba layers from zero conv and SSM
    states, then the shared block attending over the call's own tokens."""
    for lp in layers:
        x = mamba_block(lp, x, cfg)[0]
    return _shared_block(shared, x, cfg, positions=positions, kv=None,
                         cache_index=None, freqs=freqs, hetero_ctx=None)


def loss_fn(params, inputs, targets, cfg):
    """Training objective, the reference's ``loss_fn``: next-token CE over
    the cache-free run (``attn_every`` mamba layers, then the shared block,
    per period); with ``cfg.remat`` each period is recomputed in backward
    (``layers.remat``), as the reference's ``jax.checkpoint`` per scanned
    period. inputs / targets: [B, S] token ids. Returns (loss, {"ce",
    "aux"}), aux a 0-dim fp32 zero."""
    ae = cfg.ssm.attn_every
    x = _embed(params, inputs, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.long, device=x.device)
    freqs = rope_table(cfg, x.device)
    x = hidden_enter(x)
    layers = unstack_layers(params["mamba"], cfg.n_layers)
    for i in range(_n_attn(cfg)):
        x = remat(cfg, _train_period, x, layers[i * ae:(i + 1) * ae],
                  params["shared"], cfg, positions, freqs)
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    ce = chunked_ce_loss(params["head"], x, targets, chunk=cfg.loss_chunk)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, tokens, cache, cfg, *, start_index=0, fresh=None,
            hetero_ctx=None):
    """Process a prompt chunk at ``start_index`` (a host int, or a 0-dim
    device tensor: a captured prefill): conv and SSM states and the shared
    block's cache are updated in place. ``fresh`` (the chunk starts the
    prompt, so the states start from zero) is ``start_index == 0`` for an
    int and must be given with a tensor, which is never read on the host.
    Returns (last-token logits ``[B, 1, V]``, cache with ``index = start +
    S``). The LM head is a plain matmul, as in the reference."""
    S = tokens.shape[1]
    fresh = starts_prompt(start_index, fresh)
    x = _embed(params, tokens, cfg)
    positions = chunk_positions(start_index, S, x.device)
    x = _run(params, hidden_enter(x), cfg, positions=positions, cache=cache,
             cache_index=start_index, fresh=fresh, hetero_ctx=hetero_ctx)
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    logits = logits_constraint(matmul_any(x[:, -1:, :],
                                          params["head"]).float())
    return logits, {**cache, "index": chunk_end(start_index, S, x.device)}


def decode_step(params, token, cache, cfg, *, hetero_ctx=None):
    """One autoregressive step of a uniform batch. token: [B, 1]. The
    position ``cache["index"]`` is a device scalar and stays there.
    Returns (logits [B, 1, V], cache with ``index + 1``)."""
    idx = cache["index"]
    if idx.ndim != 0:
        raise NotImplementedError("per-slot cache indices (the dense "
                                  "continuous batcher) are not ported")
    x = _embed(params, token, cfg)
    x = _run(params, x, cfg, positions=idx.reshape(1).long(), cache=cache,
             cache_index=idx, decode=True, hetero_ctx=hetero_ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_constraint(matmul_any(x, params["head"]).float())
    return logits, {**cache, "index": idx + 1}
