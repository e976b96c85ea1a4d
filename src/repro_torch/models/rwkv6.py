"""RWKV-6 ("Finch"): attention-free LM with data-dependent per-channel
decay, the reference's model (``repro.models.rwkv6``).

Token-mix (WKV6) recurrence per head (state S in R^{hd x hd}):
    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w_base + lora(x_t)))

Prefill runs the chunked state-passing scan (``wkv6_chunked``): within a
chunk the pairwise log-space decay (every exponent <= 0, so nothing
overflows), across chunks the state. ``wkv6_recurrent`` is the exact
per-step recurrence, decode's update and the scan's oracle. The reference
has no Pallas kernel here, so both are plain torch. The reference's
simplifications stand: static token-shift mixing (the data-dependent part
is the decay) and RMSNorm instead of LayerNorm.

The cache's token-shift and WKV states are updated in place, as mamba2's
are, so a captured decode loop replays over the same buffers; a prefill
from position 0 starts from zero states, whatever the cache held (the
engine reuses its cache per shape). ``hetero_ctx`` is accepted and ignored,
as in the reference: every product here is a plain matmul. ``loss_fn`` is
training's cache-free path, each layer from zero states, recomputed in
backward under ``cfg.remat``; its scan stays plain torch, differentiated
by autograd (the clamped exponents keep its gradient finite).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs import dtype_of
from ..device import resolve_device
from ..distributed.sharding import (gather_layer, hidden_constraint,
                                    hidden_enter, hidden_gather,
                                    logits_constraint, tp_gather, tp_slice)
from .layers import chunked_ce_loss, normal_stack, remat, rms_norm
from .transformer import (chunk_end, layer_params, starts_prompt,
                          unstack_layers)


def _heads(cfg):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def init_layer(cfg, generator: torch.Generator, device, n_layers: int
               ) -> dict:
    """Stacked ``[L, ...]`` RWKV-6 layer weights at the reference's scales
    and constants (mix 0.5, w_base -6)."""
    d, r, L = cfg.d_model, cfg.rwkv.decay_lora, cfg.n_layers
    dt = dtype_of(cfg.param_dtype)
    s = 1.0 / math.sqrt(d)

    def n(shape, sc=s, dtype=cfg.param_dtype):
        return normal_stack(n_layers, shape, sc, dtype, generator, device)

    full = dict(dtype=dt, device=device)
    return {
        "ln1": torch.ones((L, d), **full), "ln2": torch.ones((L, d), **full),
        "mix": torch.full((L, 5, d), 0.5, **full),        # r,k,v,g,w shifts
        "wr": n((d, d)), "wk": n((d, d)), "wv": n((d, d)), "wg": n((d, d)),
        "wo": n((d, d)),
        "w_base": torch.full((L, d), -6.0, dtype=torch.float32,
                             device=device),
        "w_lora_a": n((d, r)), "w_lora_b": n((r, d), 0.01),
        "u": n((d,), 0.1, "float32"),
        "mix_ffn": torch.full((L, d), 0.5, **full),
        "wk_ffn": n((d, cfg.d_ff)),
        "wv_ffn": n((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff)),
        "wr_ffn": n((d, d)),
    }


def wkv6_chunked(r, k, v, lw, u, *, chunk: int, state=None):
    """r, k, v, lw: [B, S, H, hd] (lw the log decay, <= 0); u: [H, hd].
    Returns (y [B, S, H, hd] fp32, final state [B, H, hd, hd] fp32)."""
    B, S, H, hd = r.shape
    L = min(chunk, S)
    S_orig = S
    if S % L:     # pad with decay 1 (lw = 0), k = 0 steps: state-neutral
        pad = L - S % L
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
        S += pad
    nc = S // L

    def chunks(a):
        return a.float().reshape(B, nc, L, H, hd).transpose(0, 1)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(lw)
    cs = torch.cumsum(lwc, dim=2) - lwc        # exclusive cumsum in a chunk
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     -1)[None, :, :, None, None]           # strict lower
    ys = []
    for i in range(nc):
        r_i, k_i, v_i, lw_i, cs_i = rc[i], kc[i], vc[i], lwc[i], cs[i]
        # pairwise decay exp(cs_q - cs_j - lw_j) for j < q (exponent <= 0
        # on the strict lower triangle; the masked rest clamped to 0)
        expo = torch.clamp(cs_i[:, :, None] - cs_i[:, None, :]
                           - lw_i[:, None, :], max=0.0)    # [B, q, j, H, hd]
        dec = torch.where(tri, torch.exp(expo), 0.0)
        att = torch.einsum("bqhc,bqjhc,bjhc->bqjh", r_i, dec, k_i)
        y = torch.einsum("bqjh,bjhd->bqhd", att, v_i)       # strict past
        y = y + (r_i * u[None, None] * k_i).sum(-1, keepdim=True) * v_i
        y = y + torch.einsum("bqhc,bhcd->bqhd", r_i * torch.exp(cs_i), state)
        tot = cs_i[:, -1] + lw_i[:, -1]                    # [B, H, hd]
        w_k = torch.exp(tot[:, None] - cs_i - lw_i)        # (<= 0 exponent)
        state = (torch.exp(tot)[..., None] * state
                 + torch.einsum("bjhc,bjhd->bhcd", k_i * w_k, v_i))
        ys.append(y)
    y = torch.stack(ys).transpose(0, 1).reshape(B, S, H, hd)
    return y[:, :S_orig], state


def wkv6_recurrent(r, k, v, lw, u, *, state=None):
    """The exact per-step recurrence (decode's update, the scan's oracle).
    Returns (y [B, S, H, hd] fp32, final state [B, H, hd, hd] fp32)."""
    B, S, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    ys = []
    for t in range(S):
        r_t, k_t, v_t, lw_t = (a[:, t].float() for a in (r, k, v, lw))
        kv = torch.einsum("bhc,bhd->bhcd", k_t, v_t)
        ys.append(torch.einsum("bhc,bhcd->bhd", r_t,
                               state + u[None, ..., None] * kv))
        state = torch.exp(lw_t)[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def _shifted(x, shift_state):
    """Each token's predecessor: the carried last token, then x[:, :-1]."""
    if x.shape[1] == 1:
        return shift_state[:, None]
    return torch.cat([shift_state[:, None], x[:, :-1]], dim=1)


def _token_mix(p, x, cfg, *, shift_state, wkv_state, decode=False):
    """x: [B, S, D]. Returns (out, new shift [B, D], new wkv
    [B, H, hd, hd]). In a sharded step r / k / v / g are this rank's heads
    (column-parallel), the decay and ``u`` are cut to them, the WKV state
    is this rank's heads of the whole one (gathered back after the scan),
    and ``out`` is ``wo``'s row-parallel partial sum."""
    B, S, D = x.shape
    _, hd = _heads(cfg)
    prev = _shifted(x, shift_state)
    xr, xk, xv, xg, xw = (x * m + prev * (1 - m) for m in p["mix"])
    r = (xr @ p["wr"]).reshape(B, S, -1, hd)
    k = (xk @ p["wk"]).reshape(B, S, -1, hd)
    v = (xv @ p["wv"]).reshape(B, S, -1, hd)
    g = F.silu(xg @ p["wg"])
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float()) \
        @ p["w_lora_b"].float()
    lw = -torch.exp(p["w_base"][None, None] + lora)        # log decay <= 0
    lw = tp_slice(torch.clamp(lw, -40.0, -1e-5), "rwkv_tm").reshape(
        B, S, -1, hd)
    u = tp_slice(p["u"], "rwkv_tm").reshape(-1, hd)
    if wkv_state is not None:
        wkv_state = tp_slice(wkv_state, "rwkv_tm", 1)
    if decode:
        y, new_wkv = wkv6_recurrent(r, k, v, lw, u, state=wkv_state)
    else:
        y, new_wkv = wkv6_chunked(r, k, v, lw, u, chunk=cfg.rwkv.chunk,
                                  state=wkv_state)
    y = rms_norm(y.reshape(B * S, -1, hd),
                 torch.ones((hd,), dtype=y.dtype, device=y.device),
                 cfg.norm_eps).reshape(B, S, -1).to(x.dtype)
    return ((y * g) @ p["wo"], x[:, -1],
            tp_gather(new_wkv, "rwkv_tm", 1))


def _channel_mix(p, x, *, shift_state):
    """In a sharded step ``kk`` is this rank's d_ff columns, the gate
    ``rr`` is gathered whole, and the output is ``wv_ffn``'s row-parallel
    partial sum."""
    prev = _shifted(x, shift_state)
    xk = x * p["mix_ffn"] + prev * (1 - p["mix_ffn"])
    kk = torch.square(torch.relu(xk @ p["wk_ffn"]))
    rr = tp_gather(torch.sigmoid(x @ p["wr_ffn"]), "rwkv_cm")
    return rr * (kk @ p["wv_ffn"]), x[:, -1]


def _layer(lp, x, cfg, st, decode):
    lp = gather_layer(lp)
    h = hidden_gather(rms_norm(x, lp["ln1"], cfg.norm_eps))
    tm, s1, wkv = _token_mix(lp, h, cfg, shift_state=st["shift1"],
                             wkv_state=st["wkv"], decode=decode)
    x = x + hidden_constraint(tm, "rwkv_tm")
    h = hidden_gather(rms_norm(x, lp["ln2"], cfg.norm_eps))
    cm, s2 = _channel_mix(lp, h, shift_state=st["shift2"])
    return (x + hidden_constraint(cm, "rwkv_cm"),
            {"shift1": s1, "shift2": s2, "wkv": wkv})


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda") -> dict:
    """Random-init parameters on ``device`` (the card unless ``"cpu"`` is
    asked for), drawn from ``generator`` — a generator on that device,
    seeded 0 when None. The reference's initializer scales; not the
    reference's random numbers."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": normal_stack(1, (v, d), 0.02, cfg.param_dtype, generator,
                              device)[0],
        "final_norm": torch.ones((d,), dtype=dtype_of(cfg.param_dtype),
                                 device=device),
        "head": normal_stack(1, (d, v), 1.0 / math.sqrt(d), cfg.param_dtype,
                             generator, device)[0],
        "layers": init_layer(cfg, generator, device, cfg.n_layers),
    }


_STATES = ("shift1", "shift2", "wkv")


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> dict:
    """The token-shift states ``[L, batch, D]`` (in ``dtype``), the WKV
    state ``[L, batch, H, hd, hd]`` (fp32) and the write position
    ``index``, an int32 scalar, on ``device`` (the card unless ``"cpu"`` is
    asked for). ``max_len`` is unused: the state is O(1) in the length."""
    device = resolve_device(device)
    H, hd = _heads(cfg)
    L, d = cfg.n_layers, cfg.d_model
    return {"shift1": torch.zeros((L, batch, d), dtype=dtype, device=device),
            "shift2": torch.zeros((L, batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                               device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def _run(params, x, cfg, *, cache, decode=False, fresh=False):
    """All layers over the cache's states, which are updated in place; with
    ``fresh`` every layer starts from zero states."""
    B = x.shape[0]
    H, hd = _heads(cfg)
    for i in range(cfg.n_layers):
        if fresh:
            st = {"shift1": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                        device=x.device),
                  "shift2": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                        device=x.device),
                  "wkv": None}
        else:
            st = {name: cache[name][i] for name in _STATES}
        x, new = _layer(layer_params(params["layers"], i), x, cfg, st, decode)
        for name in _STATES:
            cache[name][i].copy_(new[name])
    return x


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _train_layer(x, lp, cfg):
    """One layer with no cache, from zero token-shift and WKV states."""
    zero = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                       device=x.device)
    return _layer(lp, x, cfg, {"shift1": zero, "shift2": zero, "wkv": None},
                  False)[0]


def loss_fn(params, inputs, targets, cfg):
    """Training objective, the reference's ``loss_fn``: next-token CE over
    the cache-free run; with ``cfg.remat`` each layer is recomputed in
    backward (``layers.remat``), as the reference's ``jax.checkpoint`` per
    scanned layer. inputs / targets: [B, S] token ids. Returns (loss,
    {"ce", "aux"}), aux a 0-dim fp32 zero."""
    x = hidden_enter(_embed(params, inputs, cfg))
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x = remat(cfg, _train_layer, x, lp, cfg)
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    ce = chunked_ce_loss(params["head"], x, targets, chunk=cfg.loss_chunk)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, tokens, cache, cfg, *, start_index=0, fresh=None,
            hetero_ctx=None):
    """Process a prompt chunk (``start_index`` a host int, or a 0-dim
    device tensor with ``fresh`` given, as ``mamba2.prefill``): the states
    are updated in place, from zero when the chunk starts the prompt.
    Returns (last-token logits ``[B, 1, V]``, cache with ``index = start +
    S``)."""
    x = hidden_enter(_embed(params, tokens, cfg))
    x = _run(params, x, cfg, cache=cache,
             fresh=starts_prompt(start_index, fresh))
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    logits = logits_constraint((x[:, -1:, :] @ params["head"]).float())
    return logits, {**cache, "index": chunk_end(start_index, tokens.shape[1],
                                                 x.device)}


def decode_step(params, token, cache, cfg, *, hetero_ctx=None):
    """One autoregressive step (the exact one-step update). token: [B, 1].
    Returns (logits [B, 1, V], cache with ``index + 1``)."""
    x = _embed(params, token, cfg)
    x = _run(params, x, cfg, cache=cache, decode=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_constraint((x @ params["head"]).float())
    return logits, {**cache, "index": cache["index"] + 1}
