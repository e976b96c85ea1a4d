"""The plain reference: the served model's forward pass in float32 PyTorch,
written from the published description and the configuration file alone.

It imports nothing of the program. It reads the weights the benchmark made
(a dict laid out as ``benchkit.weights`` lays it out) and the tokens the
benchmark hands it, and works out everything else itself: rotary tables,
the causal mask, the grouped-query heads, and for a mixture of experts the
router, the capacity groups and their drops.

Layers run one at a time, each layer's weights widened to float32 just
before use, so the reference fits beside the served model. TF32 is off
while it runs (:func:`exact_matmuls`).

``precision="fp8"`` is the control: every matrix product of the layers and
the head takes its operands rounded to float8 e4m3 (a scale per row of the
activations and per output column of the weights, the usual fp8 serving
recipe) and accumulates in float32. Attention, norms and the router stay
float32.

Configuration keys are the source's (``hidden_size``, ``num_experts``, ...);
the capacity dispatch is stated under ``assumed`` (``moe_capacity_factor``,
``moe_group_size``) and the gate normalisation under ``norm_topk_prob``.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextmanager
def exact_matmuls():
    """Float32 products in float32: TF32 off for matmuls and cuDNN while
    the block runs, the previous settings put back after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` maps to 448), returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference multiplies an activation ``x`` [T, K] by a weight
    ``w`` [K, N]: in float32, or on float8 operands (the control)."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, dim=-2) if self.name == "fp8" else w

    def mm(self, x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            x = _fp8(x, dim=-1)
        return x @ w32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rotary(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [T, head_dim / 2] of the rotate-half convention: pair ``i``
    of a head turns by ``position / theta ** (2 i / head_dim)``; angles in
    float64, then float32."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64,
                     device=positions.device)
    inv = 1.0 / theta ** (i / head_dim)
    ang = positions.double()[:, None] * inv[None, :]
    return ang.cos().float(), ang.sin().float()


def apply_rotary(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [T, heads, head_dim]: halves (a, b) -> (a cos - b sin, b cos + a sin)."""
    a, b = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def causal_attention(q, k, v, block: int = 512) -> torch.Tensor:
    """q [T, H, D], k / v [T, Hkv, D], query head h reading key head
    ``h // (H / Hkv)``; position t sees positions 0..t. Queries in blocks
    of ``block`` so the scores stay small."""
    T, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)      # [H, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)                                     # [H, T, D]
    out = torch.empty_like(qh)
    scale = 1.0 / math.sqrt(D)
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        s = (qh[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * scale  # [H, b, hi]
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, lo:hi] = torch.softmax(s, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1)


def swiglu(x, w_gate, w_up, w_down, prec: Precision) -> torch.Tensor:
    g = prec.mm(x, prec.weight(w_gate))
    u = prec.mm(x, prec.weight(w_up))
    return prec.mm(F.silu(g) * u, prec.weight(w_down))


def dispatch_groups(n_tokens: int, group_size: int) -> int:
    """How many equal capacity groups a call of ``n_tokens`` tokens is cut
    into: the largest divisor of ``n_tokens`` that is at most
    ``n_tokens // group_size``, and at least one."""
    g = max(1, n_tokens // max(group_size, 1))
    while n_tokens % g:
        g -= 1
    return g


def capacity(tokens_in_group: int, cfg: dict) -> int:
    """Slots each expert has in a group: ``ceil(Tg / E * factor * k)``,
    at least k, at most the group's tokens."""
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    factor = cfg["assumed"]["moe_capacity_factor"]
    cap = max(k, math.ceil(tokens_in_group / E * factor * k))
    return min(cap, tokens_in_group)


def kept_assignments(experts: torch.Tensor, calls, cfg: dict) -> torch.Tensor:
    """Which (token, choice) assignments survive the capacity dispatch.

    experts [T, k] holds each token's chosen experts, best first; ``calls``
    lists (start, length) spans of consecutive tokens, each one call of the
    served model's layer (a prompt chunk, or one decode step's lanes in
    lane order). Each call is cut into :func:`dispatch_groups` equal groups.
    Within a group the assignments queue at their expert in token order,
    then choice order, and those past the expert's :func:`capacity` are
    dropped. Returns keep [T, k] bool."""
    T, k = experts.shape
    E = cfg["num_experts"]
    gsize = cfg["assumed"]["moe_group_size"]
    keep = torch.zeros((T, k), dtype=torch.bool, device=experts.device)
    for start, length in calls:
        n_groups = dispatch_groups(length, gsize)
        tg = length // n_groups
        cap = capacity(tg, cfg)
        for g in range(n_groups):
            lo = start + g * tg
            flat = experts[lo:lo + tg].reshape(-1)                 # [tg * k]
            hit = F.one_hot(flat, E)                               # [tg*k, E]
            before = (hit.cumsum(0) - hit)[torch.arange(flat.numel()), flat]
            keep[lo:lo + tg] = (before < cap).reshape(tg, k)
    return keep


def moe_layer(h, lw: dict, cfg: dict, calls, prec: Precision) -> torch.Tensor:
    """Routed experts over the capacity dispatch plus the gated shared
    expert. h [T, d] float32."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ lw["router"].float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    gates = top_p / (top_p.sum(-1, keepdim=True) + 1e-9) \
        if cfg["norm_topk_prob"] else top_p
    keep = kept_assignments(top_e, calls, cfg)
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        tok, choice = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e],
                   prec)
        out.index_add_(0, tok, y * gates[tok, choice][:, None])
    if cfg.get("shared_expert_intermediate_size"):
        sh = lw["shared"]
        gate = torch.sigmoid(h @ lw["shared_gate"].float())
        out = out + gate * swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"],
                                  prec)
    return out


def _layer_weights(tree: dict, i: int) -> dict:
    return {name: _layer_weights(v, i) if isinstance(v, dict) else v[i]
            for name, v in tree.items()}


def forward_logits(cfg: dict, weights: dict, tokens: torch.Tensor, *,
                   first: int, calls=None,
                   precision: str = "fp32") -> torch.Tensor:
    """Float32 logits [T - first, V] of positions ``first`` .. T - 1 of one
    sequence ``tokens`` [T] (prompt, then the served tokens), causal from
    position 0. ``calls``: the (start, length) spans the served model took
    the sequence in, which only a mixture of experts needs (its capacity
    groups); by default the whole sequence at once."""
    prec = Precision(precision)
    T = tokens.shape[0]
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads", H)
    hd = cfg.get("head_dim") or d // H
    eps = cfg["rms_norm_eps"]
    moe = bool(cfg.get("num_experts"))
    if calls is None:
        calls = [(0, T)]
    layers = weights["layers"]
    with exact_matmuls():
        x = weights["embed"][tokens].float()
        cos, sin = rotary(torch.arange(T, device=tokens.device), hd,
                          cfg["rope_theta"])
        for i in range(cfg["num_hidden_layers"]):
            lw = _layer_weights(layers, i)
            a = lw["attn"]
            h = rms_norm(x, lw["attn_norm"], eps)
            q = prec.mm(h, prec.weight(a["wq"])).view(T, H, hd)
            kk = prec.mm(h, prec.weight(a["wk"])).view(T, Hkv, hd)
            v = prec.mm(h, prec.weight(a["wv"])).view(T, Hkv, hd)
            o = causal_attention(apply_rotary(q, cos, sin),
                                 apply_rotary(kk, cos, sin), v)
            x = x + prec.mm(o.reshape(T, H * hd), prec.weight(a["wo"]))
            h = rms_norm(x, lw["ffn_norm"], eps)
            if moe:
                x = x + moe_layer(h, lw["moe"], cfg, calls, prec)
            else:
                f = lw["ffn"]
                x = x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec)
        x = rms_norm(x[first:], weights["final_norm"], eps)
        head = weights["embed"].T if cfg.get("tie_word_embeddings") \
            else weights["head"]
        return prec.mm(x, prec.weight(head))


def widest_gap(logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest margin, over rows, by which the logit of ``chosen[r]``
    lies below row r's best."""
    best = logits.max(dim=-1).values
    got = logits.gather(1, chosen.long()[:, None])[:, 0]
    return float((best - got).max())
