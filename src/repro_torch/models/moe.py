"""GShard-style top-k MoE with GROUPED capacity dispatch / combine, the
reference's function (``repro.models.moe``).

Tokens are split into dispatch groups of ``moe.group_size``; capacity is per
group, and each (token, k) pair takes the next slot of its expert's queue in
the group, token-major then k, so the same tokens are dropped as in the
reference. Dispatch and combine are dense one-hot tensors ``[G, Tg, E, C]``
built in the compute dtype (the gate values round to it as the reference's
do), and the expert products run over all ``E`` experts as batched matmuls:
a capacity dispatch, not a sparse gather. Every shape is static (no
``nonzero``, no host read), so a captured decode loop takes the layer as it
is. qwen2-moe-style shared experts are a dense SwiGLU with a sigmoid gate,
added to the routed output; they go through ``hetero_ctx`` under the routed
expert's site names, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import active_plan
from .layers import normal_stack, swiglu


def init_moe(cfg, generator: torch.Generator, device, n_layers: int) -> dict:
    """Stacked ``[L, ...]`` MoE weights: the router ``[L, d, E]`` (fp32),
    the experts ``[L, E, d, f]`` / ``[L, E, f, d]`` and, where the config
    has them, the shared expert and its gate ``[L, d, 1]`` (fp32, zeros),
    at the reference's scales."""
    m, d = cfg.moe, cfg.d_model
    s = 1.0 / math.sqrt(d)
    E, f = m.n_experts, m.d_ff_expert
    p = {
        "router": normal_stack(n_layers, (d, E), s, "float32", generator,
                               device),
        "w_gate": normal_stack(n_layers, (E, d, f), s, cfg.param_dtype,
                               generator, device),
        "w_up": normal_stack(n_layers, (E, d, f), s, cfg.param_dtype,
                             generator, device),
        "w_down": normal_stack(n_layers, (E, f, d), 1.0 / math.sqrt(f),
                               cfg.param_dtype, generator, device),
    }
    if m.d_ff_shared:
        fs = m.d_ff_shared
        p["shared"] = {
            "w_gate": normal_stack(n_layers, (d, fs), s, cfg.param_dtype,
                                   generator, device),
            "w_up": normal_stack(n_layers, (d, fs), s, cfg.param_dtype,
                                 generator, device),
            "w_down": normal_stack(n_layers, (fs, d), 1.0 / math.sqrt(fs),
                                   cfg.param_dtype, generator, device),
        }
        p["shared_gate"] = torch.zeros((n_layers, d, 1), dtype=torch.float32,
                                       device=device)
    return p


def _group_count(T: int, group_size: int) -> int:
    G = max(1, T // max(group_size, 1))
    while T % G:
        G -= 1
    return G


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` in ``dtype``: a comparison, so it
    reads no value on the host (``F.one_hot`` may check its range there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """The router: xt [G, Tg, D] -> (probs [G, Tg, E] fp32, gate values
    [G, Tg, k] fp32 normalised over the k, expert ids [G, Tg, k]). The
    product of compute-dtype operands with fp32 accumulation is taken on
    both widened to fp32, which is exact."""
    logits = xt.float() @ router.to(xt.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    return probs, gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9), \
        gate_idx


def moe_ffn(p: dict, x: torch.Tensor, cfg, hetero_ctx=None):
    """x: [B, S, D] -> (out [B, S, D], aux_loss, a 0-dim fp32 tensor)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = _group_count(T, m.group_size)
    Tg = T // G
    xt = x.reshape(G, Tg, D)
    probs, gate_vals, gate_idx = route(p["router"], xt, m.top_k)

    E = m.n_experts
    cap = int(max(m.top_k, math.ceil(Tg / E * m.capacity_factor * m.top_k)))
    cap = min(cap, Tg)

    # position of each (token, k) in its expert's per-group queue: a cumsum
    # over the flattened (token, k) axis, token-major then k
    onehot = _one_hot(gate_idx, E, torch.int32)                # [G, Tg, k, E]
    flat = onehot.reshape(G, Tg * m.top_k, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(
        G, Tg, m.top_k, E).amax(-1)                            # [G, Tg, k]
    keep = (pos >= 0) & (pos < cap)
    pos = torch.where(keep, pos, 0)

    cd = x.dtype
    # [G, Tg, E, C] dispatch / combine as sums of k rank-1 slot products in
    # the compute dtype (the gate values round to it, as in the reference)
    disp = torch.zeros((G, Tg, E, cap), dtype=cd, device=x.device)
    combine = torch.zeros_like(disp)
    for j in range(m.top_k):
        e_oh = _one_hot(gate_idx[..., j], E, cd) * keep[..., j, None].to(cd)
        c_oh = _one_hot(pos[..., j], cap, cd)
        outer = e_oh[..., :, None] * c_oh[..., None, :]
        disp = disp + outer
        combine = combine + outer * gate_vals[..., j, None, None].to(cd)

    expert_in = torch.einsum("gtec,gtd->gecd", disp, xt)       # [G, E, C, D]
    # a sharded step's expert-parallel rank computes its own experts and
    # combines their part of the output (summed over ranks by the caller)
    plan = active_plan()
    lo, hi = (0, E) if plan is None else plan.moe_experts(E)
    ei = expert_in[:, lo:hi].permute(1, 0, 2, 3).reshape(hi - lo, G * cap, D)
    g = torch.bmm(ei, p["w_gate"])
    u = torch.bmm(ei, p["w_up"])
    eo = torch.bmm(F.silu(g) * u, p["w_down"])
    eo = eo.reshape(hi - lo, G, cap, D).permute(1, 0, 2, 3)    # [G, e, C, D]
    out = torch.einsum("gtec,gecd->gtd", combine[:, :, lo:hi], eo)

    # Switch aux loss: E * mean_g sum_e f_e * P_e
    f = (disp.sum(-1) > 0).float().mean(1)                     # [G, E]
    aux = E * torch.mean(torch.sum(f * probs.mean(1), dim=-1))

    out = out.reshape(T, D)
    if m.d_ff_shared:
        xt2 = x.reshape(T, D)
        sg = torch.sigmoid(xt2.float() @ p["shared_gate"]).to(cd)
        out = out + sg * swiglu(p["shared"], xt2, hetero_ctx=hetero_ctx)
    return out.reshape(B, S, D), aux

