"""AdamW with global-norm clipping over a dict of parameter tensors, the
reference's ``repro.training.optimizer``.

Moments are fp32. The state is a plain dict ``{"params", "m", "v", "step"}``
(``step`` an int32 0-dim tensor on the parameters' device), so it
checkpoints as it is. ``apply_updates`` keeps the reference's arithmetic
order (clip scale, bias corrections, decoupled decay on matrices only, the
update in fp32, cast back) and writes params, m and v IN PLACE: the
reference donates the old state to its jitted step, and at full width a
second copy of the moments would not fit beside the first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_state(params: dict, cfg: AdamWConfig | None = None) -> dict:
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"params": params, "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine to 0.1 x lr, in fp32 (step: int32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply_updates(state: dict, grads: dict, cfg: AdamWConfig, *,
                  grad_norm: torch.Tensor | None = None
                  ) -> tuple[dict, dict]:
    """One AdamW step: params, m and v updated in place, ``step`` + 1.
    ``grad_norm``: the global norm of a sharded step's gradients (each
    rank holding its blocks), else :func:`global_norm` of ``grads``.
    Returns (state, {"grad_norm": the unclipped norm, "lr"})."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:     # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)

    tree_map(upd, state["params"], grads, state["m"], state["v"])
    new_state = {"params": state["params"], "m": state["m"],
                 "v": state["v"], "step": step}
    return new_state, {"grad_norm": gn, "lr": lr}
