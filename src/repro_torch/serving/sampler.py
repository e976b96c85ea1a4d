"""Token sampling — greedy / temperature / top-k / top-p."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => off
    top_p: float = 1.0            # 1 => off


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Temperature-scale then mask logits outside the top-k / top-p support
    to -inf. logits [B, V] -> [B, V]. Scaling applies only when
    ``temperature > 0``; ``top_k`` is clamped to the vocab size."""
    if cfg.temperature > 0.0:
        logits = logits / cfg.temperature
    if cfg.top_k:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int64). Greedy ties go to the first
    maximal index, as ``jnp.argmax``. Temperature sampling draws from
    ``generator`` (its numbers differ from the reference's JAX keys)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.float(), cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
