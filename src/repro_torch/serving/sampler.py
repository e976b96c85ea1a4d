"""Token sampling — greedy / temperature / top-k / top-p — plus the
speculative-decoding acceptance rule (``greedy_verify``)."""
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


def greedy_verify(draft_tokens: torch.Tensor, target_logits: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy speculative acceptance (lossless: the emitted stream is what
    per-token greedy decoding of the target gives, whatever the drafts).

    draft_tokens: [B, K], each lane's drafts; target_logits: [B, K+1, V]
    from one ``paged_verify``, position ``j`` scoring the token after the
    j-th appended one. A draft is accepted while it equals the target's
    greedy choice (``argmax``: ties go to the first maximal index); the
    first mismatch contributes the target's token, full acceptance the
    bonus token after the last draft. Returns (emitted [B, K+1],
    n_emitted [B]): ``emitted[b, :n_emitted[b]]`` is lane b's stream for
    the round, 1..K+1 tokens; the slots past it hold the target's greedy
    tokens, which callers ignore."""
    greedy = torch.argmax(target_logits, dim=-1)                 # [B, K+1]
    drafts = draft_tokens.to(greedy.dtype)
    match = drafts == greedy[:, :-1]
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    slots = torch.arange(greedy.shape[1], device=greedy.device)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    emitted = torch.where(slots < accepted[:, None], drafts_pad, greedy)
    return emitted, accepted + 1
