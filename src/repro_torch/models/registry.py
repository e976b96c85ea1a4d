"""Uniform model interface over the ported families (dense for now).

``build_model(cfg)`` returns a ``Model`` whose members are plain functions:
    init(generator=None, device="cuda") -> params
    init_cache(batch, max_len, dtype=, device=) -> dense cache
    prefill(params, tokens, cache, start_index=) -> (last_logits, cache)
    decode_step(params, token, cache) -> (logits, cache)
    init_paged_cache(num_blocks=, block_size=, dtype=, kv_quant=, device=)
        -> pool
    paged_prefill(params, tokens, pool, block_table=, start_index=)
        -> (last_logits, pool)
    paged_decode_step(params, token, pool, block_tables=, lengths=)
        -> (logits, pool)
Every step accepts ``hetero_ctx=``; partitioning is an execution
schedule, never a numerics change beyond the order of fp32 sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

from . import transformer


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_cache: Callable
    paged_prefill: Callable
    paged_decode_step: Callable


def build_model(cfg) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: only the dense family is "
                                  "ported")
    return Model(
        cfg=cfg,
        init=partial(transformer.init_params, cfg),
        init_cache=partial(transformer.init_cache, cfg),
        prefill=partial(transformer.prefill, cfg=cfg),
        decode_step=partial(transformer.decode_step, cfg=cfg),
        init_paged_cache=partial(transformer.init_paged_cache, cfg),
        paged_prefill=partial(transformer.paged_prefill, cfg=cfg),
        paged_decode_step=partial(transformer.paged_decode_step, cfg=cfg),
    )
