"""Uniform model interface over the ported families: the dense
decoder-only transformer and the zamba2-style Mamba2 hybrid.

``build_model(cfg)`` returns a ``Model`` whose members are plain functions:
    init(generator=None, device="cuda") -> params
    init_cache(batch, max_len, dtype=, device=) -> dense cache
    prefill(params, tokens, cache, start_index=) -> (last_logits, cache)
    decode_step(params, token, cache) -> (logits, cache)
Attention-family models (dense) additionally expose the paged-KV trio used
by the serving scheduler (serving/scheduler.py::PagedBatcher); they are
None for the hybrid, whose recurrent state is O(1) and needs no paging:
    init_paged_cache(num_blocks=, block_size=, dtype=, kv_quant=, device=)
        -> pool
    paged_prefill(params, tokens, pool, block_table=, start_index=)
        -> (last_logits, pool)
    paged_decode_step(params, token, pool, block_tables=, lengths=)
        -> (logits, pool)
    paged_verify(params, tokens, pool, block_table=, start_index=)
        -> (per_position_logits, pool)
    mixed_step(params, decode_tokens, prefill_tokens, pool,
               decode_tables=, decode_lengths=, prefill_table=,
               prefill_start=) -> (decode_logits, prefill_logits, pool)
and ``prefill_slot(params, cache, tokens, slot, start)`` -> (last_logits,
cache), one request's chunk into one slot of a batched dense cache (the
draft lanes of speculative decoding; ``decode_step`` then takes a [B]
``cache["index"]``). Every step accepts ``hetero_ctx=``; partitioning is an execution
schedule, never a numerics change beyond the order of fp32 sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

from . import mamba2, transformer

# what each family of the reference still needs in the port
_NOT_PORTED = {
    "moe": "models/moe.py and the MoE configs",
    "ssm": "models/rwkv6.py and the RWKV configs",
    "audio": "the encoder-only path (forward_hidden)",
    "vlm": "the chameleon config",
}


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_cache: Optional[Callable] = None
    paged_prefill: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None
    # speculative decoding: K+1-position verification in one dispatch
    paged_verify: Optional[Callable] = None
    # stage-parallel mixed batch: one batched paged decode step for all
    # lanes and one prefill chunk, over one pool
    mixed_step: Optional[Callable] = None
    # one request's prompt chunk into one slot of a batched dense cache
    prefill_slot: Optional[Callable] = None


def build_model(cfg) -> Model:
    if cfg.family == "hybrid" and cfg.ssm is not None:
        mod = mamba2
    elif cfg.family == "dense":
        mod = transformer
    else:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported (it needs "
            f"{_NOT_PORTED.get(cfg.family, 'its model module')})")
    paged = {}
    if mod is transformer:
        paged = dict(
            init_paged_cache=partial(transformer.init_paged_cache, cfg),
            paged_prefill=partial(transformer.paged_prefill, cfg=cfg),
            paged_decode_step=partial(transformer.paged_decode_step, cfg=cfg),
            paged_verify=partial(transformer.paged_verify, cfg=cfg),
            mixed_step=partial(transformer.mixed_step, cfg=cfg),
            prefill_slot=partial(transformer.prefill_slot, cfg=cfg),
        )
    return Model(
        cfg=cfg,
        init=partial(mod.init_params, cfg),
        init_cache=partial(mod.init_cache, cfg),
        prefill=partial(mod.prefill, cfg=cfg),
        decode_step=partial(mod.decode_step, cfg=cfg),
        **paged,
    )
