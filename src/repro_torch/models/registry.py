"""Uniform model interface over every family of the reference: the dense,
MoE, VLM and audio transformers, the zamba2-style Mamba2 hybrid and RWKV-6.

``build_model(cfg)`` returns a ``Model`` whose members are plain functions:
    init(generator=None, device="cuda") -> params
    loss(params, inputs, targets) -> (loss, {"ce", "aux"})  [train objective
        of every family: the transformer (dense, MoE, VLM, audio), the
        hybrid and RWKV]
    init_cache(batch, max_len, dtype=, device=) -> dense cache
    prefill(params, tokens, cache, start_index=) -> (last_logits, cache)
    decode_step(params, token, cache) -> (logits, cache)
An encoder-only config (hubert) has none of these but ``init``, and exposes
``encode(params, inputs) -> hidden states`` instead (token ids or float
frame embeddings; bidirectional attention, no cache).
Attention-family models (the transformer: dense, MoE, VLM) additionally
expose the paged-KV trio used by the serving scheduler
(serving/scheduler.py::PagedBatcher); they are None for the hybrid and
RWKV, whose recurrent state is O(1) and needs no paging:
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

from . import mamba2, rwkv6, transformer


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    init_cache: Optional[Callable]
    prefill: Optional[Callable]
    decode_step: Optional[Callable]
    encode: Optional[Callable] = None
    loss: Optional[Callable] = None
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
    if cfg.rwkv is not None:
        mod = rwkv6
    elif cfg.ssm is not None:
        mod = mamba2
    else:
        mod = transformer
    init = partial(mod.init_params, cfg)
    loss = partial(mod.loss_fn, cfg=cfg)
    if cfg.encoder_only:
        return Model(cfg=cfg, init=init, init_cache=None, prefill=None,
                     decode_step=None, loss=loss,
                     encode=partial(transformer.forward_hidden, cfg=cfg))
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
        cfg=cfg, init=init, loss=loss,
        init_cache=partial(mod.init_cache, cfg),
        prefill=partial(mod.prefill, cfg=cfg),
        decode_step=partial(mod.decode_step, cfg=cfg),
        **paged,
    )
