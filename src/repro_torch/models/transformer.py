"""Decoder-only (and encoder-only) transformer: dense / MoE / VLM / audio,
over a dense KV cache, a paged KV pool or no cache.

Parameters are a dict shaped like the reference's pytree: stacked per-layer
tensors under ``layers`` (leading axis L), weights in ``[K, N]`` layout
(``y = x @ w``); an MoE model has ``layers["moe"]`` (models/moe.py) where a
dense one has ``layers["ffn"]``. The layer loop is a Python loop over the
stacked axis; each iteration reads views, never copies.

The paged entry points take ``tp_group``: under tensor-parallel serving
(serving/layout.py) each rank runs this unchanged code on the config's
local head counts and its column slices of the weights, and the layers
gather the slices over the group (``layers.tp_all_gather``).

A sharded train / serve step (launch/steps.py) runs the cache-free and
dense-cache entry points under ``distributed.sharding.activation_sharding``:
each layer gathers its leaves (``gather_layer``), each block's input is
the whole sequence (``hidden_gather``) and its output goes back into the
between-blocks layout (``hidden_constraint``), the logits of a
vocabulary-sharded head are gathered (``logits_constraint``). Outside
that context the hooks return their inputs.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from ..configs import dtype_of
from ..core.partition import matmul_any
from ..device import resolve_device
from ..distributed.sharding import (data_mean, gather_layer, hidden_constraint,
                                    hidden_enter, hidden_gather,
                                    logits_constraint)
from ..training.tree import tree_leaves
from .layers import (attention, chunked_ce_loss, init_attention, init_swiglu,
                     normal_stack, paged_attention, remat, rms_norm,
                     rope_table, slot_attention, swiglu, tp_all_gather)
from .moe import init_moe, moe_ffn


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda") -> dict:
    """Random-init parameters on ``device`` (the card unless ``"cpu"`` is
    asked for), drawn from ``generator`` — a generator on that device,
    seeded 0 when None. The reference's initializer scales (embedding 0.02,
    fan-in for the projections); not the reference's random numbers."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg.param_dtype)
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    params = {
        "embed": normal_stack(1, (v, d), 0.02, cfg.param_dtype, generator,
                              device)[0],
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_stack(1, (d, v), 1.0 / math.sqrt(d),
                                      cfg.param_dtype, generator, device)[0]
    params["layers"] = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=device),
        "attn": init_attention(cfg, generator, device, L),
        "ffn_norm": torch.ones((L, d), dtype=dt, device=device),
    }
    if cfg.moe:
        params["layers"]["moe"] = init_moe(cfg, generator, device, L)
    else:
        params["layers"]["ffn"] = init_swiglu(cfg, generator, device, L)
    return params


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` tensors
    (a stacked QuantWeight indexes to its layer's codes and scales)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _layer(lp, x, cfg, attend, hetero_ctx, tp_group=None):
    """One pre-norm block; ``attend(attn_params, h) -> (out, kv)`` is the
    dense-cache, paged or cache-free attention of this layer. The FFN is
    the SwiGLU (column-sharded over ``tp_group`` when given), or the MoE
    layer (whose capacity groups are the tokens of this call). Returns (x,
    aux): the MoE layer's load-balancing loss, a 0-dim fp32 tensor, or
    None for a dense FFN (the reference's zero), which the serving entry
    points ignore and ``loss_fn`` sums."""
    lp = gather_layer(lp)
    h = hidden_gather(rms_norm(x, lp["attn_norm"], cfg.norm_eps))
    x = x + hidden_constraint(attend(lp["attn"], h)[0], "attn")
    h = hidden_gather(rms_norm(x, lp["ffn_norm"], cfg.norm_eps))
    if cfg.moe:
        out, aux = moe_ffn(lp["moe"], h, cfg, hetero_ctx=hetero_ctx)
        return x + hidden_constraint(out, "moe"), aux
    return x + hidden_constraint(swiglu(lp["ffn"], h, hetero_ctx=hetero_ctx,
                                        tp_group=tp_group), "ffn"), None


def _embed(params, inputs, cfg):
    """Token ids through the embedding; float inputs ``[B, S, D]`` (the
    modality stub's frame or patch embeddings) cast as they are."""
    if inputs.is_floating_point():
        return inputs.to(dtype_of(cfg.compute_dtype))
    return params["embed"][inputs].to(dtype_of(cfg.compute_dtype))


def _head_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _head_logits(params, x, cfg, hetero_ctx=None, tp_group=None):
    """LM-head matmul — a partitionable site like any other ("head").
    Under ``tp_group`` an untied head holds this rank's vocab columns and
    the fp32 logits are gathered along V; a tied head reads the replicated
    embedding and needs no collective."""
    if hetero_ctx is not None:
        y = hetero_ctx.matmul(x, _head_matrix(params, cfg), name="head")
    else:
        y = matmul_any(x, _head_matrix(params, cfg))
    y = logits_constraint(y.float())
    if tp_group is not None and not cfg.tie_embeddings:
        y = tp_all_gather(y, tp_group)
    return y


def unstack_layers(layers: dict, n: int) -> list[dict]:
    """The ``n`` layers' parameters as views of the stacked ``[L, ...]``
    tensors, each tensor split by one ``unbind`` (whose backward stacks the
    layers' gradients once, where indexing layer by layer would scatter
    each into a zero tensor of the whole stack); a QuantWeight indexes."""
    out = [{} for _ in range(n)]
    for name, v in layers.items():
        if isinstance(v, dict):
            parts = unstack_layers(v, n)
        elif isinstance(v, torch.Tensor):
            parts = v.unbind(0)
        else:
            parts = [v[i] for i in range(n)]
        for i in range(n):
            out[i][name] = parts[i]
    return out


def _train_layer(x, lp, cfg, positions, freqs):
    x, aux = _layer(lp, x, cfg,
                    partial(attention, cfg=cfg, positions=positions,
                            cache=None, cache_index=None, freqs=freqs), None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def loss_fn(params, inputs, targets, cfg):
    """Training objective: next-token CE + 0.01 x the MoE aux loss summed
    over layers / n_layers. inputs: [B, S] token ids or [B, S, D] float
    embeddings (the modality stub); targets: [B, S] ids. Attention is the
    cache-free branch (the flash kernel, bidirectional for an encoder-only
    config). With ``cfg.remat`` each layer is recomputed in backward
    (``layers.remat``), as the reference's ``jax.checkpoint`` per scanned
    layer. Returns (loss, {"ce", "aux"}), each a 0-dim fp32 tensor."""
    x = _embed(params, inputs, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.long, device=x.device)
    freqs = rope_table(cfg, x.device)
    x = hidden_enter(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, a = remat(cfg, _train_layer, x, lp, cfg, positions, freqs)
        aux = aux + a
    aux = data_mean(aux)
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    ce = chunked_ce_loss(_head_matrix(params, cfg), x, targets,
                         chunk=cfg.loss_chunk)
    return ce + 0.01 * aux / max(cfg.n_layers, 1), {"ce": ce, "aux": aux}


def forward_hidden(params, inputs, cfg):
    """Full-sequence hidden states with no cache (the encoder's ``encode``):
    inputs [B, S] token ids or [B, S, D] float embeddings -> the final
    norm's output [B, S, D]. Attention is bidirectional for an encoder-only
    config, else causal (layers.attention's cache-free branch)."""
    x = _embed(params, inputs, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.long, device=x.device)
    freqs = rope_table(cfg, x.device)
    x = hidden_enter(x)
    for i in range(cfg.n_layers):
        x = _layer(layer_params(params["layers"], i), x, cfg,
                   partial(attention, cfg=cfg, positions=positions,
                           cache=None, cache_index=None, freqs=freqs),
                   None)[0]
    return rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)


def stage_forward(layers: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """A run of layers (stacked ``[n, ...]`` as ``params["layers"]``) over
    hidden states ``x`` [B, S, D] with no cache, causal from position 0:
    a pipeline stage's ``layer_fn`` (distributed/pipeline.py); running
    the stages in order is running all their layers at once."""
    positions = torch.arange(x.shape[1], dtype=torch.long, device=x.device)
    freqs = rope_table(cfg, x.device)
    for lp in unstack_layers(layers, tree_leaves(layers)[0].shape[0]):
        x = _train_layer(x, lp, cfg, positions, freqs)[0]
    return x


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> dict:
    """Dense KV cache ``[L, batch, max_len, Hkv, D]`` per tensor on
    ``device`` (the card unless ``"cpu"`` is asked for), with the write
    position ``index``, an int32 scalar on the same device."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def _run_layers_dense(params, x, cfg, *, cache, hetero_ctx=None,
                      attend=attention, **attend_kw):
    """All layers over the dense cache, which is updated in place;
    ``attend`` is :func:`layers.attention` (``positions`` and
    ``cache_index`` in ``attend_kw``) or :func:`layers.slot_attention`
    (``lengths``)."""
    freqs = rope_table(cfg, x.device)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x = _layer(layer_params(params["layers"], i), x, cfg,
                   partial(attend, cfg=cfg, cache=layer_cache, freqs=freqs,
                           hetero_ctx=hetero_ctx, **attend_kw),
                   hetero_ctx)[0]
    return x


def prefill(params, tokens, cache, cfg, *, start_index=0, hetero_ctx=None):
    """Process a prompt (or a prompt chunk, for chunked prefill): write the
    cache at ``[start_index, start_index + S)`` in place and return
    (last-token logits ``[B, 1, V]``, cache with ``index = start + S``).
    ``start_index`` is a host int or a 0-dim device tensor (a captured
    prefill: the positions, the writes and the attention's mask come from
    it on the device, ``layers.attention``)."""
    S = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = chunk_positions(start_index, S, x.device)
    x = _run_layers_dense(params, hidden_enter(x), cfg, cache=cache,
                          hetero_ctx=hetero_ctx, positions=positions,
                          cache_index=start_index)
    x = rms_norm(hidden_gather(x), params["final_norm"], cfg.norm_eps)
    logits = _head_logits(params, x[:, -1:, :], cfg, hetero_ctx)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "index": chunk_end(start_index, S, x.device)}


def decode_step(params, token, cache, cfg, *, hetero_ctx=None):
    """One autoregressive step. token: [B, 1]. The write position
    ``cache["index"]`` is a device scalar (a uniform batch: the
    decode-attention kernel) or a [B] tensor of per-slot positions (the
    draft lanes of speculative decoding: ``layers.slot_attention``, plain
    torch); it stays on the device, nothing in the step reads it on the
    host. Returns (logits [B, 1, V], cache with ``index + 1``)."""
    idx = cache["index"]
    x = _embed(params, token, cfg)
    if idx.ndim == 1:
        if idx.shape[0] != x.shape[0]:
            raise ValueError(f"per-slot indices for {idx.shape[0]} lanes, "
                             f"tokens for {x.shape[0]}")
        x = _run_layers_dense(params, x, cfg, cache=cache,
                              hetero_ctx=hetero_ctx, attend=slot_attention,
                              lengths=idx)
    else:
        x = _run_layers_dense(params, x, cfg, cache=cache,
                              hetero_ctx=hetero_ctx,
                              positions=idx.reshape(1).long(),
                              cache_index=idx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head_logits(params, x, cfg, hetero_ctx)
    return logits, {"k": cache["k"], "v": cache["v"], "index": idx + 1}


def prefill_slot(params, cache, tokens, slot: int, start: int, cfg):
    """Prefill one prompt chunk (tokens ``[C]``) of one request into lane
    ``slot`` of a batched dense cache (``[L, B, S, Hkv, D]``) at position
    ``start``: :func:`prefill` on the ``[L, 1, S, Hkv, D]`` view of the
    slot, which it writes in place (so its attention is the flash kernel).
    ``slot`` and ``start`` are host ints. The draft lanes' prompt prefill
    (serving/spec.py). Returns (last-token logits [1, 1, V], cache)."""
    view = {"k": cache["k"][:, slot:slot + 1],
            "v": cache["v"][:, slot:slot + 1]}
    logits, _ = prefill(params, tokens[None, :], view, cfg, start_index=start)
    return logits, cache


def init_paged_cache(cfg, *, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, kv_quant: str | None = None,
                     device="cuda") -> dict:
    """Shared KV page pool ``[L, num_blocks, block_size, Hkv, D]`` per
    tensor on ``device`` (the card unless ``"cpu"`` is asked for). Block 0
    is the null block (see serving/paged_cache.py).

    ``kv_quant='int8'`` stores int8 codes plus one bf16 scale per (layer,
    slot, tensor): ``k_scale``/``v_scale`` ``[L, num_blocks, block_size]``,
    written on scatter and read in the gather (layers.paged_attention).
    Zero scales mark unwritten slots."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if kv_quant is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kv_quant != "int8":
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device)}


def _run_layers_paged(params, x, cfg, *, positions, pool, block_table,
                      hetero_ctx=None, tp_group=None):
    """All layers over the paged pool, which is updated in place."""
    freqs = rope_table(cfg, x.device)
    for i in range(cfg.n_layers):
        layer_pool = {name: t[i] for name, t in pool.items()}
        x = _layer(layer_params(params["layers"], i), x, cfg,
                   partial(paged_attention, cfg=cfg, positions=positions,
                           pool=layer_pool, block_table=block_table,
                           freqs=freqs, hetero_ctx=hetero_ctx,
                           tp_group=tp_group), hetero_ctx, tp_group)[0]
    return x, pool


def chunk_positions(start_index, S: int, device) -> torch.Tensor:
    """Absolute positions of ``S`` tokens from ``start_index``: a host int
    or 0-dim tensor (a uniform batch) -> [S]; a [B] tensor of per-lane
    starts -> [B, S]."""
    if isinstance(start_index, int):
        return torch.arange(start_index, start_index + S, dtype=torch.long,
                            device=device)
    start = torch.as_tensor(start_index, device=device).long()
    steps = torch.arange(S, dtype=torch.long, device=device)
    return start[:, None] + steps[None, :] if start.ndim == 1 else start + steps


def chunk_end(start_index, S: int, device) -> torch.Tensor:
    """A dense cache's ``index`` after a chunk of ``S`` tokens at
    ``start_index`` (a host int or a 0-dim device tensor, which stays on
    the device): ``start + S``, an int32 scalar."""
    if isinstance(start_index, int):
        return torch.full((), start_index + S, dtype=torch.int32,
                          device=device)
    return (start_index + S).to(torch.int32)


def starts_prompt(start_index, fresh) -> bool:
    """Whether a recurrent family's prefill chunk at ``start_index`` starts
    the prompt (its states start from zero): an int start says so itself,
    a device start's caller must (``fresh``), as nothing reads the start on
    the host."""
    if isinstance(start_index, int):
        if fresh is not None and fresh != (start_index == 0):
            raise ValueError(f"fresh={fresh} at start {start_index}")
        return start_index == 0
    if fresh is None:
        raise ValueError("a device start_index needs fresh= (whether the "
                         "chunk starts the prompt)")
    return fresh


def paged_prefill(params, tokens, pool, cfg, *, block_table, start_index=0,
                  hetero_ctx=None, tp_group=None):
    """Prefill a prompt chunk into the request's pages. tokens: [B, S];
    block_table: [B, NBmax]; ``start_index`` an int (uniform batch) or a
    [B] tensor of per-lane starts. Returns (last-token logits [B, 1, V],
    pool)."""
    x = _embed(params, tokens, cfg)
    positions = chunk_positions(start_index, tokens.shape[1], x.device)
    x, pool = _run_layers_paged(params, x, cfg, positions=positions,
                                pool=pool, block_table=block_table,
                                hetero_ctx=hetero_ctx, tp_group=tp_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x[:, -1:, :], cfg, hetero_ctx,
                        tp_group), pool


def paged_verify(params, tokens, pool, cfg, *, block_table, start_index,
                 hetero_ctx=None, tp_group=None):
    """Speculative-decoding verification: append ``tokens`` ([B, K+1], each
    lane's pending token and its K drafts) after each lane's cached prefix
    and return the logits of EVERY position, [B, K+1, V]. ``start_index``:
    [B] per-lane write positions, or an int. Rejected positions are
    reclaimed afterwards by ``PagedKVCache.truncate_to``; their stale slots
    are masked positionally and rewritten before a later query reads
    them. A ``hetero_ctx`` made by ``for_verify`` routes the M = B·(K+1)
    matmuls through the solver's VERIFY decisions. Returns (logits, pool).
    """
    x = _embed(params, tokens, cfg)
    positions = chunk_positions(start_index, tokens.shape[1], x.device)
    x, pool = _run_layers_paged(params, x, cfg, positions=positions,
                                pool=pool, block_table=block_table,
                                hetero_ctx=hetero_ctx, tp_group=tp_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x, cfg, hetero_ctx, tp_group), pool


def mixed_step(params, decode_tokens, prefill_tokens, pool, cfg, *,
               decode_tables, decode_lengths, prefill_table, prefill_start=0,
               hetero_ctx=None, tp_group=None):
    """Stage-parallel mixed batch: one batched paged decode step of every
    lane AND one prefill chunk of an admitting request, over the same pool.
    Per layer the decode lanes run first, with no ``hetero_ctx`` (the
    flexible path), then the chunk, through ``hetero_ctx``; their block
    tables are disjoint, so the order changes no number. decode_tokens:
    [W, 1]; prefill_tokens: [1, C]; decode_tables: [W, NBmax];
    decode_lengths: [W]; prefill_table: [1, NBmax]; ``prefill_start`` an
    int or a 0-dim device tensor. The pool is written in place. Returns
    (decode logits [W, 1, V], prefill logits [1, 1, V], pool); the decode
    head stays on the flexible path."""
    xd = _embed(params, decode_tokens, cfg)
    xp = _embed(params, prefill_tokens, cfg)
    dec_pos = decode_lengths[:, None].long()
    pre_pos = chunk_positions(prefill_start, prefill_tokens.shape[1],
                              xp.device)
    freqs = rope_table(cfg, xd.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        layer_pool = {name: t[i] for name, t in pool.items()}
        xd = _layer(lp, xd, cfg,
                    partial(paged_attention, cfg=cfg, positions=dec_pos,
                            pool=layer_pool, block_table=decode_tables,
                            freqs=freqs, tp_group=tp_group), None,
                    tp_group)[0]
        xp = _layer(lp, xp, cfg,
                    partial(paged_attention, cfg=cfg, positions=pre_pos,
                            pool=layer_pool, block_table=prefill_table,
                            freqs=freqs, hetero_ctx=hetero_ctx,
                            tp_group=tp_group), hetero_ctx, tp_group)[0]
    xd = rms_norm(xd, params["final_norm"], cfg.norm_eps)
    xp = rms_norm(xp, params["final_norm"], cfg.norm_eps)
    return (_head_logits(params, xd, cfg, tp_group=tp_group),
            _head_logits(params, xp[:, -1:, :], cfg, hetero_ctx, tp_group),
            pool)


def paged_decode_step(params, token, pool, cfg, *, block_tables, lengths,
                      hetero_ctx=None, tp_group=None):
    """One batched decode step over the page pool. token: [B, 1];
    block_tables: [B, NBmax]; lengths: [B] per-request write positions.
    Inactive lanes (length 0, null table) sink writes into the null block.
    Returns (logits [B, 1, V], pool)."""
    x = _embed(params, token, cfg)
    positions = lengths[:, None].long()
    x, pool = _run_layers_paged(params, x, cfg, positions=positions,
                                pool=pool, block_table=block_tables,
                                hetero_ctx=hetero_ctx, tp_group=tp_group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x, cfg, hetero_ctx, tp_group), pool
