"""HeteroInfer inference engine (paper §4.4, Fig 11) on the card.

Offline: profile the model's weight shapes, solve the per-(site, M)
partitioning decisions, and wrap the plan in the HeteroCtx the models
thread through every matmul. Online, per request: split the prompt by the
prefill strategy for its actual length, prefill through the HeteroCtx, and
decode with fast synchronisation (the whole loop one CUDA graph replay) or
host synchronisation (one replayed step per token, each token read back).

Engine modes (the paper's evaluation arms):
  'xla'            — flexible path only
  'mxu'            — aligned path only, padded to 128
  'hetero-layer'   — per-op affinity by token count (§4.1)
  'hetero-tensor'  — solver-driven tensor partitioning (§4.2)

Prefill strategies for dynamic lengths (paper §5.3.2 / Fig 14):
  'online-prepare' — one chunk at the exact length
  'padding'        — one chunk; the plan's PAD decisions pad inside matmuls
  'pipe'           — standard-bucket chunks over the first S-1 tokens (the
                     tail padded to the smallest bucket), then one exact
                     1-token chunk
  'hetero'         — standard-bucket chunks plus the ragged remainder
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs import dtype_of
from ..device import resolve_device
from ..models import build_model
from ..serving.telemetry import MonotonicClock
from .partition import HeteroCtx
from .profiler import STANDARD_BUCKETS, LatencyTable, profile_analytic
from .solver import PartitionPlan, PartitionSolver
from .sync import (CapturedLoop, decode_loop, fence, generate_host_loop,
                   generate_on_device, graph_pool, loop_stats, make_call,
                   stage)

PREFILL_STRATEGIES = ("online-prepare", "padding", "pipe", "hetero")


def build_plan(cfg, *, sync_mode: str = "fast",
               table: Optional[LatencyTable] = None, mixed_pairs=(),
               verify_ks=(), extra_ms=(),
               weight_quant: Optional[str] = None
               ) -> tuple[LatencyTable, PartitionPlan]:
    """Profile and solve: the analytic table of the reference's cost model
    unless ``table`` is given (e.g. ``profile_measured`` on the card),
    whose spec then prices the split candidates. ``mixed_pairs``: (prefill
    chunk, decode width) pairs solved into ``plan.mixed_decisions``;
    ``verify_ks``: (k, lanes) verification shapes solved into
    ``plan.verify_decisions``; ``extra_ms``: token counts added to the
    solve grid. ``weight_quant`` (None | 'int8' | 'w4a16') prices the
    weight stream at the quantized bytes, so a quantized deployment gets
    its own plan."""
    table = table or profile_analytic(cfg, weight_quant=weight_quant)
    solver = PartitionSolver(table, sync_mode=sync_mode,
                             weight_quant=weight_quant)
    return table, solver.solve(cfg, mixed_pairs=mixed_pairs,
                               verify_ks=verify_ks, extra_ms=extra_ms)


def build_hetero_ctx(cfg, mode: str, *, sync_mode: str = "fast",
                     table: Optional[LatencyTable] = None, mixed_pairs=(),
                     verify_ks=(), extra_ms=(),
                     weight_quant: Optional[str] = None) -> HeteroCtx:
    """Profile + solve (``build_plan``) and wrap the plan in the HeteroCtx
    covering every matmul site, the LM head included."""
    _, plan = build_plan(cfg, sync_mode=sync_mode, table=table,
                         mixed_pairs=mixed_pairs, verify_ks=verify_ks,
                         extra_ms=extra_ms, weight_quant=weight_quant)
    return HeteroCtx(mode=mode, plan=plan)


def dispatch_prediction(plan, cfg, *, m=None, steps: int = 1,
                        mixed=None, verify=None):
    """Decision tags and predicted duration of ONE scheduler dispatch:
    ``(tags, total_us)``, tags a tuple of ``(site, M, strategy, t_us,
    count)``, one per planned site, where ``count`` is how often the site's
    matmul runs in the dispatch: ``steps`` forward passes, each hitting
    every site but ``head`` ``cfg.n_layers`` times and ``head`` once. One
    shape selector applies: ``m`` (an M-token dispatch, nearest solved M),
    ``mixed=(m_prefill, m_decode)`` (a fused mixed step) or ``verify=(k,
    lanes)`` (spec verification). The serving tracer tags each dispatch
    span with these and the drift report scores them against the measured
    durations. ``plan=None`` (no engine mode) gives ``((), 0.0)``."""
    if plan is None:
        return (), 0.0
    sites = sorted({s for (s, _) in plan.decisions})
    tags, total = [], 0.0
    for site in sites:
        if verify is not None:
            k, lanes = verify
            dec = plan.verify_decision(site, k, lanes) \
                or plan.lookup(site, lanes * (k + 1))
        elif mixed is not None:
            mp, md = mixed
            dec = plan.mixed_decision(site, mp, md) \
                or plan.lookup(site, mp + md)
        else:
            dec = plan.lookup(site, 1 if m is None else m)
        if dec is None:
            continue
        count = steps * (1 if site == "head" else cfg.n_layers)
        tags.append((site, dec.M, dec.strategy, dec.t_us, count))
        total += dec.t_us * count
    return tuple(tags), total


@dataclass
class EngineStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    compile_s: float = 0.0
    n_compiles: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0

    def tokens_per_s(self) -> dict:
        return {
            "prefill_tok_s": self.prefill_tokens / self.prefill_s
            if self.prefill_s else 0.0,
            "decode_tok_s": self.decode_tokens / self.decode_s
            if self.decode_s else 0.0,
        }


class InferenceEngine:
    """One request at a time over a dense KV cache sized to it.

    Prefill runs through the HeteroCtx; decode runs without one, as in the
    reference. Attention goes through the flash-attention kernel in
    prefill and the decode-attention kernel in decode. The engine keeps one
    cache per (batch, length, dtype) it has seen and, on the card, one
    captured decode loop per cache and step count (``core/sync.py``): a
    graph bakes in the addresses of the weights and the cache, so both live
    on this instance and a later request of the same shape prefills into
    the same cache and replays the same graph. Each prefill chunk is one
    captured call too (``core/sync.py::make_call``), one per chunk length
    over that cache (and, for the recurrent families, whether the chunk
    starts the prompt), its start a device scalar, so one graph serves a
    chunk length at any start; the calls share one memory pool.
    ``stats.n_compiles`` counts what the reference's jit cache counts: the
    distinct chunk lengths seen, and each capture of a decode loop;
    ``stats.compile_s`` is the time of those first calls and captures
    (which includes building and loading the kernels on the first call of a
    process). Timing reads ``clock`` (``MonotonicClock`` unless one is
    injected)."""

    def __init__(self, cfg, params=None, *, mode: str = "hetero-tensor",
                 prefill_strategy: str = "hetero", fast_sync: bool = True,
                 table: Optional[LatencyTable] = None,
                 plan: Optional[PartitionPlan] = None,
                 buckets: tuple = STANDARD_BUCKETS, clock=None,
                 device="cuda"):
        if prefill_strategy not in PREFILL_STRATEGIES:
            raise ValueError(f"unknown prefill strategy {prefill_strategy!r}")
        self.clock = clock if clock is not None else MonotonicClock()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if self.model.prefill is None:
            raise ValueError(f"{cfg.name} is encoder-only: it has no prefill "
                             "or decode step to generate with (use "
                             "build_model(cfg).encode)")
        self.params = params if params is not None else self.model.init(
            device=self.device)
        self.mode = mode
        self.prefill_strategy = prefill_strategy
        self.fast_sync = fast_sync
        self.buckets = tuple(sorted(buckets))
        if plan is None:
            self.table, self.plan = build_plan(
                cfg, sync_mode="fast" if fast_sync else "host", table=table)
        else:
            self.table, self.plan = table or profile_analytic(cfg), plan
        self.ctx = HeteroCtx(mode=mode, plan=self.plan)
        self.stats = EngineStats()
        self._prefill = partial(self.model.prefill, hetero_ctx=self.ctx)
        # a Mamba2 or RWKV chunk from position 0 starts from zero states
        self._recurrent = cfg.ssm is not None or cfg.rwkv is not None
        self._seen_lengths: set[int] = set()
        self._caches: dict[tuple, dict] = {}      # (B, max_len, dtype)
        self._loops: dict[tuple, object] = {}     # loop_key -> decode loop
        self._calls: dict[tuple, object] = {}     # call_key -> prefill call
        self._pool = graph_pool(self.device)      # the prefill calls' pool

    def _bucket_chunks(self, S: int) -> list[tuple[int, int]]:
        """Split S into (chunk length, true tokens) pieces."""
        if self.prefill_strategy in ("online-prepare", "padding"):
            return [(S, S)]     # padding happens inside matmuls (PAD decisions)
        chunks, rem = [], S
        if self.prefill_strategy == "pipe":
            rem = S - 1         # the last token gets an exact 1-token chunk
        for b in sorted(self.buckets, reverse=True):
            while rem >= b:
                chunks.append((b, b))
                rem -= b
        if self.prefill_strategy == "pipe":
            if rem:
                chunks.append((min(self.buckets), rem))       # padded tail
            chunks.append((1, 1))
        elif rem:
            chunks.append((rem, rem))   # hetero: ragged remainder
        return chunks

    def generate(self, prompt, max_new_tokens: int = 32) -> torch.Tensor:
        """Greedy generation. prompt: [B, S] token ids (tensor or array).
        Returns [B, max_new_tokens] on the engine's device."""
        prompt = torch.as_tensor(prompt).to(self.device, torch.long)
        B, S = prompt.shape
        # pipe's padded tail writes up to min(buckets) - 1 slots past S
        pad_headroom = (min(self.buckets) if self.prefill_strategy == "pipe"
                        else 0)
        n_steps = max_new_tokens - 1
        max_len = S + max_new_tokens + pad_headroom
        cache, loop = self._decoder(B, max_len, n_steps)

        t0 = self.clock.now()
        idx, logits = 0, None
        for c, take in self._bucket_chunks(S):
            piece = prompt[:, idx: idx + take]
            if take < c:                # pipe's padded tail
                piece = F.pad(piece, (0, c - take))
            new = c not in self._seen_lengths
            if new:
                self._seen_lengths.add(c)
                self.stats.n_compiles += 1
            tc = self.clock.now()
            logits = self.prefill_chunk(cache, max_len, piece, idx)
            if new:                     # the first call of a chunk length
                fence(logits)
                self.stats.compile_s += self.clock.now() - tc
            idx += take
        cache = {**cache, "index": torch.full((), S, dtype=torch.int32,
                                              device=self.device)}
        fence(logits)
        self.stats.prefill_s += self.clock.now() - t0
        self.stats.prefill_tokens += B * S

        first = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        t0 = self.clock.now()
        if n_steps > 0:
            if self.fast_sync:
                toks, cache = generate_on_device(loop, first, cache)
            else:
                toks, cache = generate_host_loop(loop, first, cache, n_steps)
            out = torch.cat([first, toks], dim=1)
        else:
            out = first
        fence(out)
        self.stats.decode_s += self.clock.now() - t0
        self.stats.decode_tokens += B * max_new_tokens
        return out

    def prefill_chunk(self, cache, max_len: int, piece,
                      start: int) -> torch.Tensor:
        """One prompt chunk ``piece`` ([B, C] on the engine's device) into
        the (B, ``max_len``) ``cache`` at ``start``: the captured call of its
        key (made at the key's first chunk) on the chunk and its start,
        staged as a device scalar. Returns a copy of the last-token logits
        [B, 1, V]."""
        B, C = piece.shape
        fresh = start == 0
        key = self.call_key(C, B, max_len, fresh)
        if key not in self._calls:
            kw = {"fresh": fresh} if self._recurrent else {}

            def body(tokens, at):
                return self._prefill(self.params, tokens, cache,
                                     start_index=at, **kw)[0]

            self._calls[key] = make_call(body, self.device, pool=self._pool)
        return self._calls[key](piece, *stage(start,
                                              device=self.device)).clone()

    def call_key(self, C: int, B: int, max_len: int, fresh: bool) -> tuple:
        """The key of the captured prefill call of a ``C``-token chunk over
        the (B, max_len) cache: all that its graph bakes in beyond this
        instance's weights; for the recurrent families whether the chunk
        starts the prompt (their states then start from zero)."""
        key = ("prefill", C, B, max_len, dtype_of(self.cfg.compute_dtype))
        return key + (fresh,) if self._recurrent else key

    def loop_key(self, B: int, max_len: int, n_steps: int) -> tuple:
        """The key of the decode loop over the (B, max_len) cache: all that
        its graph bakes in beyond this instance's weights."""
        dtype = dtype_of(self.cfg.compute_dtype)
        if self.fast_sync:
            return ("fast", B, max_len, dtype, n_steps)
        return ("host", B, max_len, dtype)

    def _decoder(self, B: int, max_len: int, n_steps: int):
        """(cache, decode loop) for a request of this shape, made before the
        prefill writes the cache (see ``decode_loop``); the loop is None when
        no step is decoded. A capture on the card counts as a compile."""
        dtype = dtype_of(self.cfg.compute_dtype)
        cache = self._caches.get((B, max_len, dtype))
        if cache is None:
            cache = self.model.init_cache(batch=B, max_len=max_len,
                                          dtype=dtype, device=self.device)
            self._caches[(B, max_len, dtype)] = cache
        if n_steps < 1:
            return cache, None
        key = self.loop_key(B, max_len, n_steps)
        if key not in self._loops:
            tc = self.clock.now() if self.device.type == "cuda" else 0.0
            loop = self._loops[key] = decode_loop(
                self.model, self.params, cache, n_steps,
                host_sync=not self.fast_sync)
            if isinstance(loop, CapturedLoop):
                self.stats.n_compiles += 1
                self.stats.compile_s += self.clock.now() - tc
        return cache, self._loops[key]

    def graph_stats(self) -> dict:
        """Decode graphs captured, their replays and pool bytes, and under
        ``calls`` the same of the prefill graphs (pool bytes: their one
        shared pool's); none on the CPU, where both run eagerly."""
        return {**loop_stats(self._loops.values()),
                "calls": loop_stats(self._calls.values())}

    def predicted_prefill_us(self, S: int) -> float:
        """Solver-predicted prefill matmul latency for length S over all
        layers (the LM head excluded), from the plan's latency table,
        priced on the table's spec."""
        solver = PartitionSolver(self.table, sync_mode="fast"
                                 if self.fast_sync else "host")
        total = sum(solver.solve_site(site, max(S, 1)).t_us
                    for site in self.table.sites if site != "head")
        return total * self.cfg.n_layers
