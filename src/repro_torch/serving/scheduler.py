"""Continuous batching over the paged KV pool (``PagedBatcher``).

Admission is gated by FREE BLOCKS: a request is admitted when
``ceil((len(prompt) + max_new_tokens) / block_size)`` blocks can be
reserved, up to ``decode_width`` decode lanes. Prompts prefill as bucket
chunks (``bucket_chunks``), finished requests return their blocks and the
queue backfills. The HeteroInfer engine rides the serving path:

  * ``sync='device'`` — fast-sync decode (§4.3): a window of ``window``
    decode steps per host round-trip (core/sync.py ``paged_window_loop``).
    ``sync='host'`` reads each token back to the host (the baseline arm).
    On the card both replay CUDA graphs that this batcher captured at its
    first window or tick (the window's steps, or the tick's one step; the
    tick samples outside its graph), whose inputs are staged on the host
    and copied into the graph's buffers; the CPU runs the same loops
    eagerly.
  * ``engine_mode=...`` — solver-planned prefill (§4.1/§4.2): prefill chunk
    matmuls run through a ``HeteroCtx`` holding the solver's plan. Decode
    stays on the flexible path, as in the reference.

``weight_quant`` ('int8' | 'w4a16') serves quantized weights and
``kv_quant='int8'`` an int8 KV pool (see :class:`PagedBatcher`).

Greedy outputs are the same across engine modes and sync arms (the
reference's invariant). Mixed batching, speculative decoding, the prefix
cache, tensor parallelism and tracing are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..configs import dtype_of
from ..core.sync import loop_stats, paged_step_loop, paged_window_loop
from ..device import resolve_device
from ..models import build_model
from ..models.quant import WEIGHT_FORMATS, quantize_params
from .paged_cache import PagedKVCache, SequenceBlocks
from .sampler import SamplerConfig, sample


PREFILL_BUCKETS = (64, 128, 256)      # the reference batcher's default


def bucket_chunks(S: int, buckets: tuple = PREFILL_BUCKETS) -> list[int]:
    """Greedy bucket decomposition of a prompt length: aligned chunks take
    the static fast path, the ragged tail takes the flexible path."""
    chunks, rem = [], S
    for bk in sorted(buckets, reverse=True):
        while rem >= bk:
            chunks.append(bk)
            rem -= bk
    if rem:
        chunks.append(rem)
    return chunks


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    output: list = field(default_factory=list)
    done: bool = False


@dataclass
class _PagedLane:
    """One decode lane: the request plus its pool bookkeeping."""
    req: Request
    seq: SequenceBlocks
    budget: int = 0


class PagedBatcher:
    """Continuous batching over the paged KV pool.

    Decode runs at static width ``decode_width``: inactive lanes carry a
    null block table and length 0. With ``sync='device'`` each decode
    dispatch is a window of ``window`` steps with per-lane budgets and EOS
    masked on the device; lengths and blocks are reconciled on the host
    after the window: one copy in of the lanes' operands and one copy out
    of the window's tokens. Runs on ``device`` (the card unless ``"cpu"`` is
    asked for).

    ``weight_quant`` in {'int8', 'w4a16'} quantizes the params at
    construction: under an engine mode the prefill's aligned path launches
    the dequantizing GEMMs, decode and the flexible path dequantize before
    the product, so engine modes and sync arms stay token-identical.
    ``kv_quant='int8'`` stores the pool as int8 codes with per-slot bf16
    scales (quantize on write, dequantize in the gather).

    ``table`` (a ``LatencyTable``, e.g. ``profile_measured`` on the card
    for this ``weight_quant``) is what the engine mode's plan is solved
    from; by default the analytic table of the reference's cost model.
    """

    def __init__(self, cfg, params=None, *, num_blocks: int = 65,
                 block_size: int = 32, max_blocks_per_seq: int | None = None,
                 decode_width: int = 8,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 sync: str = "host", window: int = 8,
                 engine_mode: str | None = None, eos_id: int | None = None,
                 weight_quant: str | None = None,
                 kv_quant: str | None = None, device="cuda", table=None):
        if sync not in ("host", "device"):
            raise ValueError(f"sync must be 'host' or 'device', got {sync!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if weight_quant is not None and weight_quant not in WEIGHT_FORMATS:
            raise ValueError(f"weight_quant must be one of {WEIGHT_FORMATS} "
                             f"(or None), got {weight_quant!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be 'int8' or None, "
                             f"got {kv_quant!r}")
        if table is not None and table.weight_quant != weight_quant:
            raise ValueError(f"table profiled for weights "
                             f"{table.weight_quant!r}, served {weight_quant!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        if self.model.paged_decode_step is None:
            raise ValueError(f"{cfg.name}: paged KV cache requires an "
                             "attention-family model")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params if params is not None else self.model.init(
            self.generator, device=self.device)
        self.weight_quant = weight_quant
        self.kv_quant = kv_quant
        if weight_quant is not None:
            self.params = quantize_params(self.params, cfg, weight_quant)
        self.block_size = block_size
        self.kv = PagedKVCache(
            cfg, num_blocks=num_blocks, block_size=block_size,
            max_blocks_per_seq=max_blocks_per_seq,
            dtype=dtype_of(cfg.compute_dtype), kv_quant=kv_quant,
            device=self.device)
        self.W = decode_width
        self.sampler = sampler
        self.lanes: list[Optional[_PagedLane]] = [None] * decode_width
        self.queue: list[Request] = []
        self.peak_active = 0
        self.sync = sync
        self.window = window
        self.eos_id = eos_id
        self.engine_mode = engine_mode
        if engine_mode is not None:
            from ..core.engine import build_hetero_ctx
            self.ctx = build_hetero_ctx(
                cfg, engine_mode,
                sync_mode="fast" if sync == "device" else "host",
                table=table, weight_quant=weight_quant)
        else:
            self.ctx = None
        # host dispatches issued vs tokens produced: the fused-window win is
        # decode dispatches << decode steps
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefill_dispatches = 0
        self._prefill = partial(self.model.paged_prefill, hetero_ctx=self.ctx)
        self._loops: dict[tuple, object] = {}      # loop_key -> decode loop

    @property
    def total_dispatches(self) -> int:
        return self.decode_dispatches + self.prefill_dispatches

    def stats(self) -> dict:
        """Counter snapshot: dispatches issued vs tokens produced."""
        return {
            "peak_active": self.peak_active,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "prefill_dispatches": self.prefill_dispatches,
            "total_dispatches": self.total_dispatches,
        }

    def graph_stats(self) -> dict:
        """Decode graphs captured, their replays and pool bytes (none on the
        CPU, where the loops run eagerly)."""
        return loop_stats(self._loops.values())

    def loop_key(self, kind: str) -> tuple:
        """The key of this batcher's decode loop of ``kind`` ('window' or
        'tick'): all that its graph bakes in beyond this instance's weights
        and pool — the lanes' shapes, the pool's and the weights' formats
        and, for a window, its steps, sampler and EOS."""
        key = (kind, self.W, self.kv.max_blocks_per_seq,
               self.kv.pool["k"].dtype, self.kv_quant, self.weight_quant)
        if kind == "window":
            return key + (self.window, self.sampler, self.eos_id)
        return key

    def _loop(self, kind: str):
        key = self.loop_key(kind)
        if key not in self._loops:
            shape = (self.model, self.params, self.kv.pool, self.W,
                     self.kv.max_blocks_per_seq)
            self._loops[key] = (
                paged_window_loop(*shape, self.window, sampler=self.sampler,
                                  eos_id=self.eos_id,
                                  generator=self.generator)
                if kind == "window" else paged_step_loop(*shape))
        return self._loops[key]

    @property
    def busy(self) -> bool:
        return bool(self.queue or any(lane is not None for lane in self.lanes))

    # ------------------------------------------------------------ plumbing --
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def submit(self, req: Request):
        live = {r.rid for r in self.queue}
        live.update(lane.req.rid for lane in self.lanes if lane is not None)
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt — a request "
                             "must carry at least one prompt token")
        if req.rid in live:
            raise ValueError(f"request {req.rid}: duplicate id — a request "
                             "with this id is already queued or in flight")
        self.queue.append(req)

    def _try_open(self, req: Request) -> Optional[SequenceBlocks]:
        """Reserve the request's blocks, or return None to wait (FCFS)."""
        S = len(req.prompt)
        total = S + req.max_new_tokens
        need = self.kv.blocks_for(total)
        cap = min(self.kv.max_blocks_per_seq, self.kv.num_blocks - 1)
        if need > cap:
            raise ValueError(
                f"request {req.rid} needs {need} blocks ({total} tokens @ "
                f"block_size={self.block_size}) but the pool can never supply "
                f"more than {cap} per request — raise num_blocks/"
                "max_blocks_per_seq")
        if not self.kv.can_admit(total):
            return None
        return self.kv.open_sequence(prompt_tokens=S, total_tokens=total)

    def _place(self, req: Request, seq: SequenceBlocks, first: int) -> int:
        """Prefill done: record the prefill-sampled token, occupy a lane."""
        seq.length = len(req.prompt)
        req.output.append(first)
        budget = req.max_new_tokens - 1
        if self.eos_id is not None and first == self.eos_id:
            budget = 0                  # satisfied at prefill, like max=1
        lane = next(i for i in range(self.W) if self.lanes[i] is None)
        self.lanes[lane] = _PagedLane(req=req, seq=seq, budget=budget)
        return lane

    def _admit(self):
        """Admit-then-decode: whole prompts prefill as bucket-chunk
        dispatches before the request joins a lane."""
        for lane in range(self.W):
            if self.lanes[lane] is not None or not self.queue:
                continue
            seq = self._try_open(self.queue[0])
            if seq is None:
                break                    # FCFS: wait for blocks to free
            req = self.queue.pop(0)
            bt = self._tensor(seq.table)[None]
            idx, logits = 0, None
            for c in bucket_chunks(len(req.prompt)):
                piece = self._tensor(req.prompt[idx: idx + c])[None]
                logits, self.kv.pool = self._prefill(
                    self.params, piece, self.kv.pool, block_table=bt,
                    start_index=idx)
                self.prefill_dispatches += 1
                idx += c
            first = int(sample(logits[:, -1, :], self.generator,
                               self.sampler)[0])
            self._place(req, seq, first)

    def _finish(self, lane: int):
        st = self.lanes[lane]
        self.kv.close_sequence(st.seq)
        self.lanes[lane] = None
        st.req.done = True

    # ----------------------------------------------------------------- run --
    def step(self) -> bool:
        """One tick: admit by free blocks, then one batched decode dispatch —
        a single host-synced step (sync='host') or a window of
        ``self.window`` steps (sync='device')."""
        self._admit()
        active = [i for i in range(self.W) if self.lanes[i] is not None]
        self.peak_active = max(self.peak_active, len(active))
        # zero-budget admissions finish without a decode step
        for i in list(active):
            if self.lanes[i].budget <= 0:
                self._finish(i)
                active.remove(i)
        if not active:
            return False
        if self.sync == "device":
            self._decode_window(active)
        else:
            self._decode_tick(active)
        return True

    def _lane_arrays(self, active, steps_of):
        """Host-built decode operands: last, tables, lengths, remaining, in
        page-locked memory on the card's path, so that copying them into a
        graph's buffers does not wait."""
        tables = np.zeros((self.W, self.kv.max_blocks_per_seq), np.int64)
        lengths = np.zeros((self.W,), np.int64)
        remaining = np.zeros((self.W,), np.int64)
        last = np.zeros((self.W, 1), np.int64)
        for i in active:
            st = self.lanes[i]
            steps = steps_of(st)
            self.kv.grow_to(st.seq, st.seq.length + steps)
            tables[i] = st.seq.table
            lengths[i] = st.seq.length
            remaining[i] = steps
            last[i, 0] = st.req.output[-1]
        staged = [torch.from_numpy(a) for a in (last, tables, lengths,
                                                 remaining)]
        if self.device.type == "cuda":
            staged = [t.pin_memory() for t in staged]
        return staged

    def _emit(self, i: int, emitted: list[int]):
        st = self.lanes[i]
        st.req.output.extend(emitted)
        st.seq.length += len(emitted)
        st.budget -= len(emitted)
        self.decode_steps += len(emitted)
        if st.budget <= 0 or (self.eos_id is not None
                              and self.eos_id in emitted):
            self._finish(i)

    def _decode_tick(self, active):
        """Host-synced baseline arm: one decode step, one host read per
        token (the paper's GPU-2 cost)."""
        last, tables, lengths, _ = self._lane_arrays(active, lambda st: 1)
        logits = self._loop("tick")(last, tables, lengths)
        self.decode_dispatches += 1
        toks = sample(logits[:, -1, :], self.generator, self.sampler).cpu()
        for i in active:
            self._emit(i, [int(toks[i])])

    def _decode_window(self, active):
        """Fast-sync arm: one dispatch of up to ``self.window`` steps for
        every lane; each lane's blocks are pre-grown for its whole window
        (bounded by its budget, so inside the admission reservation)."""
        w = self.window
        staged = self._lane_arrays(active, lambda st: min(w, st.budget))
        toks = self._loop("window")(*staged).cpu().tolist()
        self.decode_dispatches += 1
        for i in active:
            self._emit(i, [t for t in toks[i] if t >= 0])

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        for r in requests:
            self.submit(r)
        ticks = 0
        while self.busy and ticks < max_ticks:
            self.step()
            ticks += 1
        return requests
