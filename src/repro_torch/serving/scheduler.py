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
  * ``mixed_batch=True`` — stage-parallel mixed batching: each step fuses
    one bucket-sized prefill chunk of the admitting request into the decode
    dispatch of the running lanes (``transformer.mixed_step``; on the card
    the window or tick graph of that chunk length).
  * ``spec=SpecConfig(...)`` — speculative decoding (serving/spec.py): each
    step is one round of drafts from the draft lanes, ONE ``paged_verify``
    target dispatch through the solver's VERIFY decisions, greedy
    acceptance and ``truncate_to`` rollback.
  * ``prefix_cache=True`` — automatic prefix caching
    (serving/paged_cache.py): finished requests retire their full blocks
    into a chain-hash index, admissions share matching blocks and prefill
    only the uncached suffix.

``weight_quant`` ('int8' | 'w4a16') serves quantized weights and
``kv_quant='int8'`` an int8 KV pool (see :class:`PagedBatcher`); both
compose with the three arms.

Greedy outputs are the same across engine modes, sync arms and the three
arms (the reference's invariant). Preemption (with the async ingress),
tensor parallelism and tracing are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..configs import dtype_of
from ..core.sync import (loop_stats, paged_mixed_step_loop,
                         paged_mixed_window_loop, paged_step_loop,
                         paged_window_loop, stage)
from ..device import resolve_device
from ..models import build_model
from ..models.quant import WEIGHT_FORMATS, quantize_params
from .paged_cache import PagedKVCache, SequenceBlocks
from .sampler import SamplerConfig, greedy_verify, sample
from .spec import DraftLanes, SpecConfig


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


@dataclass
class _Admission:
    """A request whose prefill is in flight under mixed batching: its
    blocks are reserved, its prompt drains one chunk a scheduler step, each
    chunk fused into that step's decode dispatch."""
    req: Request
    seq: SequenceBlocks
    chunks: list                       # remaining chunk lengths
    idx: int = 0                       # prompt tokens resident so far


class PagedBatcher:
    """Continuous batching over the paged KV pool.

    Decode runs at static width ``decode_width``: inactive lanes carry a
    null block table and length 0. With ``sync='device'`` each decode
    dispatch is a window of ``window`` steps with per-lane budgets and EOS
    masked on the device; lengths and blocks are reconciled on the host
    after the window: one copy in of the lanes' operands and one copy out
    of the window's tokens. Runs on ``device`` (the card unless ``"cpu"`` is
    asked for).

    ``mixed_batch=True``: admission prefill no longer runs as dispatches of
    its own. One request at a time holds an ``_Admission`` ticket, and each
    step fuses its next prompt chunk (bucket-sized, at most
    ``max_prefill_chunk_per_step`` tokens) into the lanes' decode dispatch:
    the tick's ``mixed_step`` under ``sync='host'``, a window whose first
    step is the mixed step under ``sync='device'``. A chunk takes a
    standalone prefill dispatch only when no lane is decoding.

    ``spec=SpecConfig(k=K, draft=...)`` (or ``spec=K``): each step is one
    speculative round (serving/spec.py; greedy sampler only): K drafts a
    lane from the draft lanes, ONE ``paged_verify`` over every lane's K+1
    tokens, greedy acceptance, ``truncate_to`` rollback. Excludes
    ``mixed_batch`` (both take over the step loop).

    ``prefix_cache=True``: finished requests retire their full blocks into
    the pool's chain-hash cache; an admission shares the matching blocks
    (copy on write when the hit covers the whole prompt) and prefills only
    the uncached suffix. The tokens are the cold path's.

    ``weight_quant`` in {'int8', 'w4a16'} quantizes the params at
    construction: under an engine mode the prefill's aligned path launches
    the dequantizing GEMMs, decode and the flexible path dequantize before
    the product, so engine modes and sync arms stay token-identical.
    ``kv_quant='int8'`` stores the pool as int8 codes with per-slot bf16
    scales (quantize on write, dequantize in the gather). Both compose with
    the three arms (draft caches stay in the compute dtype; cached blocks
    keep their codes and scales).

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
                 mixed_batch: bool = False,
                 max_prefill_chunk_per_step: int | None = None,
                 spec: SpecConfig | int | None = None,
                 spec_draft_params=None, prefix_cache: bool = False,
                 weight_quant: str | None = None,
                 kv_quant: str | None = None, device="cuda", table=None):
        if sync not in ("host", "device"):
            raise ValueError(f"sync must be 'host' or 'device', got {sync!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if isinstance(spec, int):
            spec = SpecConfig(k=spec)
        if spec is not None and mixed_batch:
            raise ValueError("spec mode and mixed_batch are mutually "
                             "exclusive")
        if spec is not None and sampler.temperature > 0.0:
            raise ValueError("spec mode implements greedy verification only;"
                             " use a temperature-0 sampler")
        if max_prefill_chunk_per_step is not None \
                and max_prefill_chunk_per_step < 1:
            raise ValueError("max_prefill_chunk_per_step must be >= 1, got "
                             f"{max_prefill_chunk_per_step}")
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
        self.prefix_cache = prefix_cache
        self.kv = PagedKVCache(
            cfg, num_blocks=num_blocks, block_size=block_size,
            max_blocks_per_seq=max_blocks_per_seq,
            dtype=dtype_of(cfg.compute_dtype), kv_quant=kv_quant,
            prefix_cache=prefix_cache, device=self.device)
        self.W = decode_width
        self.buckets = PREFILL_BUCKETS
        self.sampler = sampler
        self.lanes: list[Optional[_PagedLane]] = [None] * decode_width
        self.queue: list[Request] = []
        self.peak_active = 0
        self.sync = sync
        self.window = window
        self.eos_id = eos_id
        self.engine_mode = engine_mode
        self.mixed_batch = mixed_batch
        # mixed admission chunks: buckets no larger than the per-step cap
        cap = max_prefill_chunk_per_step
        self.max_prefill_chunk_per_step = cap
        self.admit_buckets = (self.buckets if cap is None else
                              (tuple(b for b in self.buckets if b <= cap)
                               or (cap,)))
        self._admitting: Optional[_Admission] = None
        self.spec = spec
        if engine_mode is not None:
            from ..core.engine import build_hetero_ctx
            self.ctx = build_hetero_ctx(
                cfg, engine_mode,
                sync_mode="fast" if sync == "device" else "host",
                table=table,
                # the (chunk bucket, decode width) pairs this batcher fuses
                mixed_pairs=(tuple((b, decode_width)
                                   for b in self.admit_buckets)
                             if mixed_batch else ()),
                # the M = W·(K+1) verification dispatches of spec mode
                verify_ks=(((spec.k, decode_width),)
                           if spec is not None else ()),
                # cached-prefix suffixes start at block boundaries: block-
                # multiple chunks below the smallest bucket
                extra_ms=(tuple(range(block_size, min(self.buckets),
                                      block_size))
                          if prefix_cache else ()),
                weight_quant=weight_quant)
        else:
            self.ctx = None
        # host dispatches issued vs tokens produced: the fused-window win is
        # decode dispatches << decode steps; mixed batching's is prefill
        # chunks riding decode dispatches (fused_steps up, prefill down)
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefill_dispatches = 0      # standalone prefill-chunk dispatches
        self.fused_steps = 0             # prefill chunks fused into decode
        self.spec_rounds = 0             # per-lane speculation rounds
        self.drafted_tokens = 0          # drafts offered (budget-covered)
        self.accepted_tokens = 0         # drafts the target accepted
        self.verify_dispatches = 0       # batched paged_verify dispatches
        self._prefill = partial(self.model.paged_prefill, hetero_ctx=self.ctx)
        self._mixed_step = partial(self.model.mixed_step, hetero_ctx=self.ctx)
        self._loops: dict[tuple, object] = {}      # loop_key -> decode loop
        self.drafts = None
        if spec is not None:
            self.draft_cfg = draft_cfg = spec.resolve_draft(cfg)
            if spec_draft_params is None:
                spec_draft_params = (
                    self.params if draft_cfg is cfg else
                    build_model(draft_cfg).init(
                        torch.Generator(device=self.device
                                        ).manual_seed(seed + 1),
                        device=self.device))
            # the longest admissible request bounds the draft cache; k + 1
            # more slots take the round's overshooting draft writes
            self.drafts = DraftLanes(
                draft_cfg, spec_draft_params, lanes=decode_width,
                max_len=self.kv.max_blocks_per_seq * block_size + spec.k + 1,
                sync=sync,
                dtype=dtype_of(cfg.compute_dtype), device=self.device)
            vctx = (self.ctx.for_verify(spec.k, decode_width)
                    if self.ctx is not None else None)
            self._verify = partial(self.model.paged_verify, hetero_ctx=vctx)

    @property
    def total_dispatches(self) -> int:
        """Host dispatches issued (prefill + decode; a fused mixed step
        counts once). In spec mode TARGET-model dispatches; the draft's are
        ``stats()["draft_dispatches"]``."""
        return self.decode_dispatches + self.prefill_dispatches

    def stats(self) -> dict:
        """Counter snapshot: dispatches issued vs tokens produced, the
        prefix cache's counters and, in spec mode, speculation's; the
        reference's keys."""
        s = {
            "peak_active": self.peak_active,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "prefill_dispatches": self.prefill_dispatches,
            "fused_steps": self.fused_steps,
            "total_dispatches": self.total_dispatches,
        }
        s.update(self.kv.prefix_stats())
        if self.spec is not None:
            s.update({
                "spec_k": self.spec.k,
                "draft_model": self.draft_cfg.name,
                "spec_rounds": self.spec_rounds,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": (self.accepted_tokens /
                                    max(self.drafted_tokens, 1)),
                "verify_dispatches": self.verify_dispatches,
                "draft_dispatches": self.drafts.dispatches,
                "target_dispatches": self.total_dispatches,
            })
        return s

    def graph_stats(self) -> dict:
        """Decode graphs captured (the draft lanes' included), their
        replays and pool bytes (none on the CPU, where the loops run
        eagerly)."""
        loops = list(self._loops.values())
        if self.drafts is not None:
            loops += list(self.drafts.loops.values())
        return loop_stats(loops)

    def loop_key(self, kind: str, chunk: int | None = None) -> tuple:
        """The key of this batcher's decode loop of ``kind`` ('window',
        'tick', 'mixed-window' or 'mixed-tick', the last two per prefill
        ``chunk`` length): all that its graph bakes in beyond this
        instance's weights and pool — the lanes' shapes, the pool's and the
        weights' formats and, for a window, its steps, sampler and EOS."""
        key = (kind, self.W, self.kv.max_blocks_per_seq,
               self.kv.pool["k"].dtype, self.kv_quant, self.weight_quant)
        if kind in ("window", "mixed-window"):
            key += (self.window, self.sampler, self.eos_id)
        return key if chunk is None else key + (chunk,)

    def _loop(self, kind: str, chunk: int | None = None):
        key = self.loop_key(kind, chunk)
        if key not in self._loops:
            shape = (self.model, self.params, self.kv.pool, self.W,
                     self.kv.max_blocks_per_seq)
            window = dict(sampler=self.sampler, eos_id=self.eos_id,
                          generator=self.generator)
            if kind == "window":
                loop = paged_window_loop(*shape, self.window, **window)
            elif kind == "tick":
                loop = paged_step_loop(*shape)
            elif kind == "mixed-window":
                loop = paged_mixed_window_loop(
                    *shape, self.window, chunk,
                    mixed_step_fn=self._mixed_step, **window)
            else:
                loop = paged_mixed_step_loop(
                    *shape, chunk, mixed_step_fn=self._mixed_step)
            self._loops[key] = loop
        return self._loops[key]

    @property
    def busy(self) -> bool:
        """Work outstanding: queued requests, an open admission ticket or
        occupied lanes."""
        return bool(self.queue or self._admitting is not None
                    or any(lane is not None for lane in self.lanes))

    # ------------------------------------------------------------ plumbing --
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def submit(self, req: Request):
        live = {r.rid for r in self.queue}
        live.update(lane.req.rid for lane in self.lanes if lane is not None)
        if self._admitting is not None:
            live.add(self._admitting.req.rid)
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt — a request "
                             "must carry at least one prompt token")
        if req.rid in live:
            raise ValueError(f"request {req.rid}: duplicate id — a request "
                             "with this id is already queued or in flight")
        self.queue.append(req)

    def _try_open(self, req: Request) -> Optional[SequenceBlocks]:
        """Reserve the request's blocks, or return None to wait (FCFS).
        With the prefix cache, matching cached blocks are shared."""
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
        return self.kv.open_sequence(
            prompt_tokens=S, total_tokens=total,
            token_ids=req.prompt if self.prefix_cache else None)

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
        dispatches before the request joins a lane; with the prefix cache,
        only the suffix after ``seq.cached_tokens`` (a whole-prompt hit
        re-runs its last token for the logits). In spec mode the draft
        lane prefills the prompt too."""
        for lane in range(self.W):
            if self.lanes[lane] is not None or not self.queue:
                continue
            seq = self._try_open(self.queue[0])
            if seq is None:
                break                    # FCFS: wait for blocks to free
            req = self.queue.pop(0)
            bt = self._tensor(seq.table)[None]
            idx, logits = seq.cached_tokens, None
            for c in bucket_chunks(len(req.prompt) - seq.cached_tokens,
                                   self.buckets):
                piece = self._tensor(req.prompt[idx: idx + c])[None]
                logits, self.kv.pool = self._prefill(
                    self.params, piece, self.kv.pool, block_table=bt,
                    start_index=idx)
                self.prefill_dispatches += 1
                idx += c
            first = int(sample(logits[:, -1, :], self.generator,
                               self.sampler)[0])
            lane = self._place(req, seq, first)
            if self.spec is not None and self.lanes[lane].budget > 0:
                self.drafts.prefill(lane, req.prompt)

    def _start_admission(self):
        """Mixed batching: take ONE admission ticket at a time, with a free
        lane for it (lanes only free while the ticket is open)."""
        if self._admitting is not None or not self.queue:
            return
        if all(lane is not None for lane in self.lanes):
            return
        seq = self._try_open(self.queue[0])
        if seq is None:
            return
        req = self.queue.pop(0)
        self._admitting = _Admission(
            req=req, seq=seq, idx=seq.cached_tokens,
            chunks=bucket_chunks(len(req.prompt) - seq.cached_tokens,
                                 self.admit_buckets))

    def _admission_chunk(self):
        """Pop the admitting request's next chunk: (tokens [1, C], block
        table [1, NBmax], start), host arrays and an int."""
        adm = self._admitting
        c = adm.chunks.pop(0)
        piece = np.asarray(adm.req.prompt[adm.idx: adm.idx + c])[None]
        start = adm.idx
        adm.idx += c
        return piece, adm.seq.table[None], start

    def _finish_admission(self, pre_logits):
        """Last chunk landed: sample the prefill token and occupy the lane
        kept free at ``_start_admission``."""
        adm, self._admitting = self._admitting, None
        self._place(adm.req, adm.seq,
                    int(sample(pre_logits[:, -1, :], self.generator,
                               self.sampler)[0]))

    def _close_lane(self, lane: int) -> _PagedLane:
        """Return lane ``lane``'s pool references; with the prefix cache the
        full blocks of the WRITTEN stream (prompt + output, ``seq.length``
        of it: the last sampled token's KV is never written) retire."""
        st = self.lanes[lane]
        ids = None
        if self.prefix_cache:
            ids = np.concatenate([
                np.asarray(st.req.prompt, np.int64),
                np.asarray(st.req.output, np.int64)])[:st.seq.length]
        self.kv.close_sequence(st.seq, token_ids=ids)
        self.lanes[lane] = None
        return st

    def _finish(self, lane: int):
        self._close_lane(lane).req.done = True

    # ----------------------------------------------------------------- run --
    def step(self) -> bool:
        """One tick: admit by free blocks, then one batched decode dispatch —
        a single host-synced step (sync='host') or a window of
        ``self.window`` steps (sync='device'). Under mixed batching the
        admitting request's next chunk rides that dispatch (a standalone
        prefill only when no lane decodes); in spec mode the dispatch is a
        speculative round."""
        if self.mixed_batch:
            self._start_admission()
        else:
            self._admit()
        active = [i for i in range(self.W) if self.lanes[i] is not None]
        self.peak_active = max(self.peak_active,
                               len(active) + (self._admitting is not None))
        # zero-budget admissions finish without a decode step
        for i in list(active):
            if self.lanes[i].budget <= 0:
                self._finish(i)
                active.remove(i)

        if self.spec is not None:
            if not active:
                return False
            self._spec_round(active)
            return True

        if self._admitting is not None:
            adm_chunk = self._admission_chunk()
            last_chunk = not self._admitting.chunks
            if not active:
                # nothing decoding: the chunk pays its own dispatch
                piece, table, start = adm_chunk
                pre_logits, self.kv.pool = self._prefill(
                    self.params, self._tensor(piece), self.kv.pool,
                    block_table=self._tensor(table), start_index=start)
                self.prefill_dispatches += 1
            elif self.sync == "device":
                pre_logits = self._decode_window(active, adm_chunk)
            else:
                pre_logits = self._decode_tick(active, adm_chunk)
            if last_chunk:
                self._finish_admission(pre_logits)
            return True

        if not active:
            return False
        if self.sync == "device":
            self._decode_window(active)
        else:
            self._decode_tick(active)
        return True

    def _lane_arrays(self, active, steps_of):
        """Host-built decode operands, staged: last, tables, lengths,
        remaining."""
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
        return stage(last, tables, lengths, remaining, device=self.device)

    def _emit(self, i: int, emitted: list[int]):
        st = self.lanes[i]
        st.req.output.extend(emitted)
        st.seq.length += len(emitted)
        st.budget -= len(emitted)
        self.decode_steps += len(emitted)
        if st.budget <= 0 or (self.eos_id is not None
                              and self.eos_id in emitted):
            self._finish(i)

    def _spec_round(self, active):
        """One speculative round across the active lanes: K drafts a lane
        (one captured draft loop under ``sync='device'``), ONE batched
        ``paged_verify`` over every lane's pending + draft tokens (M =
        W·(K+1), the solver's VERIFY decisions), greedy acceptance on the
        host, then rollback: ``truncate_to`` frees whole blocks past each
        lane's accepted prefix and the draft lanes reset their cursors.
        Emits 1..K+1 tokens a lane a target dispatch."""
        k = self.spec.k
        tables = np.zeros((self.W, self.kv.max_blocks_per_seq), np.int64)
        starts = np.zeros((self.W,), np.int64)
        last = np.zeros((self.W, 1), np.int64)
        for i in active:
            st = self.lanes[i]
            # rows past the remaining budget are never emitted: growth
            # stays inside the reservation, their writes sink in the null
            # block like a masked lane's
            self.kv.grow_to(st.seq, st.seq.length + min(k + 1, st.budget))
            tables[i] = st.seq.table
            starts[i] = st.seq.length
            last[i, 0] = st.req.output[-1]
        drafts = self.drafts.draft(last, k)                    # [W, k]
        tokens = np.concatenate([last, drafts], axis=1)        # [W, k+1]
        logits, self.kv.pool = self._verify(
            self.params, self._tensor(tokens), self.kv.pool,
            block_table=self._tensor(tables),
            start_index=self._tensor(starts))
        self.verify_dispatches += 1
        self.decode_dispatches += 1      # the round's one TARGET dispatch
        emitted, n_emit = greedy_verify(self._tensor(drafts), logits)
        emitted, n_emit = emitted.cpu().numpy(), n_emit.cpu().numpy()
        for i in active:
            st = self.lanes[i]
            n = int(n_emit[i])
            toks = [int(t) for t in emitted[i, :min(n, st.budget)]]
            hit_eos = self.eos_id is not None and self.eos_id in toks
            if hit_eos:
                toks = toks[: toks.index(self.eos_id) + 1]
            self.spec_rounds += 1
            # the acceptance rate counts only budget-covered drafts and
            # acceptances that emitted
            self.drafted_tokens += min(k, st.budget)
            self.accepted_tokens += min(n - 1, len(toks))
            st.req.output.extend(toks)
            st.budget -= len(toks)
            self.decode_steps += len(toks)
            new_len = st.seq.length + len(toks)
            self.kv.truncate_to(st.seq, new_len)    # paged rollback
            st.seq.length = new_len
            self.drafts.rollback(i, new_len)        # draft-cache rollback
            if st.budget <= 0 or hit_eos:
                self._finish(i)

    def _decode_tick(self, active, adm_chunk=None):
        """Host-synced baseline arm: one decode step, one host read per
        token (the paper's GPU-2 cost). With ``adm_chunk`` the step is the
        fused ``mixed_step`` and the chunk's last-token logits are
        returned."""
        last, tables, lengths, _ = self._lane_arrays(active, lambda st: 1)
        pre_logits = None
        if adm_chunk is None:
            logits = self._loop("tick")(last, tables, lengths)
        else:
            piece, table, start = adm_chunk
            logits, pre_logits = self._loop("mixed-tick", piece.shape[1])(
                last, tables, lengths,
                *stage(piece, table, start, device=self.device))
            pre_logits = pre_logits.clone()
            self.fused_steps += 1
        self.decode_dispatches += 1
        toks = sample(logits[:, -1, :], self.generator, self.sampler).cpu()
        for i in active:
            self._emit(i, [int(toks[i])])
        return pre_logits

    def _decode_window(self, active, adm_chunk=None):
        """Fast-sync arm: one dispatch of up to ``self.window`` steps for
        every lane; each lane's blocks are pre-grown for its whole window
        (bounded by its budget, so inside the admission reservation). With
        ``adm_chunk`` the window's first step carries the prefill chunk and
        the chunk's last-token logits are returned."""
        w = self.window
        staged = self._lane_arrays(active, lambda st: min(w, st.budget))
        pre_logits = None
        if adm_chunk is None:
            toks = self._loop("window")(*staged)
        else:
            piece, table, start = adm_chunk
            toks, pre_logits = self._loop("mixed-window", piece.shape[1])(
                *staged, *stage(piece, table, start, device=self.device))
            pre_logits = pre_logits.clone()
            self.fused_steps += 1
        toks = toks.cpu().tolist()
        self.decode_dispatches += 1
        for i in active:
            self._emit(i, [t for t in toks[i] if t >= 0])
        return pre_logits

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        for r in requests:
            self.submit(r)
        ticks = 0
        while self.busy and ticks < max_ticks:
            self.step()
            ticks += 1
        return requests
