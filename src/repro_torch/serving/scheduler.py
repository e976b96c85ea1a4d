"""Continuous-batching serving schedulers: dense slots
(``ContinuousBatcher``) and paged blocks (``PagedBatcher``).

``ContinuousBatcher`` (the dense baseline) runs slot-based continuous
batching over a preallocated ``[max_batch, max_len]`` KV cache: requests
join free slots, prefill runs per request as bucket-chunked pieces
(``transformer.prefill_slot``, the flash-attention kernel), and decode
steps run batched across all slots with PER-SLOT cache indices (a ``[B]``
``cache["index"]``, ``layers.slot_attention``). Finished slots free at once
and the queue backfills. Decode is eager, as the reference's is a plain
jitted step.

``PagedBatcher`` gates admission by FREE BLOCKS: a request is admitted
when ``ceil((len(prompt) + max_new_tokens) / block_size)`` blocks can be
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
arms (the reference's invariant). ``PagedBatcher.preempt`` evicts a lane
for the async ingress (serving/ingress.py). Both batchers take a
``tracer`` (serving/trace.py): with a live one every dispatch becomes a
span tagged with the plan's decisions, closed after a fence, and the
tracer's counters move with ``stats()``; with the default ``NULL_TRACER``
nothing is recorded and nothing waits.

``PagedBatcher(mesh=...)`` serves head-wise tensor-parallel over the
mesh's ``model`` axis (serving/layout.py): one process per rank, each
running this same bookkeeping on its slices of the weights and the pool,
the four paged entry points through the layout's step functions.
``stats()["tp"]`` is the group's width.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..configs import dtype_of
from ..core.sync import (graph_pool, loop_stats, make_call,
                         paged_mixed_step_loop, paged_mixed_window_loop,
                         paged_step_loop, paged_window_loop, stage,
                         traced_dispatch, window_replay)
from ..device import resolve_device
from ..models import build_model
from ..models.quant import WEIGHT_FORMATS, quantize_params
from .layout import make_layout
from .paged_cache import PagedKVCache, SequenceBlocks
from .sampler import SamplerConfig, greedy_verify, sample
from .spec import DraftLanes, SpecConfig
from .trace import NULL_TRACER


PREFILL_BUCKETS = (64, 128, 256)      # the reference batchers' default


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


def _validate_submit(req: Request, live_rids) -> None:
    """Shared submit guard: an empty prompt has no first token to sample,
    and a request id already queued or in flight would make two streams
    indistinguishable. Finished ids may be reused (replay waves and
    preemption resumes depend on it)."""
    if len(req.prompt) == 0:
        raise ValueError(f"request {req.rid}: empty prompt — a request "
                         "must carry at least one prompt token")
    if req.rid in live_rids:
        raise ValueError(f"request {req.rid}: duplicate id — a request "
                         "with this id is already queued or in flight")


class ContinuousBatcher:
    """Slot-based continuous batching over a dense KV cache on ``device``
    (the card unless ``"cpu"`` is asked for): up to ``max_batch`` requests
    hold a slot of a ``[max_batch, max_len]`` cache (the model's
    ``init_cache``, its default dtype, as in the reference), each prompt
    prefilled into its slot as ``bucket_chunks`` pieces, then one batched
    decode step a tick over the ``[B]`` cache index. ``weight_quant`` in
    {'int8', 'w4a16'} serves quantized weights (dequantized before each
    product); ``tracer`` records each dispatch."""

    def __init__(self, cfg, params=None, *, max_batch: int = 4,
                 max_len: int = 512, buckets=PREFILL_BUCKETS,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 weight_quant: str | None = None, tracer=None,
                 device="cuda"):
        if weight_quant is not None and weight_quant not in WEIGHT_FORMATS:
            raise ValueError(f"weight_quant must be one of {WEIGHT_FORMATS} "
                             f"(or None), got {weight_quant!r}")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cfg = cfg
        self.model = build_model(cfg)
        if self.model.prefill_slot is None:
            raise ValueError(f"{cfg.name}: the dense batcher's slot prefill "
                             "requires an attention-family model")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params if params is not None else self.model.init(
            self.generator, device=self.device)
        self.weight_quant = weight_quant
        if weight_quant is not None:
            self.params = quantize_params(self.params, cfg, weight_quant)
        self.B, self.S = max_batch, max_len
        self.buckets = tuple(sorted(buckets))
        self.sampler = sampler
        self.cache = self.model.init_cache(batch=max_batch, max_len=max_len,
                                           device=self.device)
        self.cache["index"] = torch.zeros((max_batch,), dtype=torch.int32,
                                          device=self.device)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self.budget: list[int] = [0] * max_batch
        self.lengths: list[int] = [0] * max_batch   # host-side slot lengths
        self.peak_active = 0           # max concurrent requests observed
        self.decode_dispatches = 0     # batched decode steps issued
        self.decode_steps = 0          # per-slot tokens decoded
        self.prefill_dispatches = 0    # prefill chunk dispatches issued

    @property
    def busy(self) -> bool:
        """Work outstanding: queued requests or occupied slots."""
        return bool(self.queue or any(s is not None for s in self.slots))

    def _span(self, kind: str, track: str, **args):
        return traced_dispatch(self.tracer, kind, self.cache["k"],
                               track=track, args=args)

    def submit(self, req: Request):
        _validate_submit(req, {r.rid for r in self.queue}
                         | {s.rid for s in self.slots if s is not None})
        self.queue.append(req)

    def _admit(self):
        for b in range(self.B):
            if self.slots[b] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slots[b] = req
            S = len(req.prompt)
            logits, idx = None, 0
            for c in bucket_chunks(S, self.buckets):
                piece = torch.as_tensor(np.asarray(req.prompt[idx: idx + c],
                                                   np.int64),
                                        device=self.device)
                with self._span("prefill_chunk", "prefill", rid=req.rid,
                                chunk=c, start=idx):
                    logits, self.cache = self.model.prefill_slot(
                        self.params, self.cache, piece, b, idx)
                self.prefill_dispatches += 1
                self.tracer.count("prefill_dispatches")
                idx += c
            self.cache["index"][b] = S
            self.lengths[b] = S
            req.output.append(int(sample(logits[:, -1, :], self.generator,
                                         self.sampler)[0]))
            self.budget[b] = req.max_new_tokens - 1
            if self.budget[b] <= 0:      # satisfied at prefill: no decode
                req.done = True          # token is overproduced
                self.slots[b] = None
                self.lengths[b] = 0

    def step(self) -> bool:
        """One scheduler tick: admit waiting requests, one batched decode
        step (which advances every slot's index by one)."""
        self._admit()
        active = [b for b in range(self.B) if self.slots[b] is not None]
        self.peak_active = max(self.peak_active, len(active))
        self.tracer.gauge("peak_active", self.peak_active)
        if not active:
            return False
        last = np.zeros((self.B, 1), np.int64)
        for b in active:
            last[b, 0] = self.slots[b].output[-1]
        with self._span("decode_step", "decode", active=len(active)):
            logits, self.cache = self.model.decode_step(
                self.params, torch.as_tensor(last, device=self.device),
                self.cache)
        self.decode_dispatches += 1
        self.tracer.count("decode_dispatches")
        toks = sample(logits[:, -1, :], self.generator, self.sampler).cpu()
        for b in active:
            req = self.slots[b]
            req.output.append(int(toks[b]))
            self.budget[b] -= 1
            self.lengths[b] += 1
            self.decode_steps += 1
            self.tracer.count("decode_steps")
            if self.budget[b] <= 0 or self.lengths[b] + 1 >= self.S:
                req.done = True
                self.slots[b] = None           # free slot; queue backfills
                self.lengths[b] = 0
        return True

    def stats(self) -> dict:
        """Counter snapshot, the reference's keys: dispatches issued vs
        tokens produced."""
        return {
            "peak_active": self.peak_active,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "prefill_dispatches": self.prefill_dispatches,
            "fused_steps": 0,
            "total_dispatches": (self.decode_dispatches +
                                 self.prefill_dispatches),
        }

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        for r in requests:
            self.submit(r)
        ticks = 0
        while self.busy and ticks < max_ticks:
            self.step()
            ticks += 1
        return requests


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

    ``buckets`` are the prefill chunk lengths (``bucket_chunks``);
    ``cache_dtype`` is the dtype of the pool (unless ``kv_quant``) and of
    the draft lanes' caches, by default the compute dtype.
    ``tracer`` (serving/trace.py) records every dispatch, the pool's prefix
    events and the draft lanes' dispatches.

    ``mesh`` (a ``("data", "model")`` ``DeviceMesh``, launch/mesh.py):
    tensor parallelism over its ``model`` axis (serving/layout.py). Every
    rank of the group builds this batcher on the same full ``params`` and
    keeps its column slices; the draft lanes keep the full params (they
    run replicated, with no collective). Excludes ``engine_mode``. Under
    NCCL the decode loops, prefill chunks and verify rounds are CUDA graphs
    with the collectives inside; under gloo they run eagerly
    (``stats()["captured"]``).

    On the card a standalone prefill chunk is one captured call per chunk
    length and a spec round's verify one for the round's (W, K + 1)
    (``core/sync.py::make_call``; their starts, tables and tokens staged
    as the loops' inputs), all sharing one memory pool: one replay is one
    dispatch of ``stats()``.
    """

    def __init__(self, cfg, params=None, *, num_blocks: int = 65,
                 block_size: int = 32, max_blocks_per_seq: int | None = None,
                 decode_width: int = 8, buckets=PREFILL_BUCKETS,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 cache_dtype=None, sync: str = "host", window: int = 8,
                 engine_mode: str | None = None, eos_id: int | None = None,
                 mixed_batch: bool = False,
                 max_prefill_chunk_per_step: int | None = None,
                 spec: SpecConfig | int | None = None,
                 spec_draft_params=None, prefix_cache: bool = False,
                 weight_quant: str | None = None,
                 kv_quant: str | None = None, device="cuda", table=None,
                 mesh=None, tracer=None):
        if sync not in ("host", "device"):
            raise ValueError(f"sync must be 'host' or 'device', got {sync!r}")
        if mesh is not None and engine_mode is not None:
            raise ValueError(
                "engine_mode and mesh are mutually exclusive: the hetero "
                "engine partitions matmuls within one device, tensor "
                "parallelism partitions them across the mesh")
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
        # the fp activation dtype: the pool's when KV is unquantized, and
        # always the draft lanes' caches'
        fp_dtype = (cache_dtype if cache_dtype is not None
                    else dtype_of(cfg.compute_dtype))
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        # placement (one device, or this rank's slices over the mesh) is the
        # layout's; the bookkeeping below is the same on every rank
        self.mesh = mesh
        self.layout = make_layout(cfg, mesh)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.kv = PagedKVCache(
            cfg, num_blocks=num_blocks, block_size=block_size,
            max_blocks_per_seq=max_blocks_per_seq,
            dtype=fp_dtype, kv_quant=kv_quant,
            prefix_cache=prefix_cache, device=self.device,
            layout=self.layout, tracer=self.tracer)
        self.W = decode_width
        self.buckets = tuple(sorted(buckets))
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
        # the solved plan backs the tracer's decision tags and drift report
        self._plan = self.ctx.plan if self.ctx is not None else None
        # host dispatches issued vs tokens produced: the fused-window win is
        # decode dispatches << decode steps; mixed batching's is prefill
        # chunks riding decode dispatches (fused_steps up, prefill down)
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefill_dispatches = 0      # standalone prefill-chunk dispatches
        self.fused_steps = 0             # prefill chunks fused into decode
        self.preemptions = 0             # lanes evicted mid-flight (ingress)
        self.spec_rounds = 0             # per-lane speculation rounds
        self.drafted_tokens = 0          # drafts offered (budget-covered)
        self.accepted_tokens = 0         # drafts the target accepted
        self.verify_dispatches = 0       # batched paged_verify dispatches
        # the four paged entry points as the layout runs them (the model's
        # own on one device), kept for this batcher's life: its decode
        # loops are built on them
        self.steps = self.layout.step_fns(self.model)
        self._prefill = partial(self.steps.paged_prefill, hetero_ctx=self.ctx)
        self._mixed_step = partial(self.steps.mixed_step, hetero_ctx=self.ctx)
        self._loops: dict[tuple, object] = {}      # loop_key -> decode loop
        # loop_key -> captured prefill or verify call, in one shared pool
        self._calls: dict[tuple, object] = {}
        self._pool = graph_pool(self.device)
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
                buckets=self.buckets, sync=sync, dtype=fp_dtype,
                device=self.device, tracer=self.tracer)
            vctx = (self.ctx.for_verify(spec.k, decode_width)
                    if self.ctx is not None else None)
            self._verify = partial(self.steps.paged_verify, hetero_ctx=vctx)
        # only after the draft lanes took the full params: the target's
        # weights go to this rank's slices
        self.params = self.layout.place_params(self.params)

    def _dispatch_span(self, kind: str, track: str, specs=(), **args):
        """The span of one traced dispatch (``traced_dispatch``): ``specs``
        are ``dispatch_prediction`` keyword dicts (a mixed window is its
        mixed first step plus plain decode steps, hence a sequence) whose
        decision tags and predicted cost annotate the span and feed the
        drift report. With the tracer off nothing here runs: no prediction
        lookup, no event, no fence."""
        tr = self.tracer
        if not tr.enabled:
            return tr.dispatch(kind)
        from ..core.engine import dispatch_prediction
        tags, total = [], 0.0
        for sp in specs:
            t, p = dispatch_prediction(self._plan, self.cfg, **sp)
            tags.extend(t)
            total += p
        return traced_dispatch(tr, kind, self.kv.pool["k"], track=track,
                               tags=tuple(tags), predicted_us=total,
                               args=args)

    @property
    def total_dispatches(self) -> int:
        """Host dispatches issued (prefill + decode; a fused mixed step
        counts once). In spec mode TARGET-model dispatches; the draft's are
        ``stats()["draft_dispatches"]``."""
        return self.decode_dispatches + self.prefill_dispatches

    def stats(self) -> dict:
        """Counter snapshot: the tensor-parallel width, dispatches issued vs
        tokens produced, the prefix cache's counters and, in spec mode,
        speculation's: the reference's keys. Under a mesh also
        ``captured``: whether the decode loops are CUDA graphs (False on
        the CPU and under gloo)."""
        s = {
            "tp": self.layout.tp,
            "peak_active": self.peak_active,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "prefill_dispatches": self.prefill_dispatches,
            "fused_steps": self.fused_steps,
            "preemptions": self.preemptions,
            "total_dispatches": self.total_dispatches,
        }
        if self.mesh is not None:
            s["captured"] = (self.device.type == "cuda"
                             and self.layout.capturable)
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
        replays and pool bytes, and under ``calls`` the same of the prefill
        and verify graphs (pool bytes: their one shared pool's); none on
        the CPU, where all run eagerly."""
        loops = list(self._loops.values())
        if self.drafts is not None:
            loops += list(self.drafts.loops.values())
        return {**loop_stats(loops), "calls": loop_stats(self._calls.values())}

    def loop_key(self, kind: str, chunk: int | None = None) -> tuple:
        """The key of this batcher's decode loop or captured call of
        ``kind`` ('window', 'tick', 'mixed-window' or 'mixed-tick';
        'prefill' or 'verify'; the mixed ones and 'prefill' per ``chunk``
        length, 'verify' per K + 1): all that its graph bakes in beyond
        this instance's weights and pool — the lanes' shapes, the pool's and
        the weights' formats and, for a window, its steps, sampler and
        EOS."""
        key = (kind, self.W, self.kv.max_blocks_per_seq,
               self.kv.pool["k"].dtype, self.kv_quant, self.weight_quant)
        if kind in ("window", "mixed-window"):
            key += (self.window, self.sampler, self.eos_id)
        return key if chunk is None else key + (chunk,)

    def _loop(self, kind: str, chunk: int | None = None):
        key = self.loop_key(kind, chunk)
        if key not in self._loops:
            shape = (self.steps, self.params, self.kv.pool, self.W,
                     self.kv.max_blocks_per_seq)
            capture = self.layout.capturable
            window = dict(sampler=self.sampler, eos_id=self.eos_id,
                          generator=self.generator, capture=capture)
            if kind == "window":
                loop = paged_window_loop(*shape, self.window, **window)
            elif kind == "tick":
                loop = paged_step_loop(*shape, capture=capture)
            elif kind == "mixed-window":
                loop = paged_mixed_window_loop(
                    *shape, self.window, chunk,
                    mixed_step_fn=self._mixed_step, **window)
            else:
                loop = paged_mixed_step_loop(
                    *shape, chunk, mixed_step_fn=self._mixed_step,
                    capture=capture)
            self._loops[key] = loop
        return self._loops[key]

    def _call(self, kind: str, chunk: int):
        """The captured call of ``kind`` ('prefill' or 'verify') and
        ``chunk`` over the pool: this batcher's paged prefill or verify on
        staged (tokens, block table, start) inputs, returning its logits."""
        key = self.loop_key(kind, chunk)
        if key not in self._calls:
            fn = self._prefill if kind == "prefill" else self._verify

            def body(tokens, table, start):
                return fn(self.params, tokens, self.kv.pool,
                          block_table=table, start_index=start)[0]

            self._calls[key] = make_call(body, self.device, pool=self._pool,
                                         capture=self.layout.capturable)
        return self._calls[key]

    def _prefill_chunk(self, piece, table, start: int) -> torch.Tensor:
        """One standalone prefill chunk (host arrays: tokens [1, C], block
        table [1, NBmax]) at ``start``: its chunk length's captured call.
        Returns a copy of the last-token logits [1, 1, V]."""
        call = self._call("prefill", piece.shape[1])
        return call(*stage(piece, table, start, device=self.device)).clone()

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
        _validate_submit(req, live)
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
            idx, logits = seq.cached_tokens, None
            for c in bucket_chunks(len(req.prompt) - seq.cached_tokens,
                                   self.buckets):
                piece = np.asarray(req.prompt[idx: idx + c])[None]
                with self._dispatch_span("prefill_chunk", "prefill",
                                         ({"m": c},), rid=req.rid,
                                         chunk=c, start=idx):
                    logits = self._prefill_chunk(piece, seq.table[None], idx)
                self.prefill_dispatches += 1
                self.tracer.count("prefill_dispatches")
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

    def preempt(self, lane: int) -> Request:
        """Evict lane ``lane`` mid-flight, freeing its pool blocks for
        higher-priority work, and return its unfinished request. With the
        prefix cache the evicted KV RETIRES instead of freeing, so a resume
        that submits ``prompt + output`` with the remaining budget matches
        the retired blocks and prefills only the uncached suffix. Under
        greedy decoding the resumed stream continues the preempted one.
        The draft lane's cursor goes home; the lane is no longer active, so
        the next window or tick stages it as an inactive lane. The caller
        (serving/ingress.py) re-queues the request."""
        st = self.lanes[lane]
        if st is None:
            raise ValueError(f"preempt of idle lane {lane}")
        if st.budget <= 0:
            raise ValueError(f"preempt of finishing lane {lane}: it frees "
                             "itself on the next step")
        self.preemptions += 1
        self.tracer.count("preemptions")
        self.tracer.instant("lane_preempt", track="scheduler",
                            args={"lane": lane, "rid": st.req.rid})
        if self.drafts is not None:
            self.drafts.rollback(lane, 0)   # stale draft cache: cursor home
        return self._close_lane(lane).req

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
        self.tracer.gauge("peak_active", self.peak_active)
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
                c = piece.shape[1]
                with self._dispatch_span("prefill_chunk", "prefill",
                                         ({"m": c},),
                                         rid=self._admitting.req.rid,
                                         chunk=c, start=start):
                    pre_logits = self._prefill_chunk(piece, table, start)
                self.prefill_dispatches += 1
                self.tracer.count("prefill_dispatches")
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
        self.tracer.count("decode_steps", len(emitted))
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
        with self._dispatch_span("paged_verify", "verify",
                                 ({"verify": (k, self.W)},),
                                 k=k, lanes=len(active)):
            call = self._call("verify", k + 1)
            logits = call(*stage(tokens, tables, starts, device=self.device))
        self.verify_dispatches += 1
        self.decode_dispatches += 1      # the round's one TARGET dispatch
        self.tracer.count("verify_dispatches")
        self.tracer.count("decode_dispatches")
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
            self.tracer.count("spec_rounds")
            self.tracer.count("drafted_tokens", min(k, st.budget))
            self.tracer.count("accepted_tokens", min(n - 1, len(toks)))
            st.req.output.extend(toks)
            st.budget -= len(toks)
            self.decode_steps += len(toks)
            self.tracer.count("decode_steps", len(toks))
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
            loop = self._loop("tick")
            with self._dispatch_span("decode_step", "decode",
                                     ({"m": self.W},), active=len(active)):
                logits = loop(last, tables, lengths)
        else:
            piece, table, start = adm_chunk
            c = piece.shape[1]
            loop = self._loop("mixed-tick", c)
            with self._dispatch_span("mixed_step", "decode",
                                     ({"mixed": (c, self.W)},),
                                     active=len(active), chunk=c):
                logits, pre_logits = loop(
                    last, tables, lengths,
                    *stage(piece, table, start, device=self.device))
            pre_logits = pre_logits.clone()
            self.fused_steps += 1
            self.tracer.count("fused_steps")
        self.decode_dispatches += 1
        self.tracer.count("decode_dispatches")
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
        # core never imports serving: a live tracer only, or None
        win_tracer = self.tracer if self.tracer.enabled else None
        staged = self._lane_arrays(active, lambda st: min(w, st.budget))
        pre_logits = None
        if adm_chunk is None:
            loop = self._loop("window")
            # the window always runs w full-width steps (finished lanes are
            # masked, not skipped): predict what executes
            with self._dispatch_span("decode_window", "decode",
                                     ({"m": self.W, "steps": w},),
                                     window=w, active=len(active)):
                toks = window_replay(loop, staged, n_steps=w,
                                     tracer=win_tracer)
        else:
            piece, table, start = adm_chunk
            c = piece.shape[1]
            loop = self._loop("mixed-window", c)
            # step 0 carries the chunk (the MIXED decision), the w - 1 others
            # are plain full-width decode
            specs = [{"mixed": (c, self.W)}]
            if w > 1:
                specs.append({"m": self.W, "steps": w - 1})
            with self._dispatch_span("mixed_window", "decode", specs,
                                     window=w, active=len(active), chunk=c):
                toks, pre_logits = window_replay(
                    loop, (*staged,
                           *stage(piece, table, start, device=self.device)),
                    n_steps=w, mixed=True, tracer=win_tracer)
            pre_logits = pre_logits.clone()
            self.fused_steps += 1
            self.tracer.count("fused_steps")
        toks = toks.cpu().tolist()
        self.decode_dispatches += 1
        self.tracer.count("decode_dispatches")
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
