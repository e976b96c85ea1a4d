"""Open-loop async serving ingress (the reference's
``serving/ingress.py``): arrival generators, priority admission with
backpressure, preemption, and per-request token streaming, in front of
either batcher of serving/scheduler.py.

  * **Arrival generators** — seeded Poisson (:func:`poisson_arrivals`) and
    bursty on-off (:func:`burst_arrivals`) processes give deterministic
    arrival times (numpy's seeded generator: the reference's times, bit
    for bit); the same seed replays the same trace.
  * **Ingress queue** — :meth:`AsyncServer.submit` records the arrival with
    :class:`~repro_torch.serving.telemetry.Telemetry` and parks the request
    in a priority queue (higher ``priority`` wins; FIFO within a class).
  * **Admission + backpressure** — each tick admits the highest-priority
    runnable requests into the batcher, DEFERRING admission whenever it
    would leave fewer than ``admit_watermark`` free-plus-cached blocks in
    the paged pool (headroom for the decode-time growth of running lanes).
  * **Preemption** — when a higher-priority request is blocked, the
    lowest-priority (then youngest) running lane is evicted:
    ``PagedBatcher.preempt`` closes its sequence through the prefix cache
    (full KV blocks RETIRE instead of freeing), and the request re-enters
    the queue as ``prompt + tokens-so-far`` with its remaining budget, so a
    resume with the cache on re-prefills only the uncached suffix.
  * **Streaming** — ``submit`` returns a :class:`RequestHandle`, an async
    iterator of output tokens with exactly one terminal event;
    ``handle.tokens`` accumulates the stream (a resumed request continues
    its stream, no token is re-emitted).

Tensor-parallel serving (``PagedBatcher(mesh=)``, one process per rank)
admits ONCE for the whole model group: ``AsyncServer(..., tick_sync=
TickBroadcast(group))``. The group's first rank (the leader) runs the
loop on its own clock and broadcasts each loop iteration's decisions —
the arrivals it submitted, then either a tick's admission events
(admissions, deferrals, preemptions, in order), a sleep, or the stop —
with ``broadcast_object_list``; the other ranks (followers) apply them
and never admit on their own clocks, so every rank's batcher takes the
same submits and preemptions in the same order and steps alike.

The server never reads the wall clock itself: every stamp comes from the
injected :class:`Clock`. Under :class:`FakeClock` the loop only advances
virtual time (arrival sleeps collapse to ``advance``; ``step_time_s``
charges a fixed virtual cost per tick), so tests run with no real sleep and
bitwise-reproducible telemetry. Under :class:`MonotonicClock` the same loop
serves in real time.
"""
from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .scheduler import ContinuousBatcher, PagedBatcher, Request
from .telemetry import Clock, MonotonicClock, Telemetry
from .trace import NULL_TRACER

__all__ = [
    "AsyncServer", "RequestHandle", "TickBroadcast", "poisson_arrivals",
    "burst_arrivals", "arrival_times",
]


# ------------------------------------------------------------- arrivals ----

def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Absolute arrival times of a Poisson process: ``n`` exponential
    inter-arrival gaps at ``rate`` requests/second, from a seeded
    generator — the memoryless baseline load shape."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def burst_arrivals(rate: float, n: int, seed: int = 0, *,
                   burst_size: int = 4, duty: float = 0.2) -> np.ndarray:
    """Bursty on-off arrivals at the same LONG-RUN rate as the Poisson
    process: requests land in bursts of ~``burst_size`` at ``rate/duty``
    (the on phase), separated by off gaps sized so the overall mean stays
    ``rate``. Tail latency under this shape is the backpressure test the
    smooth process never applies."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while len(out) < n:
        for _ in range(min(burst_size, n - len(out))):
            t += float(rng.exponential(duty / rate))       # on: dense
            out.append(t)
        t += float(rng.exponential(burst_size * (1.0 - duty) / rate))
    return np.asarray(out[:n])


def arrival_times(kind: str, rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Name-dispatched generator (the ``--arrival`` CLI contract)."""
    if kind == "poisson":
        return poisson_arrivals(rate, n, seed)
    if kind == "burst":
        return burst_arrivals(rate, n, seed)
    raise ValueError(f"unknown arrival process {kind!r} "
                     "(expected 'poisson' or 'burst')")


# -------------------------------------------------------------- streaming --

class RequestHandle:
    """One request's streaming endpoint: an async iterator of output token
    ids, terminated by exactly one finish event. ``tokens`` accumulates
    everything emitted so far (survives preemption: the resumed request
    appends, never replays)."""

    def __init__(self, rid: int, priority: int = 0):
        self.rid = rid
        self.priority = priority
        self.tokens: list[int] = []
        self.done = False
        self.terminal_events = 0         # the exactly-once contract, pinned
        self._queue: asyncio.Queue = asyncio.Queue()

    def _put_token(self, tok: int) -> None:
        if self.done:
            raise RuntimeError(f"request {self.rid}: token after finish")
        self.tokens.append(tok)
        self._queue.put_nowait(tok)

    def _finish(self) -> None:
        if self.done:
            raise RuntimeError(f"request {self.rid}: finished twice")
        self.done = True
        self.terminal_events += 1
        self._queue.put_nowait(None)     # terminal sentinel

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self.done and self._queue.empty():
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item


# ------------------------------------------------------- one admission --

class TickBroadcast:
    """The leader's loop decisions to the other ranks of ``group`` (a
    ``torch.distributed`` group: the mesh's ``model`` group), one
    ``broadcast_object_list`` per loop iteration from the group's first
    rank."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.src = dist.get_global_rank(group, 0)
        self.leader = dist.get_rank(group) == 0

    def send(self, msg: dict) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([msg], src=self.src, group=self.group)

    def recv(self) -> dict:
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


# ------------------------------------------------------------- the server --

@dataclass
class _Entry:
    """Ingress-side request state across admissions (preemption survives)."""
    rid: int
    prompt: np.ndarray                  # the ORIGINAL prompt
    max_new_tokens: int
    priority: int
    seq_no: int                         # FIFO tiebreak within a priority
    handle: RequestHandle
    state: str = "queued"               # queued | running | done
    cur_req: Optional[Request] = None   # the batcher-side request object
    streamed: int = 0                   # cur_req.output tokens streamed
    emitted: list = field(default_factory=list)   # across all attempts


class AsyncServer:
    """Asyncio request-lifecycle layer over a batcher (paged or dense).

    The server owns the ingress queue and drives the batcher's tick loop;
    the batcher stays a synchronous, deterministic core. One tick =
    admission phase (priority order, watermark-gated, possibly
    preempting) -> one ``batcher.step()`` -> stream-drain phase (new
    tokens to handles + telemetry stamps).

    ``admit_watermark`` (paged only): admission is deferred while it would
    leave fewer than this many free+cached blocks — the backpressure that
    keeps decode-time growth of running lanes from hitting OutOfBlocks
    under open-loop load. ``preempt=True`` additionally lets a blocked
    higher-priority request evict the lowest-priority running lane.

    ``step_time_s`` charges a fixed VIRTUAL duration per tick on an
    advanceable clock (FakeClock) — deterministic stand-in for device time,
    so latency percentiles are meaningful and bitwise-reproducible in
    tests; it is rejected on a wall clock, where real time passes by
    itself.

    ``tick_sync`` (a :class:`TickBroadcast`): one admission for a
    tensor-parallel group — its leader decides, its followers apply.
    """

    def __init__(self, batcher, *, clock: Clock | None = None,
                 telemetry: Telemetry | None = None,
                 admit_watermark: int = 0, preempt: bool = True,
                 step_time_s: float | None = None,
                 max_ticks: int = 100_000, tracer=None,
                 tick_sync: TickBroadcast | None = None):
        if not isinstance(batcher, (PagedBatcher, ContinuousBatcher)):
            raise TypeError(f"unsupported batcher {type(batcher).__name__}")
        self.batcher = batcher
        self.paged = isinstance(batcher, PagedBatcher)
        if admit_watermark and not self.paged:
            raise ValueError("admit_watermark applies to the paged batcher")
        if admit_watermark < 0:
            raise ValueError(f"admit_watermark must be >= 0, "
                             f"got {admit_watermark}")
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        if step_time_s is not None and not hasattr(self.clock, "advance"):
            raise ValueError("step_time_s needs an advanceable clock "
                             "(FakeClock); a wall clock advances itself")
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry(self.clock))
        # default to the batcher's tracer so one Tracer sees the whole
        # lifecycle: ingress events land beside the dispatches they caused
        self.tracer = (tracer if tracer is not None
                       else getattr(batcher, "tracer", NULL_TRACER))
        self.admit_watermark = admit_watermark
        self.preempt_enabled = preempt and self.paged
        self.step_time_s = step_time_s
        self.max_ticks = max_ticks
        self.ticks = 0
        self.preemptions = 0             # lane evictions this server issued
        self.deferrals = 0               # watermark/capacity admission defers
        self._entries: dict[int, _Entry] = {}
        self._order: list[_Entry] = []   # submit order (stable rid listing)
        self._next_rid = 0
        self._next_seq = 0
        self.tick_sync = tick_sync
        self._due: list = []             # arrivals submitted this iteration

    # ------------------------------------------------------------- intake --
    def submit(self, prompt, max_new_tokens: int = 16, *, priority: int = 0,
               rid: Optional[int] = None,
               at: Optional[float] = None) -> RequestHandle:
        """Enqueue a request, stamping its arrival (``at`` = the scheduled
        open-loop arrival time; default: now). Returns the token-stream
        handle immediately — admission happens on later ticks."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if rid is None:
            rid = self._next_rid
        if rid in self._entries:
            raise ValueError(f"duplicate request id {rid}")
        self._next_rid = max(self._next_rid, rid) + 1
        handle = RequestHandle(rid, priority)
        entry = _Entry(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                       priority=priority, seq_no=self._next_seq,
                       handle=handle)
        self._next_seq += 1
        self._entries[rid] = entry
        self._order.append(entry)
        self.telemetry.on_enqueue(rid, priority=priority, at=at)
        self.tracer.request_event("enqueue", rid, at=at,
                                  args={"priority": priority,
                                        "prompt_tokens": int(prompt.size),
                                        "max_new_tokens": max_new_tokens})
        return handle

    @property
    def handles(self) -> list[RequestHandle]:
        return [e.handle for e in self._order]

    # ---------------------------------------------------------- admission --
    def _queued(self) -> list[_Entry]:
        """Waiting entries in admission order: priority desc, then FIFO
        (a preempted request keeps its original seq_no, so it resumes ahead
        of younger work in its class)."""
        q = [e for e in self._order if e.state == "queued"]
        q.sort(key=lambda e: (-e.priority, e.seq_no))
        return q

    def _remaining(self, entry: _Entry) -> tuple[np.ndarray, int]:
        """The (prompt, budget) a (re-)admission submits: tokens already
        emitted extend the prompt — under greedy decoding the continuation
        is exactly the stream the un-preempted request would have
        produced."""
        if not entry.emitted:
            return entry.prompt, entry.max_new_tokens
        prompt = np.concatenate([
            entry.prompt, np.asarray(entry.emitted, np.int32)])
        return prompt, entry.max_new_tokens - len(entry.emitted)

    def _admit_phase(self, events: Optional[list] = None) -> int:
        """Push runnable requests into the batcher, highest priority first,
        debiting a virtual free-block/lane budget so one tick never
        over-admits. Strict priority: a blocked request blocks its
        inferiors (and may preempt one of them). A follower applies the
        leader's ``events`` instead; the leader sends the events it made."""
        if events is not None:
            return self._apply(events)
        made: list = []
        admitted = self._decide(made)
        if self.tick_sync is not None:
            self.tick_sync.send({"arrivals": self._due, "action": "tick",
                                 "events": made})
        return admitted

    def _apply(self, events: list) -> int:
        admitted = 0
        for kind, rid, arg in events:
            entry = self._entries[rid]
            if kind == "admit":
                self._admit(entry)
                admitted += 1
            elif kind == "defer":
                self._defer()
            else:                        # preempt lane ``arg`` for ``rid``
                self._preempt_lane(arg, entry)
        return admitted

    def _defer(self) -> None:
        self.deferrals += 1
        self.tracer.count("ingress_deferrals")

    def _admit(self, entry: _Entry) -> None:
        prompt, budget = self._remaining(entry)
        req = Request(rid=entry.rid, prompt=prompt, max_new_tokens=budget)
        self.batcher.submit(req)
        resumed = bool(entry.emitted)
        entry.cur_req = req
        entry.streamed = 0
        entry.state = "running"
        self.telemetry.on_admit(entry.rid)
        self.tracer.request_event("resume" if resumed else "admit",
                                  entry.rid)

    def _decide(self, made: list) -> int:
        b = self.batcher
        if self.paged:
            free_lanes = sum(lane is None for lane in b.lanes)
            if b.mixed_batch:
                # one admission ticket at a time; its prefill spans ticks
                free_lanes = min(free_lanes,
                                 1 if (b._admitting is None
                                       and not b.queue) else 0)
            virtual_free = b.kv.n_free_unreserved
        else:
            free_lanes = sum(s is None for s in b.slots)
            virtual_free = 0
        admitted = 0
        for entry in self._queued():
            prompt, budget = self._remaining(entry)
            if self.paged:
                need = b.kv.blocks_for(len(prompt) + budget)
                ok = (free_lanes > 0 and need <= b.kv.max_blocks_per_seq
                      and virtual_free - need >= self.admit_watermark)
            else:
                need = 0
                ok = free_lanes > 0
            if not ok:
                self._defer()
                made.append(("defer", entry.rid, None))
                lane = self._try_preempt(entry)
                if lane is not None:
                    made.append(("preempt", entry.rid, lane))
                break                    # strict priority FCFS
            self._admit(entry)
            made.append(("admit", entry.rid, None))
            free_lanes -= 1
            virtual_free -= need
            admitted += 1
        return admitted

    def _try_preempt(self, blocked: _Entry) -> Optional[int]:
        """Evict one running lane strictly below ``blocked``'s priority:
        lowest priority first, youngest admission within it (least work
        lost is not the goal — freeing capacity for the high lane is).
        The victim's sequence closes through the prefix cache and the
        request re-enters the queue with its progress folded into the
        prompt. Returns the evicted lane, or None."""
        if not self.preempt_enabled:
            return None
        b = self.batcher
        victims = []
        for i, lane in enumerate(b.lanes):
            if lane is None or lane.budget <= 0:
                continue                 # finishing lanes free themselves
            entry = self._entries.get(lane.req.rid)
            if entry is None or entry.priority >= blocked.priority:
                continue
            victims.append((entry.priority, -entry.seq_no, i, entry))
        if not victims:
            return None
        victims.sort(key=lambda v: v[:3])
        lane_idx = victims[0][2]
        self._preempt_lane(lane_idx, blocked)
        return lane_idx

    def _preempt_lane(self, lane_idx: int, blocked: _Entry) -> None:
        victim = self._entries[self.batcher.lanes[lane_idx].req.rid]
        self.batcher.preempt(lane_idx)
        victim.cur_req = None
        victim.state = "queued"
        self.preemptions += 1
        self.tracer.count("ingress_preemptions")
        self.telemetry.on_preempt(victim.rid)
        self.tracer.request_event("preempt", victim.rid,
                                  args={"by": blocked.rid,
                                        "lane": lane_idx})

    # ------------------------------------------------------------ the loop --
    def _drain_phase(self) -> None:
        """Stream every token the last step produced (stamped at the
        post-step clock) and fire terminal events for finished requests."""
        for entry in self._order:
            if entry.state != "running":
                continue
            req = entry.cur_req
            new = req.output[entry.streamed:]
            for tok in new:
                entry.handle._put_token(int(tok))
                self.telemetry.on_token(entry.rid)
            entry.emitted.extend(int(t) for t in new)
            entry.streamed = len(req.output)
            if req.done:
                entry.state = "done"
                self.telemetry.on_finish(entry.rid)
                self.tracer.request_event(
                    "finish", entry.rid,
                    args={"tokens": len(entry.emitted)})
                entry.handle._finish()

    def _tick(self, events: Optional[list] = None) -> bool:
        """One scheduler iteration: admit -> step -> drain. Returns True if
        anything progressed (admission or batcher work). ``events``: a
        follower's admission, as the leader made it."""
        self.ticks += 1
        self.tracer.count("ingress_ticks")
        with self.tracer.span("tick", track="ingress"):
            admitted = self._admit_phase(events)
            progressed = False
            if self.batcher.busy:
                progressed = bool(self.batcher.step())
                if self.step_time_s is not None and (progressed or admitted):
                    self.clock.advance(self.step_time_s)
            self._drain_phase()
        return bool(admitted) or progressed

    @property
    def _has_work(self) -> bool:
        return (self.batcher.busy
                or any(e.state != "done" for e in self._order))

    async def run(self, arrivals: Iterable[tuple[float, dict]] = (),
                  ) -> list[RequestHandle]:
        """Drive the server until every submitted request (and every
        scheduled arrival) finishes. ``arrivals`` is an iterable of
        ``(time, submit_kwargs)`` — the open-loop source: each request is
        submitted when the clock reaches its time, stamped AT that time
        (the arrival happened whether or not the server was busy). Between
        ticks the loop yields to the event loop, so ``async for`` consumers
        stream concurrently; when idle it sleeps (virtually, under
        FakeClock) until the next arrival. Returns all handles in submit
        order. A follower of a :class:`TickBroadcast` ignores
        ``arrivals`` and runs the leader's loop (:meth:`_follow`)."""
        if self.tick_sync is not None and not self.tick_sync.leader:
            return await self._follow()
        pending = deque(sorted(arrivals, key=lambda a: a[0]))
        stalled = 0
        while True:
            now = self.clock.now()
            self._due = []
            while pending and pending[0][0] <= now + 1e-9:
                t, kw = pending.popleft()
                self.submit(**kw, at=t)
                self._due.append((t, kw))
            if self._has_work:
                progressed = self._tick()
                try:
                    if self.ticks > self.max_ticks:
                        raise RuntimeError(
                            f"ingress exceeded max_ticks={self.max_ticks}")
                    if progressed or self.batcher.busy:
                        stalled = 0
                    else:
                        # queued work, idle batcher, nothing admitted: only
                        # an arrival or a freed lane could unblock — with
                        # neither in sight this is a permanent stall, fail
                        # loudly
                        stalled += 1
                        if not pending and stalled > 2:
                            blocked = [e.rid for e in self._queued()]
                            raise RuntimeError(
                                f"ingress stalled: requests {blocked} can "
                                f"never admit (watermark="
                                f"{self.admit_watermark}, pool too small, or "
                                "every lane above their priority)")
                except RuntimeError as e:
                    self._send({"action": "abort", "error": str(e)})
                    raise
                await asyncio.sleep(0)   # let stream consumers run
            elif pending:
                self._send({"arrivals": self._due, "action": "sleep",
                            "dt": pending[0][0] - now})
                await self.clock.sleep(pending[0][0] - now)
            else:
                self._send({"arrivals": self._due, "action": "stop"})
                break
        return self.handles

    def _send(self, msg: dict) -> None:
        if self.tick_sync is not None:
            self.tick_sync.send(msg)

    async def _follow(self) -> list[RequestHandle]:
        """A follower's loop: each of the leader's iterations as it
        broadcast it — its arrivals submitted at their times, then its
        tick (with its admission events), sleep or stop."""
        while True:
            msg = self.tick_sync.recv()
            if msg["action"] == "abort":
                raise RuntimeError(msg["error"])
            for t, kw in msg["arrivals"]:
                self.submit(**kw, at=t)
            if msg["action"] == "tick":
                self._tick(msg["events"])
                await asyncio.sleep(0)
            elif msg["action"] == "sleep":
                await self.clock.sleep(msg["dt"])
            else:
                break
        return self.handles

    def run_sync(self, arrivals: Iterable[tuple[float, dict]] = (),
                 ) -> list[RequestHandle]:
        """``asyncio.run`` wrapper for non-async callers (benchmarks, the
        CLI's closed-loop path)."""
        return asyncio.run(self.run(arrivals))

    # -------------------------------------------------------------- stats --
    def stats(self) -> dict:
        """Batcher counters + ingress-level admission/preemption counters."""
        s = dict(self.batcher.stats())
        s.update({"ingress_ticks": self.ticks,
                  "ingress_preemptions": self.preemptions,
                  "ingress_deferrals": self.deferrals})
        return s

    def report(self, slo_ms: Optional[float] = None) -> dict:
        return self.telemetry.report(slo_ms=slo_ms)


def open_loop_workload(prompts, budgets, times, priorities=None
                       ) -> list[tuple[float, dict]]:
    """Zip a prompt set with arrival times into ``AsyncServer.run``'s
    arrival schedule (rid = position, so references index directly)."""
    if priorities is None:
        priorities = [0] * len(prompts)
    return [(float(t), dict(prompt=p, max_new_tokens=int(m), rid=i,
                            priority=int(pr)))
            for i, (p, m, t, pr) in enumerate(
                zip(prompts, budgets, times, priorities))]
