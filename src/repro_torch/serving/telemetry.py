"""Request-lifecycle telemetry (the reference's ``serving/telemetry.py``):
injectable clocks, per-request traces and SLO percentile reports for the
serving stack.

The paper's end-to-end claims are statements about what a USER sees —
time-to-first-token and per-token decode latency under a real request
stream — not about dispatch counts. The ingress (serving/ingress.py)
stamps every lifecycle event of every request against an injectable
:class:`Clock`, and :class:`Telemetry` turns the stamps into the latency
distribution the serving launcher reports.

Events per request (all optional except enqueue):

  enqueue  — the request ARRIVED (open loop: the generator's scheduled
             arrival time, whether or not the server was busy);
  admit    — the scheduler accepted it into the batcher (the first admit
             feeds queue delay; re-admits after preemption are counted);
  token    — one output token reached the stream (the first closes TTFT);
  preempt  — the scheduler evicted the request's KV mid-flight (it
             re-enters the queue and re-admits later);
  finish   — the terminal event.

Derived metrics (milliseconds in reports):

  TTFT        = first_token - enqueue        (queueing + prefill)
  queue-delay = admit - enqueue              (pure scheduling delay)
  TPOT        = (last_token - first_token) / (n_tokens - 1), the mean
                inter-token gap EXCLUDING the first token;
  goodput     = finished requests meeting the TTFT SLO per second of
                makespan (all finished requests when no SLO is given).

Every number is a pure function of the recorded timestamps: under
:class:`FakeClock` the same seeded workload gives bitwise-identical
reports. Production uses :class:`MonotonicClock`, the one wall-clock site
of the port; nothing here calls ``time.sleep``.
"""
from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable


# ------------------------------------------------------------------ clocks --

@runtime_checkable
class Clock(Protocol):
    """Injectable time source: ``now()`` in seconds plus an async ``sleep``
    so the ingress can wait for the next scheduled arrival without blocking
    the event loop (or, under FakeClock, without waiting at all)."""

    def now(self) -> float: ...

    async def sleep(self, dt: float) -> None: ...


class MonotonicClock:
    """Production clock: ``time.monotonic`` timestamps, real async sleeps.
    Not manually advanceable — pairing it with a virtual per-step cost
    (``step_time_s``) is rejected by the ingress."""

    def now(self) -> float:
        return time.monotonic()  # repolint: disable=determinism -- this class IS the injectable production clock, as the reference's serving/telemetry.py

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(max(dt, 0.0))


class FakeClock:
    """Deterministic test clock: time only moves when the test (or the
    ingress's virtual step cost) says so. ``sleep`` advances instantly and
    yields once to the event loop, so awaiting consumers interleave exactly
    as they would under a real clock — with zero wall-clock dependence."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        self._t += dt

    async def sleep(self, dt: float) -> None:
        self.advance(max(dt, 0.0))
        await asyncio.sleep(0)        # cooperative yield, never a real wait


# ------------------------------------------------------------- percentiles --

def percentile(values, q: float) -> Optional[float]:
    """Linearly-interpolated percentile (numpy's default 'linear' method,
    implemented here so the math under test has no external moving parts):
    the q-th percentile sits at fractional rank ``(n-1) * q/100`` of the
    sorted values. Returns None on an empty input; a singleton is every
    percentile of itself."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * (q / 100.0)
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi:
        return xs[lo]
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def summarize(values) -> dict:
    """p50/p95/p99 + mean/max/n of a metric sample (None-filled when
    empty) — the fixed shape every latency row in a report takes."""
    xs = [float(v) for v in values]
    if not xs:
        return {"n": 0, "mean": None, "p50": None, "p95": None,
                "p99": None, "max": None}
    return {
        "n": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": percentile(xs, 50.0),
        "p95": percentile(xs, 95.0),
        "p99": percentile(xs, 99.0),
        "max": max(xs),
    }


# ------------------------------------------------------------------ traces --

@dataclass
class RequestTrace:
    """One request's timestamped lifecycle (seconds, clock domain)."""
    rid: int
    priority: int = 0
    enqueue_t: float = 0.0
    admit_t: Optional[float] = None       # FIRST admit (queue-delay anchor)
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_tokens: int = 0
    token_ts: list = field(default_factory=list)
    preemptions: int = 0
    readmits: int = 0                     # admits after the first

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.enqueue_t

    @property
    def queue_delay(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        # clamp: an admission in the same tick the arrival was released can
        # stamp admit_t one float ulp below the scheduled enqueue_t (the
        # clock reaches the same instant via a different summation order);
        # queueing delay is non-negative by definition
        return max(0.0, self.admit_t - self.enqueue_t)

    @property
    def tpot(self) -> Optional[float]:
        """Mean inter-token time over tokens AFTER the first — TTFT (and
        therefore queueing + prefill) never leaks into the decode number.
        Undefined below two tokens."""
        if self.n_tokens < 2:
            return None
        return (self.last_token_t - self.first_token_t) / (self.n_tokens - 1)

    @property
    def finished(self) -> bool:
        return self.finish_t is not None


class Telemetry:
    """Event recorder: the ingress calls ``on_*`` as lifecycle events
    happen; ``report()`` folds the traces into the percentile dict the
    benchmarks emit. Timestamps default to ``clock.now()`` but every hook
    takes an explicit ``at=`` so open-loop arrivals can be stamped at their
    SCHEDULED time even when the server notices them late (that lateness is
    exactly the queueing the metric must see)."""

    def __init__(self, clock: Clock | None = None):
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        self.traces: dict[int, RequestTrace] = {}

    # ------------------------------------------------------------- events --
    def _at(self, at: Optional[float]) -> float:
        return self.clock.now() if at is None else float(at)

    def _trace(self, rid: int) -> RequestTrace:
        try:
            return self.traces[rid]
        except KeyError:
            raise KeyError(f"request {rid} was never enqueued") from None

    def on_enqueue(self, rid: int, *, priority: int = 0,
                   at: Optional[float] = None) -> RequestTrace:
        if rid in self.traces:
            raise ValueError(f"request {rid} already enqueued")
        tr = RequestTrace(rid=rid, priority=priority, enqueue_t=self._at(at))
        self.traces[rid] = tr
        return tr

    def on_admit(self, rid: int, at: Optional[float] = None) -> None:
        tr = self._trace(rid)
        if tr.admit_t is None:
            tr.admit_t = self._at(at)
        else:
            tr.readmits += 1             # resume after preemption

    def on_token(self, rid: int, at: Optional[float] = None) -> None:
        tr = self._trace(rid)
        t = self._at(at)
        if tr.first_token_t is None:
            tr.first_token_t = t
        tr.last_token_t = t
        tr.n_tokens += 1
        tr.token_ts.append(t)

    def on_preempt(self, rid: int, at: Optional[float] = None) -> None:
        self._trace(rid).preemptions += 1
        del at                            # preemption is a count, not a stamp

    def on_finish(self, rid: int, at: Optional[float] = None) -> None:
        tr = self._trace(rid)
        if tr.finish_t is not None:
            raise ValueError(f"request {rid} finished twice")
        tr.finish_t = self._at(at)

    # ------------------------------------------------------------- report --
    def report(self, slo_ms: Optional[float] = None) -> dict:
        """Aggregate the traces: TTFT / TPOT / queue-delay summaries in
        MILLISECONDS, throughput, and goodput against an optional TTFT SLO.
        A pure function of the recorded stamps — same events, same bits."""
        trs = list(self.traces.values())
        done = [t for t in trs if t.finished]
        ms = 1e3
        rep = {
            "n_requests": len(trs),
            "n_finished": len(done),
            "n_tokens": sum(t.n_tokens for t in trs),
            "preemptions": sum(t.preemptions for t in trs),
            "ttft_ms": summarize([t.ttft * ms for t in trs
                                  if t.ttft is not None]),
            "tpot_ms": summarize([t.tpot * ms for t in trs
                                  if t.tpot is not None]),
            "queue_delay_ms": summarize([t.queue_delay * ms for t in trs
                                         if t.queue_delay is not None]),
        }
        if done:
            t0 = min(t.enqueue_t for t in trs)
            t1 = max(t.finish_t for t in done)
            makespan = t1 - t0
            rep["makespan_s"] = makespan
            rep["throughput_tok_s"] = (
                sum(t.n_tokens for t in done) / makespan if makespan > 0
                else None)
            good = [t for t in done
                    if slo_ms is None
                    or (t.ttft is not None and t.ttft * ms <= slo_ms)]
            rep["slo_ms"] = slo_ms
            rep["slo_attainment"] = len(good) / len(done)
            rep["goodput_req_s"] = (len(good) / makespan if makespan > 0
                                    else None)
        else:
            rep.update({"makespan_s": None, "throughput_tok_s": None,
                        "slo_ms": slo_ms, "slo_attainment": None,
                        "goodput_req_s": None})
        return rep
