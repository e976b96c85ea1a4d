"""Serving-wide structured tracing, metrics exposition and solver
plan-vs-actual drift accounting (the reference's ``serving/trace.py``).

The paper's design is a characterize -> plan loop: profiled per-processor
costs drive the ``PartitionSolver``'s per-(site, M) decisions. This module
closes it with three instruments behind one object:

  * :class:`Tracer` — a ring-buffered span/event recorder on the serving
    stack's injectable :class:`~repro_torch.serving.telemetry.Clock`. Every
    request lifecycle event (enqueue/admit/preempt/resume/finish, with
    per-request flow arrows), every dispatch (prefill chunk, decode step,
    decode window, mixed step or window, spec draft round, ``paged_verify``)
    and every prefix-cache event (hit/CoW/evict) becomes a structured
    event, tagged with the solver decisions that planned it (site, M,
    strategy, predicted ``t_us``). Exported as Chrome trace-event JSON
    (:meth:`Tracer.to_chrome`) and a Prometheus-style text snapshot
    (:meth:`Tracer.to_prometheus`).
  * :class:`MetricsRegistry` — counters / gauges / histograms whose counter
    names MATCH the batchers' ``stats()`` keys, so the two ledgers
    reconcile exactly (:func:`counter_reconciliation`).
  * :class:`DriftAggregator` — measured dispatch durations attributed per
    (site, M, strategy) against the solver's predictions, with the
    decisions whose measured ordering contradicts the plan.

What a dispatch span measures on the card. CUDA launches are asynchronous:
a span that closed when the host returned would time the host's issue
work, not the dispatch. So with a live tracer the batchers close every
dispatch span after fencing the device (``core/sync.py::fence``), and the
captured window's ``fused_window`` span closes after its replay is fenced:
a span's duration is the dispatch's host issue plus its device execution
up to the fence. With :data:`NULL_TRACER` (the default) nothing fences and
nothing is recorded, so an untraced run launches and waits exactly as the
uninstrumented stack does. On the CPU the fence is a no-op.

Determinism: the tracer never reads the wall clock itself — every
timestamp comes from the injected clock — and never sleeps. Under
:class:`~repro_torch.serving.telemetry.FakeClock` identical runs give
BYTE-identical artifacts (:meth:`Tracer.save_chrome` writes sorted keys and
fixed separators). An optional ``cost_model`` advances an advanceable clock
by a deterministic virtual duration inside each dispatch span, so traced
virtual-time runs have nonzero, reproducible durations without a timer.

Zero overhead when off: the batchers default to the shared
:data:`NULL_TRACER`, whose every method is a no-op returning a reusable
null context; call sites guard tag computation on ``tracer.enabled``.
"""
from __future__ import annotations

import json
from collections import deque
from contextlib import contextmanager
from pathlib import Path

from .telemetry import Clock, MonotonicClock

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "MetricsRegistry",
    "DriftAggregator", "counter_reconciliation",
    "STATS_COUNTER_KEYS", "STATS_GAUGE_KEYS",
]

_PID = 1        # one serving process per trace

# stats() keys that are mirrored 1:1 by tracer counters/gauges: whenever a
# scheduler/ingress/pool python counter moves, the tracer counter of the
# SAME name moves with it. counter_reconciliation() asserts the two ledgers
# agree exactly — the contract the fuzz cross-check arm pins on every arm.
STATS_COUNTER_KEYS = (
    "decode_dispatches", "decode_steps", "prefill_dispatches", "fused_steps",
    "preemptions", "spec_rounds", "drafted_tokens", "accepted_tokens",
    "verify_dispatches", "draft_dispatches",
    "prefix_hits", "prefix_tokens_reused", "evictions", "cow_copies",
    "ingress_ticks", "ingress_preemptions", "ingress_deferrals",
)
STATS_GAUGE_KEYS = ("peak_active", "cached_blocks")

# histogram bucket upper bounds, microseconds (dispatch durations)
DEFAULT_BUCKETS_US = (50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 25000.0, 50000.0, 100000.0)


def _fmt_num(v) -> str:
    """Stable numeric rendering: integral values print as ints, the rest
    as ``repr(float)`` — same value, same bytes, every run."""
    fv = float(v)
    return str(int(fv)) if fv.is_integer() else repr(fv)


# ----------------------------------------------------------------- metrics --

class MetricsRegistry:
    """Counters, gauges and histograms with optional labels, rendered as a
    Prometheus-style text snapshot. All keys are (name, sorted-label-tuple);
    rendering is fully sorted, so equal contents always produce equal
    bytes."""

    def __init__(self, buckets=DEFAULT_BUCKETS_US):
        self.buckets = tuple(sorted(buckets))
        self._counters: dict = {}      # (name, labels) -> float
        self._gauges: dict = {}        # (name, labels) -> float
        # (name, labels) -> [per-bucket counts..., overflow], sum, count
        self._hists: dict = {}

    @staticmethod
    def _key(name, labels):
        return name, tuple(sorted(labels.items()))

    def count(self, name: str, n=1, **labels) -> None:
        key = self._key(name, labels)
        self._counters[key] = self._counters.get(key, 0) + n

    def gauge(self, name: str, value, **labels) -> None:
        self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = {"counts": [0] * (len(self.buckets) + 1),
                                    "sum": 0.0, "count": 0}
        v = float(value)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                h["counts"][i] += 1
                break
        else:
            h["counts"][-1] += 1       # overflow (+Inf bucket)
        h["sum"] += v
        h["count"] += 1

    def value(self, name: str, **labels):
        """Current counter-or-gauge value (0 when never touched)."""
        key = self._key(name, labels)
        if key in self._counters:
            return self._counters[key]
        return self._gauges.get(key, 0)

    # ------------------------------------------------------------ render --
    @staticmethod
    def _labels(items, extra=()) -> str:
        items = list(items) + list(extra)
        if not items:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition: ``# HELP``/``# TYPE`` headers,
        counters suffixed ``_total``, histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``. Deterministic:
        metric names and label sets render sorted."""
        lines: list[str] = []
        for name in sorted({n for (n, _) in self._counters}):
            fq = f"{prefix}{name}_total"
            lines += [f"# HELP {fq} {name} (counter)",
                      f"# TYPE {fq} counter"]
            for (n, labels), v in sorted(self._counters.items()):
                if n == name:
                    lines.append(f"{fq}{self._labels(labels)} {_fmt_num(v)}")
        for name in sorted({n for (n, _) in self._gauges}):
            fq = f"{prefix}{name}"
            lines += [f"# HELP {fq} {name} (gauge)", f"# TYPE {fq} gauge"]
            for (n, labels), v in sorted(self._gauges.items()):
                if n == name:
                    lines.append(f"{fq}{self._labels(labels)} {_fmt_num(v)}")
        for name in sorted({n for (n, _) in self._hists}):
            fq = f"{prefix}{name}"
            lines += [f"# HELP {fq} {name} (histogram)",
                      f"# TYPE {fq} histogram"]
            for (n, labels), h in sorted(self._hists.items()):
                if n != name:
                    continue
                cum = 0
                for ub, c in zip(self.buckets, h["counts"]):
                    cum += c
                    lines.append(
                        f"{fq}_bucket"
                        f"{self._labels(labels, [('le', _fmt_num(ub))])}"
                        f" {cum}")
                cum += h["counts"][-1]
                lines.append(f"{fq}_bucket"
                             f"{self._labels(labels, [('le', '+Inf')])}"
                             f" {cum}")
                lines.append(f"{fq}_sum{self._labels(labels)}"
                             f" {_fmt_num(h['sum'])}")
                lines.append(f"{fq}_count{self._labels(labels)}"
                             f" {h['count']}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------- plan drift --

class DriftAggregator:
    """Predicted-vs-observed accounting per solver decision.

    Each traced dispatch attributes its measured duration across the
    decisions that planned it, proportionally to each decision's predicted
    share (``t_us x count``, where count folds in per-layer repetition and
    window steps); :meth:`record` accumulates (n, predicted, observed) per
    (site, M, strategy) key. :meth:`report` emits one residual row per
    decision exercised, plus CONTRADICTIONS: (site, M) keys where the
    strategy measured fastest is not the strategy predicted fastest — the
    would-have-been-faster alternative the plan missed."""

    def __init__(self):
        self._acc: dict = {}     # (site, M, strategy) -> [n, pred_us, obs_us]

    def record(self, site: str, M: int, strategy: str, *,
               predicted_us: float, observed_us: float) -> None:
        key = (site, int(M), strategy)
        a = self._acc.get(key)
        if a is None:
            a = self._acc[key] = [0, 0.0, 0.0]
        a[0] += 1
        a[1] += float(predicted_us)
        a[2] += float(observed_us)

    @property
    def n_decisions(self) -> int:
        return len(self._acc)

    def report(self) -> dict:
        rows = []
        for (site, M, strat), (n, ps, os_) in sorted(self._acc.items()):
            pred, obs = ps / n, os_ / n
            rows.append({
                "site": site, "M": M, "strategy": strat, "n": n,
                "predicted_us": pred, "observed_us": obs,
                "residual_us": obs - pred,
                "ratio": (obs / pred) if pred > 0 else None,
            })
        by_sm: dict = {}
        for r in rows:
            by_sm.setdefault((r["site"], r["M"]), []).append(r)
        contradictions = []
        for (site, M), group in sorted(by_sm.items()):
            if len(group) < 2:
                continue            # one strategy observed: no ordering to test
            planned = min(group, key=lambda r: r["predicted_us"])
            fastest = min(group, key=lambda r: r["observed_us"])
            if planned["strategy"] != fastest["strategy"]:
                contradictions.append({
                    "site": site, "M": M,
                    "planned": planned["strategy"],
                    "planned_predicted_us": planned["predicted_us"],
                    "planned_observed_us": planned["observed_us"],
                    "faster": fastest["strategy"],
                    "faster_observed_us": fastest["observed_us"],
                })
        return {"rows": rows, "contradictions": contradictions}

    def format_table(self) -> str:
        """Human-readable plan-drift table (what ``serve.py --plan-drift``
        prints)."""
        rep = self.report()
        if not rep["rows"]:
            return ("plan-drift: no solver-tagged dispatches recorded "
                    "(run with --engine-mode to attach a plan)")
        lines = [f"{'site':<10} {'M':>6} {'strategy':<10} {'n':>5} "
                 f"{'pred_us':>10} {'obs_us':>10} {'resid_us':>10} "
                 f"{'obs/pred':>8}"]
        for r in rep["rows"]:
            ratio = f"{r['ratio']:.3f}" if r["ratio"] is not None else "-"
            lines.append(
                f"{r['site']:<10} {r['M']:>6} {r['strategy']:<10} "
                f"{r['n']:>5} {r['predicted_us']:>10.1f} "
                f"{r['observed_us']:>10.1f} {r['residual_us']:>+10.1f} "
                f"{ratio:>8}")
        for c in rep["contradictions"]:
            lines.append(
                f"CONTRADICTION {c['site']}[M={c['M']}]: plan chose "
                f"{c['planned']} ({c['planned_observed_us']:.1f}us observed)"
                f" but {c['faster']} measured faster "
                f"({c['faster_observed_us']:.1f}us)")
        lines.append(f"({len(rep['rows'])} decision rows, "
                     f"{len(rep['contradictions'])} contradictions)")
        return "\n".join(lines)


# ------------------------------------------------------------- the tracer --

class _NullCtx:
    """Reusable no-op context manager (the disabled-tracer span)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The default: every hook is a no-op. ``enabled`` is the guard call
    sites use to skip tag/prediction computation entirely, so an
    uninstrumented run does no extra work and records nothing."""
    enabled = False

    def span(self, *a, **k):
        return _NULL_CTX

    def dispatch(self, *a, **k):
        return _NULL_CTX

    def instant(self, *a, **k):
        pass

    def request_event(self, *a, **k):
        pass

    def count(self, *a, **k):
        pass

    def gauge(self, *a, **k):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Ring-buffered structured tracer on an injectable clock.

    ``capacity`` bounds the event buffer (oldest events drop first;
    ``dropped`` counts them — bounded memory under open-loop load).
    ``cost_model(kind, predicted_us) -> seconds``, when given together
    with an advanceable clock (FakeClock), charges a deterministic virtual
    duration inside every dispatch span — the mechanism that gives tier-1
    traces nonzero, bitwise-reproducible durations with zero real timers.
    Metric counters whose names appear in :data:`STATS_COUNTER_KEYS` are
    incremented by the instrumented call sites in lockstep with the
    schedulers' python counters (the reconciliation contract)."""
    enabled = True

    def __init__(self, clock: Clock | None = None, *,
                 capacity: int = 65536, cost_model=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self.n_events = 0              # emitted ever (retained + dropped)
        self.metrics = MetricsRegistry()
        self.drift = DriftAggregator()
        self.cost_model = cost_model
        self._tracks: dict[str, int] = {}   # track name -> integer tid

    # ---------------------------------------------------------- plumbing --
    @property
    def events(self) -> list[dict]:
        return list(self._buf)

    @property
    def dropped(self) -> int:
        return self.n_events - len(self._buf)

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks) + 1
        return tid

    def _ts(self, at=None) -> int:
        t = self.clock.now() if at is None else float(at)
        return int(round(t * 1e6))     # Chrome trace ts are microseconds

    def _emit(self, ev: dict) -> None:
        self._buf.append(ev)
        self.n_events += 1

    # ------------------------------------------------------------ events --
    @contextmanager
    def span(self, name: str, *, track: str = "scheduler",
             cat: str = "span", args: dict | None = None):
        """A paired B/E duration event on ``track``."""
        tid = self._tid(track)
        self._emit({"name": name, "ph": "B", "ts": self._ts(), "pid": _PID,
                    "tid": tid, "cat": cat, "args": args or {}})
        try:
            yield
        finally:
            self._emit({"name": name, "ph": "E", "ts": self._ts(),
                        "pid": _PID, "tid": tid, "cat": cat, "args": {}})

    @contextmanager
    def dispatch(self, kind: str, *, track: str = "scheduler", tags=(),
                 predicted_us: float = 0.0, args: dict | None = None):
        """A dispatch span: B/E pair carrying the solver decisions that
        planned it. On exit the measured duration lands in the
        ``dispatch_us`` histogram (labeled by kind) and is attributed
        across ``tags`` — ``(site, M, strategy, t_us, count)`` tuples —
        into the drift aggregator, proportionally to predicted share."""
        tid = self._tid(track)
        a = dict(args or {})
        if tags:
            a["decisions"] = [
                {"site": s, "M": m, "strategy": st, "t_us": t, "count": c}
                for (s, m, st, t, c) in tags]
            a["predicted_us"] = predicted_us
        t0 = self._ts()
        self._emit({"name": kind, "ph": "B", "ts": t0, "pid": _PID,
                    "tid": tid, "cat": "dispatch", "args": a})
        try:
            yield
        finally:
            if self.cost_model is not None \
                    and hasattr(self.clock, "advance"):
                self.clock.advance(
                    max(float(self.cost_model(kind, predicted_us)), 0.0))
            t1 = self._ts()
            self._emit({"name": kind, "ph": "E", "ts": t1, "pid": _PID,
                        "tid": tid, "cat": "dispatch", "args": {}})
            dur = float(t1 - t0)
            self.metrics.count("dispatches", kind=kind)
            self.metrics.observe("dispatch_us", dur, kind=kind)
            total = sum(t * c for (_, _, _, t, c) in tags)
            if total > 0:
                for (s, m, st, t, c) in tags:
                    self.drift.record(
                        s, m, st, predicted_us=t * c,
                        observed_us=dur * (t * c) / total)

    def instant(self, name: str, *, track: str = "scheduler",
                cat: str = "event", args: dict | None = None,
                at=None) -> None:
        self._emit({"name": name, "ph": "i", "ts": self._ts(at),
                    "pid": _PID, "tid": self._tid(track), "cat": cat,
                    "s": "t", "args": args or {}})

    def request_event(self, phase: str, rid: int, *,
                      track: str = "requests", args: dict | None = None,
                      at=None) -> None:
        """One request-lifecycle event (enqueue/admit/resume/preempt/
        finish): an instant on the requests track plus a Chrome flow event
        (``s`` at enqueue, ``t`` mid-life, ``f`` at finish, id = rid) so
        Perfetto draws the per-request arrow across tracks."""
        ts = self._ts(at)
        tid = self._tid(track)
        a = {"rid": rid}
        if args:
            a.update(args)
        self._emit({"name": phase, "ph": "i", "ts": ts, "pid": _PID,
                    "tid": tid, "cat": "request", "s": "t", "args": a})
        ph = {"enqueue": "s", "finish": "f"}.get(phase, "t")
        flow = {"name": "req", "ph": ph, "ts": ts, "pid": _PID, "tid": tid,
                "cat": "request", "id": int(rid), "args": {}}
        if ph == "f":
            flow["bp"] = "e"
        self._emit(flow)

    # ----------------------------------------------------------- metrics --
    def count(self, name: str, n=1, **labels) -> None:
        self.metrics.count(name, n, **labels)

    def gauge(self, name: str, value, **labels) -> None:
        self.metrics.gauge(name, value, **labels)

    def counter_value(self, name: str, **labels):
        return self.metrics.value(name, **labels)

    # ------------------------------------------------------------ export --
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object: thread-name metadata per track
        (integer tids — string tids don't render reliably), then the
        retained events STABLE-sorted by timestamp. Emission order alone is
        not monotone: open-loop arrivals are stamped at their SCHEDULED
        time (the telemetry contract), which can precede events already
        emitted by the tick that released them. The stable sort restores
        file-order monotonicity (scripts/check_trace.py's invariant) while
        ties keep emission order, so B/E nesting is preserved."""
        meta = [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                 "args": {"name": track}}
                for track, tid in self._tracks.items()]
        return {
            "traceEvents": meta + sorted(self._buf,
                                         key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "total_events": self.n_events},
        }

    def save_chrome(self, path) -> Path:
        """Serialize :meth:`to_chrome` byte-deterministically (sorted keys,
        fixed separators): equal traces are equal FILES."""
        p = Path(path)
        p.write_text(json.dumps(self.to_chrome(), sort_keys=True,
                                separators=(",", ":")) + "\n")
        return p

    def to_prometheus(self, prefix: str = "repro_") -> str:
        return self.metrics.to_prometheus(prefix)

    def save_prometheus(self, path, prefix: str = "repro_") -> Path:
        p = Path(path)
        p.write_text(self.to_prometheus(prefix))
        return p


# ----------------------------------------------------------- reconciliation --

def counter_reconciliation(tracer, stats: dict) -> dict:
    """Compare a scheduler/ingress ``stats()`` snapshot against the
    tracer's mirrored counters/gauges. Returns ``{key: (stats_value,
    tracer_value)}`` for every mismatch — empty means the two ledgers agree
    exactly (the contract the fuzz cross-check arm asserts). Keys in
    ``stats`` that have no tracer mirror (ratios, names, totals) are
    ignored; mirrored keys missing from the tracer compare against 0, so a
    forgotten increment can't hide."""
    mismatches = {}
    for key in STATS_COUNTER_KEYS + STATS_GAUGE_KEYS:
        if key not in stats:
            continue
        sv, tv = stats[key], tracer.counter_value(key)
        if sv != tv:
            mismatches[key] = (sv, tv)
    return mismatches
