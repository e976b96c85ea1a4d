"""What a metric's reader reads: one run's window, spans, counters and
device trace, and the counts of ``work/``.

Spans come from the program's tracer (``serving/trace.py``'s Chrome-style
B/E events, microseconds on the server's clock), paired here, and read over
``span_window``, the measured window; a traced run's device trace comes
after it, so the profiler's own cost stays out of them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from work.counts import Shape

from .loop import Window


@dataclass(frozen=True)
class Span:
    name: str
    cat: str
    start: float          # seconds, the server's clock
    end: float
    args: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


def pair_spans(events) -> list:
    """Closed spans of a tracer's B/E events, in order of their start."""
    open_: dict = {}
    out = []
    for ev in events:
        ph = ev.get("ph")
        key = (ev.get("tid"), ev.get("name"))
        if ph == "B":
            open_.setdefault(key, []).append(ev)
        elif ph == "E" and open_.get(key):
            b = open_[key].pop()
            out.append(Span(b["name"], b.get("cat", ""), b["ts"] / 1e6,
                            ev["ts"] / 1e6, b.get("args", {})))
    return sorted(out, key=lambda s: s.start)


@dataclass
class RunRecord:
    cell: str
    config: dict
    shape: Shape
    peaks: dict
    window: Window
    setup_s: float
    lanes: int
    window_steps: int
    span_window: tuple
    spans: list = field(default_factory=list)
    device: dict | None = None

    def spans_named(self, name: str) -> list:
        a, b = self.span_window
        return [s for s in self.spans
                if s.name == name and s.start >= a and s.end <= b]

    def served_by_rid(self) -> dict:
        return {r.rid: r for r in self.window.served}

    def decode_tokens(self, a: float, b: float):
        """(request, j) of every decoded token (j >= 1: not the one the
        prefill gave) streamed in [a, b)."""
        for r in self.window.served:
            for j, t in enumerate(r.stamps):
                if j and a <= t < b:
                    yield r, j

    def flops_between(self, a: float, b: float) -> int:
        """The model FLOPs of the work streamed in [a, b): the whole prompt
        of every request whose first token came then, and the decode step
        of every other token streamed then, each at its true position."""
        sh = self.shape
        total = sum(sh.chunk_flops(0, r.prompt_len) for r in self.window.served
                    if r.first is not None and a <= r.first < b)
        total += sum(sh.token_flops(r.prompt_len + j - 1, logits=True)
                     for r, j in self.decode_tokens(a, b))
        return total
