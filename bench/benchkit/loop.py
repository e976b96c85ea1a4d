"""The closed loop over the program's ``AsyncServer``, its measured window,
and the window's arithmetic.

Each client submits a request, streams it to its last token and submits
the next; all clients draw from one numbered sequence
(``traffic.ClosedLoop``). The window opens once every client has had a
first token, and closes ``seconds`` later on the server's clock, between
two of its ticks; the server is then stopped, and the requests still in
flight are left unfinished. Every time comes from the server's own
``Telemetry`` stamps (first token, each token, finish, on its clock), so
the same arithmetic holds on a ``FakeClock``.
"""
from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass, field


@dataclass
class Served:
    """One request as the window saw it (times in the server's clock)."""
    index: int                 # its number in the traffic's sequence
    rid: int
    prompt_len: int
    budget: int
    enqueue: float
    admit: float | None = None
    stamps: list = field(default_factory=list)   # one per streamed token
    tokens: list = field(default_factory=list)
    finish: float | None = None

    @property
    def first(self) -> float | None:
        return self.stamps[0] if self.stamps else None


@dataclass
class Window:
    open: float
    close: float
    served: list               # every request sent, in sending order
    stats_open: dict
    stats_close: dict

    @property
    def seconds(self) -> float:
        return self.close - self.open

    def inside(self, t) -> bool:
        return t is not None and self.open <= t < self.close


class ClosedLoopDriver:
    """Drive ``server`` (an ``AsyncServer``) with ``traffic``'s clients for
    a window of ``seconds``. ``after`` = (seconds, begin, end): once the
    window has closed, ``begin()``, the loop goes on for that many seconds
    more from when ``begin`` returned (to the end of a tick), then
    ``end()``: a device trace of the steady loop that leaves the window's
    own numbers untouched."""

    def __init__(self, server, traffic, *, seconds: float, after=None):
        self.server = server
        self.traffic = traffic
        self.clock = server.clock
        self.seconds = float(seconds)
        self.after = after
        self.sent: dict[int, Served] = {}
        self.handles: dict[int, object] = {}
        self.firsts: list = []
        self.next_index = 0
        self.stopping = False

    async def _client(self):
        first = True
        while not self.stopping:
            i = self.next_index
            self.next_index += 1
            prompt, budget = self.traffic.request(i)
            h = self.server.submit(prompt, budget)
            self.sent[h.rid] = Served(i, h.rid, len(prompt), budget,
                                      self.clock.now())
            self.handles[h.rid] = h
            if first:
                self.firsts.append(h)
                first = False
            async for _ in h:
                pass

    async def _until(self, cond, server_task):
        while not cond():
            if server_task.done():
                server_task.result()          # raises what stopped it
                raise RuntimeError("the server stopped before the window "
                                   "closed")
            await asyncio.sleep(0)

    async def run(self) -> Window:
        clients = [asyncio.create_task(self._client())
                   for _ in range(self.traffic.clients)]
        await asyncio.sleep(0)                # every client sends
        server_task = asyncio.create_task(self.server.run())
        try:
            await self._until(
                lambda: len(self.firsts) == self.traffic.clients
                and all(h.tokens for h in self.firsts), server_task)
            t_open = self.clock.now()
            stats_open = self.server.stats()
            close = t_open + self.seconds
            await self._until(lambda: self.clock.now() >= close, server_task)
            t_close = self.clock.now()
            stats_close = self.server.stats()
            if self.after is not None:
                extra, begin, end = self.after
                begin()                       # may take seconds itself
                t_begun = self.clock.now()
                await self._until(
                    lambda: self.clock.now() >= t_begun + extra, server_task)
                end()
        finally:
            self.stopping = True
            server_task.cancel()
            for c in clients:
                c.cancel()
            await asyncio.gather(server_task, *clients,
                                 return_exceptions=True)
        return Window(t_open, t_close, self._records(), stats_open,
                      stats_close)

    def _records(self) -> list:
        traces = self.server.telemetry.traces
        out = []
        for rid, rec in self.sent.items():
            tr = traces[rid]
            rec.enqueue = tr.enqueue_t
            rec.admit = tr.admit_t
            rec.stamps = list(tr.token_ts)
            rec.finish = tr.finish_t
            rec.tokens = list(self.handles[rid].tokens)
            out.append(rec)
        return out


# ---------------------------------------------------------- the arithmetic --

def percentile(values, q: float) -> float | None:
    """Linear interpolation between closest ranks (numpy's default): the
    q-th percentile sits at rank ``(n - 1) q / 100`` of the sorted values.
    None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts_ms(w: Window) -> list:
    """First token minus send, of every request whose first token came in
    the window."""
    return [(r.first - r.enqueue) * 1e3 for r in w.served
            if w.inside(r.first)]


def tpots_ms(w: Window) -> list:
    """(last token - first token) / (tokens - 1), of every request that
    finished in the window with two tokens or more."""
    return [(r.stamps[-1] - r.first) / (len(r.stamps) - 1) * 1e3
            for r in w.served if w.inside(r.finish) and len(r.stamps) > 1]


def tokens_between(w: Window, a: float, b: float) -> int:
    return sum(1 for r in w.served for t in r.stamps if a <= t < b)


def output_tok_s(w: Window) -> float:
    """Tokens streamed in the window over the window's seconds."""
    return tokens_between(w, w.open, w.close) / w.seconds


def attempted_failed(w: Window) -> tuple[int, int]:
    """Requests sent before the close, and of those the ones that finished
    with fewer tokens than their budget asked for."""
    sent = [r for r in w.served if r.enqueue < w.close]
    failed = [r for r in sent if r.finish is not None
              and len(r.tokens) != r.budget]
    return len(sent), len(failed)
