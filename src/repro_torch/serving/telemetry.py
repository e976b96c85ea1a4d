"""Injectable clocks (the reference's ``serving/telemetry.py`` clocks).

Library code that times anything reads a :class:`Clock` handed to it,
never the wall clock itself: ``MonotonicClock`` in production,
``FakeClock`` in tests, so test results never depend on how fast the
machine is. Only ``now()`` is ported: the reference's async ``sleep`` comes
with the async ingress, and its percentiles and request reports later.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Time source: ``now()`` in seconds."""

    def now(self) -> float: ...


class MonotonicClock:
    """Production clock: ``time.monotonic`` timestamps."""

    def now(self) -> float:
        return time.monotonic()  # repolint: disable=determinism -- this class IS the injectable production clock, as the reference's serving/telemetry.py


class FakeClock:
    """Deterministic test clock: time moves only when ``advance`` says so."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        self._t += dt
