"""Fault tolerance for the training launcher.

Mechanisms (single-controller process here; the contracts mirror multi-host):
  * Heartbeat/straggler monitor — a watchdog thread tracks per-step wall
    time; a step exceeding ``straggler_factor x`` the trailing median marks a
    straggler event (on real pods: triggers re-slicing / hot-spare swap; here:
    recorded + surfaced, and the step is retried if it raises).
  * Crash recovery — ``run_resilient`` wraps the step loop: on exception it
    restores the latest checkpoint + data state and continues, up to
    ``max_restarts``. Deterministic data (stepped RNG) makes the retrace
    bit-reproducible.
  * Elastic restart (the reference's restore onto another mesh) waits for
    the port's meshes; ``restore`` here puts each leaf on the device of the
    state it replaces.

The reference's ``repro.training.fault_tolerance``; step durations come
from the injected telemetry clock (serving/telemetry.py), never the wall.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from statistics import median
from typing import Callable, Optional

from ..serving.telemetry import Clock, MonotonicClock


@dataclass
class StepMonitor:
    straggler_factor: float = 3.0
    window: int = 20
    times: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 5:
            med = median(self.times[-self.window:])
            if dt > self.straggler_factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                is_straggler = True
        self.times.append(dt)
        return is_straggler


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    restarts_used: int = 0


def run_resilient(n_steps: int, *, state, data, step_fn: Callable,
                  ckpt, save_every: int = 50,
                  monitor: Optional[StepMonitor] = None,
                  policy: Optional[RestartPolicy] = None,
                  fail_injector: Optional[Callable] = None,
                  log: Callable = print,
                  clock: Optional[Clock] = None):
    """Run the training loop with checkpoint/restart + straggler tracking.

    fail_injector(step) -> None | Exception — used by tests to simulate node
    failures at specific steps. ``clock`` feeds the straggler monitor's
    per-step durations (telemetry Clock protocol; MonotonicClock by
    default, FakeClock in tests so tier-1 never reads wall time).
    """
    monitor = monitor or StepMonitor()
    policy = policy or RestartPolicy()
    clock = clock if clock is not None else MonotonicClock()
    step = int(state["step"])
    metrics = {}
    while step < n_steps:
        try:
            t0 = clock.now()
            if fail_injector is not None:
                fail_injector(step)
            batch = data.next()
            state, metrics = step_fn(state, batch)
            dt = clock.now() - t0
            step += 1
            if monitor.record(step, dt):
                log(f"[ft] straggler at step {step}: {dt:.3f}s")
            if step % save_every == 0:
                ckpt.save(step, {"state": state, "data": data.state()})
        except Exception as e:  # noqa: BLE001 — the recovery path IS the feature
            policy.restarts_used += 1
            if policy.restarts_used > policy.max_restarts:
                raise
            ckpt.wait()          # let an in-flight async save commit first
            last = ckpt.latest_step()
            log(f"[ft] step {step} failed ({type(e).__name__}: {e}); "
                f"restart {policy.restarts_used}/{policy.max_restarts} "
                f"from checkpoint {last}")
            if last is None:
                raise
            restored = ckpt.restore(last, {"state": state,
                                           "data": data.state()})
            state = restored["state"]
            data.restore(restored["data"])
            step = int(state["step"])
    ckpt.save(n_steps, {"state": state, "data": data.state()},
              blocking=True)
    return state, metrics, monitor
