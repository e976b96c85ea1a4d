"""One run of one cell: set-up, the measured window, the metrics and the
check, as ``run.py`` prints them.

Set-up, in order: the kernels built or loaded (``build/kernels/`` of the
checkout), the weights made on the device from the seed, the server built,
every prefill chunk length of this seed's traffic and the decode window
captured by serving warm-up prompts through the server, then the closed
loop filled until every client has had a first token. ``setup_s`` runs from
the process's start to that moment, where the window opens.

A traced run (``trace=True``) turns the program's tracer on (each dispatch
span closes after a fence on the card), and once the window has closed
profiles the card for ``PROFILE_S`` more seconds of the same loop; its
metrics are the per-layer ones.
"""
from __future__ import annotations

import asyncio
import gc
import sys

from work.counts import Shape, peaks

from . import check, spec
from .devtrace import DeviceTrace
from .loop import ClosedLoopDriver, attempted_failed
from .record import RunRecord, pair_spans
from .system import SERVING, System
from .traffic import ClosedLoop
from .weights import make_weights

PROFILE_S = 3.0
WARMUP_REQUESTS = 4096      # chunk lengths are read off this many requests


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", control: bool = False,
             smoke: bool = False, kind: str | None = None) -> dict:
    """The result of one run (the dict ``run.py`` prints, ``check`` last).
    ``smoke``: the program's reduced model of the configuration's family on
    ``device`` (CPU tests); ``kind``: the card's name for the peaks table,
    by default the device's."""
    import torch
    seed = int(seed) % (1 << 63)          # numpy's seed sequences take no sign
    config = cell.config
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels.build import build
        build()
        kind = kind or torch.cuda.get_device_name(0)
    traffic = ClosedLoop(cell.traffic, seed, config["vocab_size"])
    weights = make_weights(config, seed, device)
    system = System(config, weights, traffic, device=device, traced=trace,
                    smoke=smoke)
    system.warm_up(traffic.warmup_prompts(WARMUP_REQUESTS, system.chunks))
    devtrace = DeviceTrace() if trace and on_card else None
    driver = ClosedLoopDriver(
        system.server, traffic, seconds=seconds,
        after=(PROFILE_S, devtrace.start, devtrace.stop) if devtrace else None)
    window = asyncio.run(driver.run())
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    record = RunRecord(
        cell=cell.name, config=config, shape=Shape.from_config(config),
        peaks=peaks(kind) if kind else {}, window=window,
        setup_s=window.open - t0, lanes=traffic.clients,
        window_steps=SERVING["window"],
        span_window=(window.open, window.close),
        spans=pair_spans(system.events()),
        device=devtrace.summary if devtrace else None)
    metrics = {}
    for m in cell.reported(trace):
        value = spec.reader(m.name)(record)
        if value is None:                 # left out of the line, said why
            print(f"{m.name}: nothing to read in this run", file=sys.stderr)
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    attempted, failed = attempted_failed(window)

    # the program's state goes before the reference runs
    del system, driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    picked = check.choose(window, seed)
    got = check.compare(config, weights, traffic, picked, device=device,
                        control=control)
    limit = spec.limits(cell.name)["logit_gap"]["limit"]

    def judged(gap) -> bool:
        return (bool(picked) and failed == 0 and limit is not None
                and gap <= limit)

    correct = judged(got["logit_gap"])
    if not picked:
        got["logit_gap"] = None         # no finished request to compare

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": kind or "cpu", "count": cell.chips,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if devtrace:
        s = devtrace.summary
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    checked = {"logit_gap": {"value": got["logit_gap"], "limit": limit},
               "failed": {"value": failed, "limit": 0}}
    if control:                # the float8 control judged by the same rule
        result["control_correct"] = judged(got["control_gap"])
        result["served_tokens"] = got["served_tokens"]
        checked["control_gap"] = {"value": got["control_gap"],
                                  "limit": limit}
    result["check"] = checked
    return result
