"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a
sub-window, read back from its Chrome trace.

``summarize`` reduces the trace's events to the seconds the device was
busy (the union of its kernels, copies and fills), the operations that took
the most device time, and the longest idle gaps between device operations,
each put down to the innermost host event under the gap's midpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")


def union_seconds(intervals) -> tuple[float, list]:
    """(total, merged) of [start, end) intervals in microseconds; the total
    in seconds."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, idle_share and the breakdown of a Chrome trace's
    ``traceEvents``."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS]
    if not dev:
        seen = Counter((e.get("ph"), e.get("cat")) for e in events)
        raise RuntimeError("the device trace holds no device operation: the "
                           f"profiler saw no kernel on the card ({len(events)}"
                           f" events: {seen.most_common(12)})")
    busy_s, merged = union_seconds((float(e["ts"]), float(e["ts"]) + float(
        e.get("dur", 0))) for e in dev)
    by_name: dict = defaultdict(float)
    for e in dev:
        by_name[e["name"][:120]] += float(e.get("dur", 0)) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(((s1 - e0) / 1e6, e0, s1) for (_, e0), (s1, _)
                   in zip(merged, merged[1:]))[::-1][:top]
    gaps = []
    for seconds, e0, s1 in spans:
        mid = (e0 + s1) / 2
        under = [e for e in host if float(e["ts"]) <= mid
                 < float(e["ts"]) + float(e.get("dur", 0))]
        label = (min(under, key=lambda e: float(e.get("dur", 0)))["name"][:80]
                 if under else "no traced host op")
        gaps.append([label, seconds])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "idle_share": max(0.0, 1.0 - busy_s / window_s),
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": gaps,
    }


class DeviceTrace:
    """``start()`` and ``stop()`` a profile of the card; ``summary`` after
    the stop. The Chrome trace goes through a file in ``TMPDIR`` that is
    removed once read."""

    def __init__(self):
        self.prof = None
        self.summary = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        window_s = time.monotonic() - self.t0
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = summarize(events, window_s)
