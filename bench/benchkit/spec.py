"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
``BENCH / configs``, ``BENCH / traffic``, ``BENCH / metrics`` and
``BENCH / limits`` hold one file each for a configuration (its ``file``), a
mix (``<traffic>.json``), a metric (``<name>.py``, whose ``read(run)``
returns the number or None) and a cell's correctness limits
(``<cell>.json``). Nothing here changes when a cell, a mix or a metric is
added."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    layer: str | None     # None for an end-to-end metric


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic mix's parameters
    metrics: tuple        # Metric of this cell (e2e, then per-layer)

    def reported(self, trace: bool) -> tuple:
        """The metrics a run reports: end-to-end ones untraced, per-layer
        ones traced."""
        return tuple(m for m in self.metrics if (m.layer is not None) == trace)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(cell: str, bench: dict | None = None,
            root: Path = ROOT) -> Cell:
    """The cell named ``cell`` with its configuration, traffic and metrics
    read from their files. KeyError for a name the benchmark lacks."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{work['traffic']}.json").read_text())
    metrics = [Metric(m["name"], m["unit"], None)
               for m in bench["end_to_end"] if _applies(m, cell)]
    metrics += [Metric(m["name"], m["unit"], m["layer"])
                for m in bench["per_layer"] if _applies(m, cell)]
    return Cell(cell, work["chips"], config, traffic, tuple(metrics))


def reader(metric: str, bench_dir: Path = BENCH):
    """``read(run)`` of ``metrics/<metric>.py``, loaded by path (a metric's
    name may hold dots)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(cell: str, bench_dir: Path = BENCH) -> dict:
    """``{number: {"limit": ...}}`` of ``limits/<cell>.json``: what the
    correctness check holds each compared number to."""
    return json.loads((bench_dir / "limits" / f"{cell}.json").read_text())
