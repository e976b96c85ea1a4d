"""The harness on the CPU: files found by name, the contract's character
rules on BENCHMARK.json, the window arithmetic on known stamps, the closed
loop on a FakeClock, and no result without a card."""
import asyncio
import json
import shutil
import subprocess
import sys

import pytest

from benchkit import spec
from benchkit.loop import (ClosedLoopDriver, Served, Window, output_tok_s,
                           percentile, tokens_between, tpots_ms, ttfts_ms)
from benchkit.traffic import ClosedLoop, quantile
from smoke import BENCH, TRAFFIC, smoke_config

ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


# ----------------------------------------------------------- found by name --

def test_new_files_are_found_by_name(tmp_path):
    """A cell, a configuration, a mix and a metric that a later change adds
    as files and entries are found with no edit to the harness."""
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "metrics").mkdir()
    (tmp_path / "bench" / "configs" / "m-new.json").write_text(
        json.dumps({"hidden_size": 8}))
    (tmp_path / "bench" / "traffic" / "mix_new.json").write_text(
        json.dumps({"kind": "closed_loop", "clients": 2}))
    (tmp_path / "bench" / "metrics" / "lat.serve.json_ms.py").write_text(
        "def read(run):\n    return run * 2\n")
    bench = {
        "configs": [{"name": "m-new", "file": "bench/configs/m-new.json"}],
        "workloads": [{"name": "m-new.mix_new", "config": "m-new",
                       "traffic": "mix_new", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "lat.serve.json_ms", "unit": "ms",
                       "better": "lower", "source": "program_span",
                       "layer": "x", "moves": "setup_s",
                       "workloads": ["m-new.mix_new"]},
                      {"name": "elsewhere", "unit": "ms", "better": "lower",
                       "source": "program_span", "layer": "x",
                       "moves": "setup_s", "workloads": ["other"]}]}
    cell = spec.resolve("m-new.mix_new", bench, root=tmp_path)
    assert cell.config == {"hidden_size": 8}
    assert cell.traffic["clients"] == 2
    assert [m.name for m in cell.reported(False)] == ["setup_s"]
    assert [m.name for m in cell.reported(True)] == ["lat.serve.json_ms"]
    assert spec.reader("lat.serve.json_ms", tmp_path / "bench")(21) == 42


def test_every_named_file_exists():
    for w in BENCHMARK["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.traffic["kind"] == "closed_loop"
        assert spec.limits(w["name"])["logit_gap"]["limit"] is not None
        for m in cell.metrics:
            assert callable(spec.reader(m.name))


# ------------------------------------------------------- the contract's rules --

def _names():
    b = BENCHMARK
    yield from (c["name"] for c in b["configs"])
    for w in b["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in b["end_to_end"] + b["per_layer"])
    for c in b["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_only_the_allowed_characters(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", BENCHMARK["end_to_end"]
                         + BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "layer" in metric:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    else:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_each_cell_reports_what_its_layer_metrics_move():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one, and each per-layer metric it reports moves an
    end-to-end metric that the cell reports too."""
    for w in BENCHMARK["workloads"]:
        cell = spec.resolve(w["name"])
        e2e = {m.name for m in cell.metrics if m.layer is None}
        layer = {m.name for m in cell.metrics if m.layer is not None}
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in BENCHMARK["per_layer"]:
            if m["name"] in layer:
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_benchmark_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


# ------------------------------------------------------------ the traffic --

def test_each_block_draws_one_length_in_each_stratum():
    n = TRAFFIC["clients"]
    a, b = ClosedLoop(TRAFFIC, 1, 256), ClosedLoop(TRAFFIC, 2 ** 40 + 3, 256)
    for t in (a, b):
        for block in (1, 2, 7):
            for q in t._block(block):
                assert sorted((q * n).astype(int)) == list(range(n))
    block = range(n, 2 * n)                # past the residual first requests
    assert sorted(a.lengths(i) for i in block) != \
        sorted(b.lengths(i) for i in block)
    again = ClosedLoop(TRAFFIC, 1, 256)
    assert a.lengths(9) == again.lengths(9)
    assert (a.prompt(9) == again.prompt(9)).all()


def test_a_schedule_seed_fixes_the_lengths_not_the_tokens():
    mix = dict(TRAFFIC, schedule_seed=7)
    a, b = ClosedLoop(mix, 1, 256), ClosedLoop(mix, 2 ** 40 + 3, 256)
    n = 3 * TRAFFIC["clients"]               # the residual first requests too
    assert [a.lengths(i) for i in range(n)] == [b.lengths(i) for i in range(n)]
    assert [a.lengths(i) for i in range(n)] != \
        [ClosedLoop(TRAFFIC, 1, 256).lengths(i) for i in range(n)]
    assert (a.prompt(9) != b.prompt(9)).any()


def test_drawn_lengths_follow_their_laws():
    import math
    mix = dict(TRAFFIC, clients=32,
               prompt={"law": "log_uniform", "min": 1024, "max": 4096},
               answer={"law": "uniform", "min": 32, "max": 128})
    t = ClosedLoop(mix, 2 ** 31 + 7, 256)
    drawn = [t.lengths(i) for i in range(32, 32 * 65)]
    prompts, answers = [p for p, _ in drawn], [a for _, a in drawn]
    assert min(prompts) >= 1024 and max(prompts) <= 4096
    assert min(answers) >= 32 and max(answers) <= 128
    assert sum(prompts) / len(prompts) == pytest.approx(
        3072 / math.log(4), rel=0.01)
    assert sum(answers) / len(answers) == pytest.approx(80, rel=0.01)
    assert len(set(prompts)) > 1000          # not a fixed set of quantiles


def test_length_laws():
    law = {"law": "uniform", "min": 32, "max": 128}
    assert [quantile(law, q) for q in (0.0, 0.5, 0.999)] == [32, 80, 128]
    law = {"law": "log_uniform", "min": 1024, "max": 4096}
    assert [quantile(law, q) for q in (0.0, 0.5, 1.0)] == [1024, 2048, 4096]


# ---------------------------------------------------- the window arithmetic --

def _served(i, first, step, n, enqueue, finish=True):
    stamps = [first + k * step for k in range(n)]
    return Served(i, i, 10, n, enqueue, enqueue, stamps, list(range(n)),
                  stamps[-1] if finish else None)


def test_window_arithmetic_on_known_stamps():
    w = Window(10.0, 20.0, [
        _served(0, 9.0, 1.0, 4, 8.5),          # first token before the open
        _served(1, 11.0, 0.5, 5, 10.8),        # ttft 200 ms, tpot 500 ms
        _served(2, 12.0, 2.0, 3, 11.0),        # ttft 1000 ms, tpot 2000 ms
        _served(3, 19.0, 1.0, 3, 18.9),        # finishes after the close
    ], {}, {})
    assert ttfts_ms(w) == pytest.approx([200.0, 1000.0, 100.0])
    assert tpots_ms(w) == pytest.approx([1000.0, 500.0, 2000.0])
    # 9, 10, 11, 12 of request 0: three inside; request 1: five; request 2:
    # three; request 3: 19 only
    assert tokens_between(w, w.open, w.close) == 3 + 5 + 3 + 1
    assert output_tok_s(w) == pytest.approx(1.2)
    assert percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert percentile([], 95) is None


def test_closed_loop_on_a_fake_clock():
    """The driver over the program's server on a FakeClock that advances
    10 ms a tick: every client always has one request in flight, the
    window opens once each has a first token, and a request sent after a
    finish gets its first token one tick later."""
    import torch
    from repro_torch.serving.ingress import AsyncServer
    from repro_torch.serving.scheduler import PagedBatcher
    from repro_torch.serving.telemetry import FakeClock
    from benchkit.system import program_config
    from benchkit.weights import make_weights
    c = smoke_config("internlm-1.8b")
    traffic = ClosedLoop(TRAFFIC, 5, c["vocab_size"])
    mb = traffic.max_blocks(32)
    batcher = PagedBatcher(program_config(c, smoke=True),
                           make_weights(c, 5, "cpu"), num_blocks=1 + 4 * mb,
                           max_blocks_per_seq=mb, decode_width=4,
                           sync="device", device="cpu")
    server = AsyncServer(batcher, clock=FakeClock(), step_time_s=0.01)
    with torch.no_grad():
        w = asyncio.run(ClosedLoopDriver(server, traffic, seconds=1.0).run())
    assert w.seconds == pytest.approx(1.0, abs=0.0101)
    firsts = [r.first for r in w.served[:4]]
    assert max(firsts) <= w.open
    for t in (w.open, (w.open + w.close) / 2, w.close - 1e-9):
        in_flight = [r for r in w.served if r.enqueue <= t
                     and (r.finish is None or r.finish > t)]
        assert len(in_flight) == 4
    later = [r for r in w.served[4:] if w.inside(r.first)]
    assert later and all(abs(r.first - r.enqueue - 0.01) < 1e-9
                         for r in later)
    assert ttfts_ms(w) == pytest.approx([10.0] * len(ttfts_ms(w)))
    assert all(len(r.tokens) == r.budget for r in w.served if r.finish)


# ------------------------------------------------------------ no fallback --

def _run(args, cwd):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_run_gives_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["--workload", "internlm-1.8b.prefill_heavy", "--seed",
              str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA card" in p.stderr


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "internlm-1.8b.prefill_heavy", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


# ------------------------------------------------------------- on the card --

@pytest.mark.card
def test_a_short_run_on_the_card(card):
    """One short run of the first cell: a result line, correct."""
    p = _run(["--workload", BENCHMARK["workloads"][0]["name"], "--seed",
              str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
