"""The port's serving tracer (``repro_torch/serving/trace.py``) against the
reference's: the Prometheus text, the drift report and the flow events on
hand-built inputs; ``dispatch_prediction`` on the V5E plan; and traced
``PagedBatcher`` runs under ``FakeClock`` on the fp32 llama3 smoke model
(plain, mixed, spec and prefix arms, both syncs) whose Chrome trace and
Prometheus text are byte-identical to the reference's and across two port
reruns, whose counters reconcile with ``stats()``, and whose tokens equal
the untraced run's. With ``NULL_TRACER`` nothing is recorded, no
prediction is looked up and nothing fences; with a live tracer each
dispatch span (and a window's ``fused_window``) closes after its fence."""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.core.engine import dispatch_prediction as ref_dispatch_prediction
from repro.serving import trace as ref_trace
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.telemetry import FakeClock as RefFakeClock
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import engine, sync
from repro_torch.core.engine import build_hetero_ctx, dispatch_prediction
from repro_torch.serving import trace
from repro_torch.serving.scheduler import PagedBatcher, Request
from repro_torch.serving.telemetry import FakeClock
from repro_torch.serving.trace import (NULL_TRACER, STATS_COUNTER_KEYS,
                                       STATS_GAUGE_KEYS, DriftAggregator,
                                       MetricsRegistry, Tracer,
                                       counter_reconciliation)

_ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "check_trace", _ROOT / "scripts" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)

FP32 = dict(param_dtype="float32", compute_dtype="float32")
POOL = dict(num_blocks=25, block_size=16, max_blocks_per_seq=6,
            decode_width=3, buckets=(32, 64))
# the arms whose traces are held to the reference's
ARMS = {
    "host": dict(sync="host", engine_mode="hetero-tensor"),
    "device": dict(sync="device", window=2, engine_mode="hetero-tensor"),
    "mixed-host": dict(sync="host", mixed_batch=True,
                       engine_mode="hetero-tensor"),
    "mixed-device": dict(sync="device", window=2, mixed_batch=True,
                         engine_mode="hetero-tensor"),
    "spec-host": dict(sync="host", spec=2, engine_mode="hetero-tensor"),
    "spec-device": dict(sync="device", spec=2),
    "prefix-device": dict(sync="device", window=2, prefix_cache=True),
}
DECODE_KINDS = ("decode_step", "decode_window", "mixed_step",
                "mixed_window", "paged_verify")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_params(smoke_model):
    cfg = get_smoke_config("llama3-8b").with_(**FP32)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


def _cost_model(kind, predicted_us):
    # deterministic virtual cost: the solver's prediction, floored at 10us
    return max(predicted_us, 10.0) * 1e-6


def _requests(make, vocab):
    rng = np.random.default_rng(0)
    return [make(rid=i, prompt=rng.integers(0, vocab, 12 + 7 * i
                                            ).astype(np.int32),
                 max_new_tokens=6) for i in range(3)]


def _port_run(port_params, traced=True, **kw):
    """One PagedBatcher run (three requests, six new tokens each), under a
    traced FakeClock unless ``traced`` is False: (batcher, tracer,
    outputs)."""
    cfg, params = port_params
    tracer = Tracer(FakeClock(), cost_model=_cost_model) if traced else None
    pb = PagedBatcher(cfg, params, cache_dtype=torch.float32, device="cpu",
                      tracer=tracer, **POOL, **kw)
    reqs = _requests(Request, cfg.vocab_size)
    for r in reqs:
        pb.submit(r)
    while pb.busy:
        pb.step()
    pb.kv.assert_drained()
    return pb, tracer, [r.output for r in reqs]


def _ref_run(smoke_model, **kw):
    cfg, _, params = smoke_model
    tracer = ref_trace.Tracer(RefFakeClock(), cost_model=_cost_model)
    pb = RefPagedBatcher(cfg, params, cache_dtype=jnp.float32, tracer=tracer,
                         **POOL, **kw)
    reqs = _requests(RefRequest, cfg.vocab_size)
    for r in reqs:
        pb.submit(r)
    while pb.busy:
        pb.step()
    return pb, tracer, [r.output for r in reqs]


def _dispatch_counts(tracer) -> dict:
    by_kind: dict = {}
    for e in tracer.events:
        if e["ph"] == "B" and e.get("cat") == "dispatch":
            by_kind[e["name"]] = by_kind.get(e["name"], 0) + 1
    return by_kind


# ------------------------------------------------------- traced serving --

@pytest.mark.parametrize("arm", ["host", "device", "mixed-host",
                                 "spec-device"])
def test_traced_run_equals_reference(smoke_model, port_params, tmp_path,
                                     arm):
    """Tokens, the Chrome trace and the Prometheus text equal the
    reference's byte for byte (the same dispatch structure: the port's
    captured draft round and fused mixed chunk trace as the reference's
    scan and mixed dispatch do), a rerun writes the same files, the
    counters reconcile with stats() and the dispatch B-events count as
    stats() does. (The mixed window, host-synced spec and prefix arms are
    held to the reference's traces through the ingress:
    tests/test_torch_ingress.py.)"""
    ref_pb, ref_tracer, ref_out = _ref_run(smoke_model, **ARMS[arm])
    files = []
    for i in range(2):
        pb, tracer, out = _port_run(port_params, **ARMS[arm])
        assert out == ref_out
        files.append((tracer.save_chrome(tmp_path / f"trace{i}.json"),
                      tracer.save_prometheus(tmp_path / f"metrics{i}.prom")))
    (t0, m0), (t1, m1) = files
    assert t0.read_bytes() == t1.read_bytes()
    assert m0.read_bytes() == m1.read_bytes()
    ref_t = ref_tracer.save_chrome(tmp_path / "ref.json")
    assert t0.read_bytes() == ref_t.read_bytes()
    assert m0.read_text() == ref_tracer.to_prometheus()
    assert check_trace.validate(json.loads(t0.read_text())) == []

    s = pb.stats()
    assert counter_reconciliation(tracer, s) == {}
    assert {k: v for k, v in s.items()} == \
        {k: v for k, v in ref_pb.stats().items() if k != "tp"}
    by_kind = _dispatch_counts(tracer)
    assert by_kind.get("prefill_chunk", 0) == s["prefill_dispatches"]
    assert sum(by_kind.get(k, 0) for k in DECODE_KINDS) \
        == s["decode_dispatches"]
    assert sum(by_kind.get(k, 0) for k in ("mixed_step", "mixed_window")) \
        == s["fused_steps"]
    if "spec" in arm:
        assert by_kind["paged_verify"] == s["verify_dispatches"]
        assert by_kind["spec_draft"] > 0
    skewed = dict(s, decode_steps=s["decode_steps"] + 1)
    assert set(counter_reconciliation(tracer, skewed)) == {"decode_steps"}
    assert tracer.dropped == 0 and tracer.n_events > 0


def test_traced_tokens_equal_untraced(port_params):
    """Tracing only observes: the untraced batcher holds NULL_TRACER and
    gives the traced run's tokens and stats()."""
    pb, _, traced = _port_run(port_params, **ARMS["mixed-device"])
    plain, none, out = _port_run(port_params, traced=False,
                                 **ARMS["mixed-device"])
    assert none is None and plain.tracer is NULL_TRACER
    assert plain.kv.tracer is NULL_TRACER
    assert out == traced and plain.stats() == pb.stats()


def test_null_tracer_fences_nothing_and_predicts_nothing(port_params,
                                                         monkeypatch):
    """With NULL_TRACER no dispatch prediction is looked up and no fence
    runs; with a live tracer every dispatch span and every window's
    fused_window span closes right after a fence."""
    log = []
    monkeypatch.setattr(sync, "fence", lambda *v: log.append("fence"))

    def no_lookup(*a, **k):
        raise AssertionError("prediction looked up with tracing off")

    monkeypatch.setattr(engine, "dispatch_prediction", no_lookup)
    for arm in ("device", "spec-host"):
        _port_run(port_params, traced=False, **ARMS[arm])
    assert log == []
    monkeypatch.setattr(engine, "dispatch_prediction", dispatch_prediction)
    for arm in ("device", "mixed-host", "spec-host"):
        log.clear()
        pb, tracer, _ = _port_run(port_params, **ARMS[arm])
        emit = tracer._emit
        monkeypatch.setattr(tracer, "_emit",
                            lambda ev: (log.append((ev["ph"], ev["name"])),
                                        emit(ev)))
        log.clear()
        for r in _requests(Request, pb.cfg.vocab_size):
            r.rid += 10
            pb.submit(r)
        while pb.busy:
            pb.step()
        ends = [i for i, e in enumerate(log) if e[0] == "E"]
        assert ends
        for i in ends:
            assert log[i - 1] == "fence", (arm, log[i - 1: i + 1])
        # the fused window's span sits inside its dispatch's span
        if arm == "device":
            names = [e for e in log if e != "fence"]
            for i, e in enumerate(names):
                if e == ("B", "fused_window"):
                    assert names[i - 1] == ("B", "decode_window")
                    assert names[i + 1: i + 3] == [("E", "fused_window"),
                                                   ("E", "decode_window")]


def test_drift_rows_cover_every_plan_site(port_params):
    pb, tracer, _ = _port_run(port_params, **ARMS["device"])
    rows = tracer.drift.report()["rows"]
    assert {r["site"] for r in rows} == {s for (s, _) in pb._plan.decisions}
    for r in rows:
        assert r["n"] > 0 and r["predicted_us"] > 0
        assert r["residual_us"] == pytest.approx(
            r["observed_us"] - r["predicted_us"])
    assert "decision rows" in tracer.drift.format_table()


def test_stats_schema(port_params):
    """Every mirrored key is an int in the port's stats() (``tp`` aside,
    the reference's keys: tensor parallelism is not ported)."""
    pb, _, _ = _port_run(port_params, **ARMS["spec-host"])
    s = pb.stats()
    assert "tp" not in s and s["preemptions"] == 0
    for k, v in s.items():
        assert isinstance(v, (int, float, str)), (k, type(v))
        if k in STATS_COUNTER_KEYS or k in STATS_GAUGE_KEYS:
            assert isinstance(v, int), (k, type(v))
    assert trace.STATS_COUNTER_KEYS == ref_trace.STATS_COUNTER_KEYS
    assert trace.STATS_GAUGE_KEYS == ref_trace.STATS_GAUGE_KEYS


# ----------------------------------------------------- dispatch prediction --

@pytest.mark.parametrize("sel", [
    dict(m=1), dict(m=3, steps=4), dict(m=32), dict(m=57), dict(m=300),
    dict(mixed=(32, 3)), dict(mixed=(17, 3)), dict(verify=(2, 3)),
    dict(verify=(5, 4)), dict()])
def test_dispatch_prediction_equals_reference(smoke_model, port_params,
                                              sel):
    ref_cfg = smoke_model[0]
    cfg = port_params[0]
    kw = dict(mixed_pairs=((32, 3), (64, 3)), verify_ks=((2, 3),),
              extra_ms=(16,))
    ref_plan = ref_build_hetero_ctx(ref_cfg, "hetero-tensor", **kw).plan
    plan = build_hetero_ctx(cfg, "hetero-tensor", **kw).plan
    tags, total = dispatch_prediction(plan, cfg, **sel)
    assert (tags, total) == ref_dispatch_prediction(ref_plan, ref_cfg, **sel)
    assert {t[0] for t in tags} == {s for (s, _) in plan.decisions}
    assert dispatch_prediction(None, cfg, **sel) == ((), 0.0)


# ------------------------------------------------------------ unit pieces --

def _registry_ops(m):
    m.count("decode_steps", 3)
    m.count("dispatches", kind="decode_step")
    m.count("dispatches", 2, kind="prefill_chunk")
    m.gauge("peak_active", 4)
    m.gauge("ratio", 0.25)
    for v in (50.0, 500.0, 5000.0, 1e9):
        m.observe("dispatch_us", v, kind="decode_step")


def test_prometheus_equals_reference():
    got, want = MetricsRegistry(buckets=(100.0, 1000.0)), \
        ref_trace.MetricsRegistry(buckets=(100.0, 1000.0))
    _registry_ops(got)
    _registry_ops(want)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_prometheus().splitlines()[:3] == [
        "# HELP repro_decode_steps_total decode_steps (counter)",
        "# TYPE repro_decode_steps_total counter",
        "repro_decode_steps_total 3"]
    assert got.value("never_touched") == 0 and got.value("peak_active") == 4
    full = MetricsRegistry(), ref_trace.MetricsRegistry()
    for m in full:
        _registry_ops(m)
    assert full[0].to_prometheus("x_") == full[1].to_prometheus("x_")


def test_drift_report_equals_reference():
    rng = np.random.default_rng(4)
    got, want = DriftAggregator(), ref_trace.DriftAggregator()
    for _ in range(40):
        site = ["wq", "wo", "head"][int(rng.integers(3))]
        m = int(rng.choice([1, 32, 64]))
        strat = ["pad", "split", "xla_only"][int(rng.integers(3))]
        p, o = float(rng.uniform(1, 50)), float(rng.uniform(1, 50))
        for d in (got, want):
            d.record(site, m, strat, predicted_us=p, observed_us=o)
    assert got.report() == want.report()
    assert got.report()["contradictions"]
    assert got.format_table() == want.format_table()
    assert DriftAggregator().format_table() == \
        ref_trace.DriftAggregator().format_table()


def _flows(tr):
    for rid in (0, 1):
        tr.request_event("enqueue", rid)
        tr.request_event("admit", rid, track="scheduler")
    tr.request_event("preempt", 1, track="scheduler")
    tr.request_event("resume", 1, track="scheduler")
    tr.instant("lane_preempt", args={"lane": 0})
    with tr.span("tick", track="ingress"):
        with tr.dispatch("decode_step", tags=(("wq", 1, "pad", 3.0, 2),),
                         predicted_us=6.0):
            pass
    for rid in (0, 1):
        tr.request_event("finish", rid)
    return tr


def test_flow_events_equal_reference():
    got = _flows(Tracer(FakeClock(), cost_model=lambda k, p: 0.002))
    want = _flows(ref_trace.Tracer(RefFakeClock(),
                                   cost_model=lambda k, p: 0.002))
    assert got.to_chrome() == want.to_chrome()
    assert check_trace.validate(got.to_chrome()) == []
    assert got.drift.report() == want.drift.report()
    dangling = Tracer(FakeClock())
    dangling.request_event("enqueue", 7)
    assert any("never finished" in e
               for e in check_trace.validate(dangling.to_chrome()))


def test_null_tracer_and_ring_buffer():
    with NULL_TRACER.span("x"):
        with NULL_TRACER.dispatch("y", tags=(("wq", 1, "pad", 3.0, 1),)):
            NULL_TRACER.instant("z")
            NULL_TRACER.request_event("enqueue", 0)
            NULL_TRACER.count("decode_steps")
            NULL_TRACER.gauge("peak_active", 4)
    assert NULL_TRACER.enabled is False
    tr = Tracer(FakeClock(), capacity=8)
    for i in range(20):
        tr.instant(f"e{i}")
    assert len(tr.events) == 8 and tr.dropped == 12
    assert tr.to_chrome()["otherData"] == {"dropped_events": 12,
                                           "total_events": 20}
    with pytest.raises(ValueError):
        Tracer(FakeClock(), capacity=0)
