"""The port's request telemetry (``repro_torch/serving/telemetry.py``)
against the reference's: ``percentile`` / ``summarize`` on seeded samples,
``Telemetry.report`` on the same seeded event sequences under ``FakeClock``
(equal dicts, SLO or not, finished or not), the clocks' async ``sleep``
(``FakeClock`` advances and yields, never waits), and the event contract's
errors. No model runs here."""
import asyncio

import numpy as np
import pytest
import torch

from repro.serving import telemetry as ref
from repro_torch.serving import telemetry as port


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- percentiles --

@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
@pytest.mark.parametrize("q", [0.0, 37.5, 50.0, 95.0, 99.0, 100.0])
def test_percentile_equals_reference(n, q):
    xs = np.random.default_rng(n).exponential(3.0, n).tolist()
    assert port.percentile(xs, q) == ref.percentile(xs, q)
    assert port.summarize(xs) == ref.summarize(xs)


def test_percentile_exact_and_refuses_bad_q():
    xs = list(range(100))
    assert port.percentile(xs, 50) == pytest.approx(49.5)
    assert port.percentile(xs, 95) == pytest.approx(94.05)
    assert port.percentile([7.25], 99) == 7.25
    assert port.percentile([], 50) is None
    for q in (-1, 101):
        with pytest.raises(ValueError):
            port.percentile([1.0], q)


# ------------------------------------------------------------------ reports --

def _events(seed: int, n_req: int = 6, finish_all: bool = True):
    """A seeded lifecycle event sequence: (method, rid, at) triples, with
    re-admits after preemptions and, unless ``finish_all``, a request that
    never finishes."""
    rng = np.random.default_rng(seed)
    evs = []
    for rid in range(n_req):
        t = float(rng.uniform(0, 2))
        evs.append(("on_enqueue", rid, t))
        t += float(rng.exponential(0.3))
        evs.append(("on_admit", rid, t))
        for _ in range(int(rng.integers(1, 6))):
            t += float(rng.exponential(0.05))
            evs.append(("on_token", rid, t))
            if rng.random() < 0.2:
                evs.append(("on_preempt", rid, t))
                t += float(rng.exponential(0.1))
                evs.append(("on_admit", rid, t))
        if finish_all or rid != n_req - 1:
            evs.append(("on_finish", rid, t))
    return evs


def _replay(mod, evs):
    tel = mod.Telemetry(mod.FakeClock())
    for method, rid, at in evs:
        getattr(tel, method)(rid, at=at)
    return tel


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slo_ms", [None, 300.0])
@pytest.mark.parametrize("finish_all", [True, False])
def test_report_equals_reference(seed, slo_ms, finish_all):
    evs = _events(seed, finish_all=finish_all)
    got = _replay(port, evs)
    want = _replay(ref, evs)
    assert got.report(slo_ms=slo_ms) == want.report(slo_ms=slo_ms)
    for rid, tr in got.traces.items():
        w = want.traces[rid]
        assert (tr.ttft, tr.tpot, tr.queue_delay, tr.preemptions,
                tr.readmits, tr.token_ts) == (w.ttft, w.tpot, w.queue_delay,
                                               w.preemptions, w.readmits,
                                               w.token_ts)
    # a pure function of the stamps: the same events, the same bits
    assert _replay(port, evs).report(slo_ms=slo_ms) == got.report(
        slo_ms=slo_ms)


def test_report_empty_equals_reference():
    assert port.Telemetry(port.FakeClock()).report() == \
        ref.Telemetry(ref.FakeClock()).report()


def test_stamps_default_to_the_injected_clock():
    clock = port.FakeClock()
    tel = port.Telemetry(clock)
    tel.on_enqueue(0)
    clock.advance(4.0)
    tel.on_admit(0)
    clock.advance(1.0)
    tel.on_token(0)
    tr = tel.traces[0]
    assert (tr.queue_delay, tr.ttft, tr.tpot) == (4.0, 5.0, None)
    assert not port.RequestTrace(rid=3).finished


def test_event_contract_violations_raise():
    tel = port.Telemetry(port.FakeClock())
    tel.on_enqueue(0, at=0.0)
    with pytest.raises(ValueError, match="already enqueued"):
        tel.on_enqueue(0, at=1.0)
    with pytest.raises(KeyError, match="never enqueued"):
        tel.on_token(99)
    tel.on_finish(0, at=1.0)
    with pytest.raises(ValueError, match="finished twice"):
        tel.on_finish(0, at=2.0)


# ------------------------------------------------------------------- clocks --

def test_fake_clock_sleep_advances_and_yields_without_waiting():
    clock = port.FakeClock(start=5.0)
    order = []

    async def sleeper():
        await clock.sleep(3.0)
        order.append(("sleeper", clock.now()))
        await clock.sleep(-1.0)          # clamped: never backwards
        order.append(("sleeper", clock.now()))

    async def other():
        order.append(("other", clock.now()))

    async def drive():
        await asyncio.gather(sleeper(), other())

    asyncio.run(drive())
    # the sleep advanced at once and yielded once, letting ``other`` run
    assert order == [("other", 8.0), ("sleeper", 8.0), ("sleeper", 8.0)]
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)


def test_monotonic_clock_is_a_clock_and_not_advanceable():
    clock = port.MonotonicClock()
    assert isinstance(clock, port.Clock)
    assert isinstance(port.FakeClock(), port.Clock)
    t0 = clock.now()
    asyncio.run(clock.sleep(0.0))
    asyncio.run(clock.sleep(-1.0))       # clamped to no wait
    assert clock.now() >= t0
    assert not hasattr(clock, "advance")   # the ingress gate relies on this
