"""The port's open-loop ingress (``repro_torch/serving/ingress.py``) and
``PagedBatcher.preempt`` against the reference's, on the fp32 llama3 smoke
model at the reference's ``buckets=(32, 64)`` with an fp32 pool, all under
``FakeClock`` (no real sleep): arrival times bit-identical; ``AsyncServer``
over both batchers and both syncs (mixed, spec and prefix arms included),
open loop with a priority mix on a pool small enough to preempt, giving the
reference's streams, deferrals, preemptions, ``stats()``, telemetry report
and Chrome trace; the reference's own ingress properties (streaming,
scheduled-time stamps, the watermark, preempt and resume token-identical,
stall detection) on the port; a preempted lane staged as inactive in the
next window; resume through the prefix cache; and the port's ``serve.py
--batched`` in closed and open loop on ``--device cpu``."""
import asyncio
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import ingress as ref_ingress
from repro.serving.scheduler import ContinuousBatcher as RefContinuousBatcher
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.spec import SpecConfig as RefSpecConfig
from repro.serving.telemetry import FakeClock as RefFakeClock
from repro.serving.trace import Tracer as RefTracer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.serving import ingress
from repro_torch.serving.ingress import AsyncServer, open_loop_workload
from repro_torch.serving.scheduler import (ContinuousBatcher, PagedBatcher,
                                           Request)
from repro_torch.serving.spec import SpecConfig
from repro_torch.serving.telemetry import FakeClock, MonotonicClock
from repro_torch.serving.trace import Tracer, counter_reconciliation

_ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "check_trace", _ROOT / "scripts" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)

BS = 16
STEP = 1e-3                   # virtual seconds per scheduler tick
FP32 = dict(param_dtype="float32", compute_dtype="float32")
LEN_PALETTE = (4, 9, 20, 32, 33, 48, 57, 64)
MAX_LEN = max(LEN_PALETTE) + 16          # prompt + budget, 5 blocks


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


def _paged(cfg, params, *, ref: bool, num_blocks, max_blocks=4, width=3,
           **kw):
    if ref:
        return RefPagedBatcher(cfg, params, num_blocks=num_blocks,
                               block_size=BS, max_blocks_per_seq=max_blocks,
                               decode_width=width, buckets=(32, 64),
                               cache_dtype=jnp.float32, **kw)
    return PagedBatcher(cfg, params, num_blocks=num_blocks, block_size=BS,
                        max_blocks_per_seq=max_blocks, decode_width=width,
                        buckets=(32, 64), cache_dtype=torch.float32,
                        device="cpu", **kw)


def _workload(vocab, seed, n=6):
    """The reference fuzz test's prompt palette, budgets 4..11, the first
    half of the arrivals low priority and the second half high."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(LEN_PALETTE, size=n)
    prompts = [rng.integers(0, vocab, s).astype(np.int32) for s in lens]
    budgets = [int(b) for b in rng.integers(4, 12, size=n)]
    return prompts, budgets, [0] * (n // 2) + [1] * (n - n // 2)


# ------------------------------------------------------------- arrivals --

@pytest.mark.parametrize("kind", ["poisson", "burst"])
@pytest.mark.parametrize("rate,n,seed", [(4.0, 8, 0), (200.0, 50, 3),
                                         (10.0, 400, 11)])
def test_arrival_times_bit_identical(kind, rate, n, seed):
    got = ingress.arrival_times(kind, rate, n, seed)
    np.testing.assert_array_equal(got, ref_ingress.arrival_times(
        kind, rate, n, seed))
    assert np.all(np.diff(got) > 0) and got[0] > 0
    np.testing.assert_array_equal(
        ingress.burst_arrivals(rate, n, seed, burst_size=3, duty=0.5),
        ref_ingress.burst_arrivals(rate, n, seed, burst_size=3, duty=0.5))


def test_arrival_validation():
    with pytest.raises(ValueError, match="unknown arrival"):
        ingress.arrival_times("uniform", 5.0, 8)
    with pytest.raises(ValueError, match="rate"):
        ingress.poisson_arrivals(0.0, 8)
    with pytest.raises(ValueError, match="duty"):
        ingress.burst_arrivals(5.0, 8, duty=1.0)
    with pytest.raises(ValueError, match="burst_size"):
        ingress.burst_arrivals(5.0, 8, burst_size=0)
    sched = open_loop_workload([np.ones(3, np.int32)], [2], [0.5], [1])
    assert sched == [(0.5, dict(prompt=sched[0][1]["prompt"],
                                max_new_tokens=2, rid=0, priority=1))]


# ------------------------------------------------- the server, both packages --

# (batcher, kwargs, workload seed, admission watermark): the dense slots,
# paged host / device (this one behind the watermark), mixed, spec and
# prefix, the paged arms on a pool of 11 blocks (two or three requests of
# up to 5 blocks)
SERVER_ARMS = {
    "dense": ("dense", {}, 0, 0),
    "paged-host": ("paged", dict(sync="host"), 1, 0),
    "paged-device-watermark": ("paged", dict(sync="device", window=3), 1,
                               2),
    "mixed-device": ("paged", dict(sync="device", window=3,
                                   mixed_batch=True), 1, 0),
    "spec-host": ("paged", dict(sync="host", spec=2), 0, 0),
    "prefix-device": ("paged", dict(sync="device", window=3,
                                    prefix_cache=True,
                                    engine_mode="hetero-tensor"), 1, 0),
}


def _serve_both(smoke_model, port_params, arm):
    """One open-loop workload (Poisson at 300 req/s) through the reference's AsyncServer and the port's, each batcher
    traced on a FakeClock: ((handles, server, tracer) of each)."""
    kind, kw, seed, watermark = SERVER_ARMS[arm]
    out = []
    for ref in (True, False):
        cfg, params = (smoke_model[0], smoke_model[2]) if ref else port_params
        clock = RefFakeClock() if ref else FakeClock()
        tracer = (RefTracer if ref else Tracer)(
            clock, cost_model=lambda k, p: max(p, 10.0) * 1e-6)
        if kind == "dense":
            make = RefContinuousBatcher if ref else ContinuousBatcher
            extra = {} if ref else dict(device="cpu")
            b = make(cfg, params, max_batch=2, max_len=MAX_LEN,
                     buckets=(32, 64), tracer=tracer, **extra)
        else:
            b = _paged(cfg, params, ref=ref, num_blocks=11,
                       max_blocks=-(-MAX_LEN // BS), tracer=tracer, **kw)
        mod = ref_ingress if ref else ingress
        server = mod.AsyncServer(b, clock=clock, step_time_s=STEP,
                                 admit_watermark=watermark)
        prompts, budgets, prios = _workload(cfg.vocab_size, seed)
        times = mod.arrival_times("poisson", 300.0, len(prompts), seed)
        handles = server.run_sync(mod.open_loop_workload(
            prompts, budgets, times, prios))
        if kind == "paged":
            b.kv.assert_drained()
        assert not b.busy
        out.append((handles, server, tracer))
    return out


@pytest.mark.parametrize("arm", list(SERVER_ARMS))
def test_server_equals_reference(smoke_model, port_params, arm):
    (rh, rs, rt), (h, s, t) = _serve_both(smoke_model, port_params, arm)
    assert [x.tokens for x in h] == [x.tokens for x in rh]
    assert all(x.done and x.terminal_events == 1 for x in h)
    assert (s.ticks, s.deferrals, s.preemptions) == \
        (rs.ticks, rs.deferrals, rs.preemptions)
    assert s.stats() == {k: v for k, v in rs.stats().items() if k != "tp"}
    assert s.report() == rs.report()
    assert s.report(slo_ms=20.0) == rs.report(slo_ms=20.0)
    assert counter_reconciliation(t, s.stats()) == {}
    assert t.to_chrome() == rt.to_chrome()
    assert t.to_prometheus() == rt.to_prometheus()
    assert check_trace.validate(t.to_chrome()) == []
    if SERVER_ARMS[arm][0] == "paged":
        # 11 blocks hold two or three requests: a high-priority arrival
        # evicts a low-priority lane on every paged arm
        assert s.preemptions > 0 and s.stats()["preemptions"] > 0
        assert s.deferrals > 0


# ----------------------------------------- the reference's ingress properties --

@pytest.fixture(scope="module")
def ref_tokens(smoke_model):
    """The reference's sequential greedy streams: its paged batcher with
    one lane (one request at a time), one instance for the module so its
    compiled chunk graphs are reused."""
    cfg, _, params = smoke_model
    b = _paged(cfg, params, ref=True, num_blocks=9, max_blocks=8, width=1)

    def run(prompts, budgets):
        reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, budgets))]
        b.run(reqs)
        return [r.output for r in reqs]
    return run


def test_submit_and_config_validation(port_params):
    cfg, params = port_params
    server = AsyncServer(_paged(cfg, params, ref=False, num_blocks=9),
                         clock=FakeClock())
    with pytest.raises(ValueError, match="non-empty"):
        server.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        server.submit([1, 2, 3], max_new_tokens=0)
    server.submit([1, 2, 3], rid=7)
    with pytest.raises(ValueError, match="duplicate"):
        server.submit([4, 5], rid=7)
    with pytest.raises(TypeError, match="unsupported batcher"):
        AsyncServer(object())
    with pytest.raises(ValueError, match="advanceable"):
        AsyncServer(_paged(cfg, params, ref=False, num_blocks=9),
                    clock=MonotonicClock(), step_time_s=STEP)
    cb = ContinuousBatcher(cfg, params, max_batch=2, max_len=64,
                           buckets=(32, 64), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        AsyncServer(cb, admit_watermark=2)


def test_streaming_incremental_in_order_terminal_once(ref_tokens,
                                                      port_params):
    """Tokens reach the async consumer as they are produced, in order, each
    stamped in the virtual tick that produced it, then exactly one
    terminal event."""
    cfg, params = port_params
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                                9).astype(np.int32)
    ref = ref_tokens([prompt], [5])[0]
    pb = _paged(cfg, params, ref=False, num_blocks=9)
    clock = FakeClock()
    server = AsyncServer(pb, clock=clock, step_time_s=STEP)

    async def drive():
        handle = server.submit(prompt, max_new_tokens=5)
        seen = []

        async def consume():
            async for tok in handle:
                seen.append((tok, clock.now()))

        consumer = asyncio.create_task(consume())
        await server.run()
        await consumer
        return handle, seen

    handle, seen = asyncio.run(drive())
    assert [t for t, _ in seen] == ref == handle.tokens
    stamps = [st for _, st in seen]
    assert stamps == server.telemetry.traces[0].token_ts
    assert len(set(stamps)) >= 3
    assert handle.done and handle.terminal_events == 1
    pb.kv.assert_drained()
    with pytest.raises(RuntimeError, match="finished twice"):
        handle._finish()
    with pytest.raises(RuntimeError, match="after finish"):
        handle._put_token(6)


def test_open_loop_enqueue_stamped_at_scheduled_time(port_params):
    cfg, params = port_params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
               for s in (6, 9, 4)]
    times = ingress.poisson_arrivals(400.0, 3, seed=2)
    server = AsyncServer(_paged(cfg, params, ref=False, num_blocks=13,
                                width=2),
                         clock=FakeClock(), step_time_s=STEP)
    server.run_sync(open_loop_workload(prompts, [3, 4, 3], times))
    for rid, t in enumerate(times):
        assert server.telemetry.traces[rid].enqueue_t == pytest.approx(t)
        assert server.telemetry.traces[rid].queue_delay >= 0


@pytest.mark.parametrize("sync", ["host", "device"])
def test_priority_preempts_and_resumes_token_identical(ref_tokens,
                                                       port_params, sync):
    """The reference's test on the port, both syncs: a blocked
    high-priority arrival evicts the youngest low-priority lane, which
    resumes later (prompt + emitted tokens, remaining budget); every
    stream equals the never-preempted reference's."""
    cfg, params = port_params
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    budgets = [6, 6, 4]
    refs = ref_tokens(prompts, budgets)
    # 2 usable blocks, 2 lanes: the low-priority pair fills the pool; the
    # high-priority request lands mid-decode and runs only by eviction
    kw = dict(sync=sync) if sync == "host" else dict(sync=sync, window=2)
    pb = _paged(cfg, params, ref=False, num_blocks=3, max_blocks=1,
                width=2, **kw)
    server = AsyncServer(pb, clock=FakeClock(), step_time_s=STEP)
    handles = server.run_sync(open_loop_workload(
        prompts, budgets, [0.0, 0.0, 1.5 * STEP], [0, 0, 1]))
    for h, ref in zip(handles, refs):
        assert h.tokens == ref and h.terminal_events == 1, h.rid
    assert server.preemptions == 1 == pb.preemptions
    victim = server.telemetry.traces[1]   # the youngest low-priority lane
    assert victim.preemptions == 1 and victim.readmits == 1
    assert server.telemetry.traces[2].preemptions == 0
    pb.kv.assert_drained()


def test_watermark_defers_admission_until_blocks_free(ref_tokens,
                                                      port_params):
    cfg, params = port_params
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
               for _ in range(2)]
    refs = ref_tokens(prompts, [4, 4])
    pb = _paged(cfg, params, ref=False, num_blocks=2, max_blocks=1, width=2)
    server = AsyncServer(pb, clock=FakeClock(), step_time_s=STEP)
    handles = server.run_sync(open_loop_workload(prompts, [4, 4],
                                                 [0.0, 0.0]))
    assert [h.tokens for h in handles] == refs
    assert server.deferrals > 0 and server.preemptions == 0
    pb.kv.assert_drained()


def test_stall_detection_raises(port_params):
    cfg, params = port_params
    prompt = np.arange(2 * BS, dtype=np.int32)
    server = AsyncServer(_paged(cfg, params, ref=False, num_blocks=9,
                                max_blocks=1),
                         clock=FakeClock(), step_time_s=STEP)
    with pytest.raises(RuntimeError, match="stalled"):
        server.run_sync(open_loop_workload([prompt], [4], [0.0]))
    tiny = AsyncServer(_paged(cfg, params, ref=False, num_blocks=9),
                       clock=FakeClock(), max_ticks=2)
    with pytest.raises(RuntimeError, match="max_ticks"):
        tiny.run_sync(open_loop_workload([prompt[:5]], [6], [0.0]))


# --------------------------------------------------------------- preemption --

def test_preempt_validation_and_inactive_staging(port_params):
    """``preempt`` refuses an idle or finishing lane; a preempted lane's
    request is returned unfinished, its blocks are back, and the next
    window stages it as an inactive lane (null table, length 0, nothing
    remaining)."""
    cfg, params = port_params
    pb = _paged(cfg, params, ref=False, num_blocks=9, sync="device",
                window=2)
    with pytest.raises(ValueError, match="idle lane"):
        pb.preempt(0)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 20
                                               ).astype(np.int32),
                    max_new_tokens=8) for i in range(2)]
    for r in reqs:
        pb.submit(r)
    pb.step()
    staged = []
    loop = pb._loop("window")
    pb._loops[pb.loop_key("window")] = \
        lambda *xs: (staged.append([x.clone() for x in xs]), loop(*xs))[1]
    held = pb.kv.utilization()
    victim = pb.preempt(0)
    assert victim is reqs[0] and not victim.done and pb.lanes[0] is None
    assert pb.kv.utilization() < held and pb.stats()["preemptions"] == 1
    pb.step()
    last, tables, lengths, remaining = staged[-1]
    assert int(remaining[0]) == 0 and int(lengths[0]) == 0
    assert not tables[0].any() and int(remaining[1]) > 0
    pb.lanes[1].budget = 0
    with pytest.raises(ValueError, match="finishing lane"):
        pb.preempt(1)


@pytest.mark.parametrize("arm", [
    dict(sync="host", prefix_cache=True),
    dict(sync="device", window=3, spec=2),
])
def test_random_preemption_points_token_identical(ref_tokens, port_params,
                                                  arm):
    """The reference's preempt -> resume fuzz on the port: at seeded random
    steps a random live lane is evicted and resubmitted as prompt + emitted
    with the remaining budget; the stitched streams equal the reference's
    never-preempted streams and the pool drains (the spec arm's draft lane
    rolls back with its lane)."""
    cfg, params = port_params
    prompts, budgets, _ = _workload(cfg.vocab_size, 3)
    refs = ref_tokens(prompts, budgets)
    nb = 1 + len(prompts) * -(-MAX_LEN // BS)
    pb = _paged(cfg, params, ref=False, num_blocks=nb,
                max_blocks=-(-MAX_LEN // BS), **arm)
    rng = np.random.default_rng(103)
    reqs = {i: Request(rid=i, prompt=prompts[i], max_new_tokens=budgets[i])
            for i in range(len(prompts))}
    for r in reqs.values():
        pb.submit(r)
    before = {i: [] for i in reqs}
    steps = 0
    while pb.busy:
        pb.step()
        steps += 1
        assert steps < 500
        if rng.random() < 0.5:
            cands = [i for i, ln in enumerate(pb.lanes)
                     if ln is not None and ln.budget > 0]
            if cands:
                victim = pb.preempt(int(rng.choice(cands)))
                before[victim.rid].extend(int(t) for t in victim.output)
                resumed = Request(
                    rid=victim.rid,
                    prompt=np.concatenate([prompts[victim.rid], np.asarray(
                        before[victim.rid], np.int32)]),
                    max_new_tokens=budgets[victim.rid]
                    - len(before[victim.rid]))
                reqs[victim.rid] = resumed
                pb.submit(resumed)
    for i in reqs:
        assert reqs[i].done and before[i] + reqs[i].output == refs[i], i
    pb.kv.assert_drained()
    assert pb.preemptions > 0


def test_preempt_resume_reuses_prefix_cache(ref_tokens, port_params):
    """A preempted request's full blocks retire through the prefix cache:
    its resume allocates fewer fresh blocks than without the cache, and the
    stream is the same either way."""
    cfg, params = port_params
    prompt = np.random.default_rng(77).integers(0, cfg.vocab_size,
                                                3 * BS).astype(np.int32)
    ref = ref_tokens([prompt], [6])[0]
    allocs = {}
    for cached in (False, True):
        pb = _paged(cfg, params, ref=False, num_blocks=17, max_blocks=5,
                    width=2, sync="host", prefix_cache=cached)
        pb.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
        pb.step()
        pb.step()
        emitted = [int(t) for t in pb.preempt(0).output]
        assert pb.stats()["cached_blocks"] == (3 if cached else 0)
        resumed = Request(rid=0, prompt=np.concatenate(
            [prompt, np.asarray(emitted, np.int32)]),
            max_new_tokens=6 - len(emitted))
        pb.submit(resumed)
        while pb.busy:
            pb.step()
        assert emitted + resumed.output == ref, cached
        pb.kv.assert_drained()
        allocs[cached] = pb.kv.allocator.total_allocs
    assert allocs[True] < allocs[False]


# --------------------------------------------------------------------- CLI --

def test_cli_batched_closed_and_open_loop_on_cpu(tmp_path, capsys):
    """``serve.py --batched`` (the dense batcher, closed loop) and
    ``--batched --paged --open-loop`` with a priority mix, a trace, metrics
    and the drift table, on the CPU: the reference's report lines, a trace
    that passes scripts/check_trace.py."""
    common = ["--smoke", "--device", "cpu", "--prompt-len", "40",
              "--new-tokens", "4"]
    serve.main([*common, "--batched", "--requests", "3", "--stats"])
    out = capsys.readouterr().out
    assert "batched (slots=4, device=cpu): closed-loop, 3 reqs, 12 tokens" \
        in out
    for line in ("  ttft: p50 ", "  tpot: p50 ", "  queue_delay: p50 ",
                 "  goodput: ", "'ingress_ticks'"):
        assert line in out, line
    trace_out, metrics_out = tmp_path / "t.json", tmp_path / "m.prom"
    serve.main([*common, "--batched", "--paged", "--engine-mode",
                "hetero-tensor", "--sync", "device", "--open-loop",
                "--rate", "50", "--priority-mix", "0.5", "--slo-ms", "500",
                "--requests", "4", "--max-blocks", "6", "--trace-out",
                str(trace_out), "--metrics-out", str(metrics_out),
                "--plan-drift"])
    out = capsys.readouterr().out
    assert "open-loop poisson@50.0/s, 4 reqs, 16 tokens" in out
    assert "under TTFT SLO 500 ms" in out
    assert f"-> {trace_out}" in out and f"-> {metrics_out}" in out
    assert "decision rows" in out and "host dispatches" in out
    assert check_trace.validate(json.loads(trace_out.read_text())) == []
    assert "repro_decode_dispatches_total" in metrics_out.read_text()
    for argv in (["--open-loop"], ["--batched", "--priority-mix", "0.5"],
                 ["--batched", "--paged", "--priority-mix", "2"],
                 ["--trace-out", str(trace_out)],
                 ["--batched", "--watermark", "2"]):
        with pytest.raises(SystemExit):
            serve.main([*common, *argv])


@pytest.mark.parametrize("shared,mix", [(0, 0.5), (16, 0.0), (20, 1.0)])
def test_cli_workload_draw_equals_reference(shared, mix):
    """``serve.draw_workload`` draws what the reference's launcher draws
    in line (repro/launch/serve.py: the shared prefix, the prompts, then
    the priorities, from one seeded generator)."""
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, 1000, shared).astype(np.int32)
    want = [np.concatenate([sys_prompt, rng.integers(
        0, 1000, rng.integers(8, 60 - shared)).astype(np.int32)])
        for _ in range(6)]
    want_prios = [0 if rng.random() < mix else 1 for _ in range(6)]
    prompts, prios = serve.draw_workload(np.random.default_rng(0), 1000, 6,
                                         60, shared, mix)
    assert prios == want_prios
    for p, w in zip(prompts, want):
        np.testing.assert_array_equal(p, w)


def test_dense_cli_and_batcher_need_the_card_unless_asked():
    cfg = get_smoke_config("llama3-8b")
    if torch.cuda.is_available():
        assert ContinuousBatcher(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatcher(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--batched", "--requests", "1"])
    assert ContinuousBatcher(cfg, device="cpu").device.type == "cpu"
