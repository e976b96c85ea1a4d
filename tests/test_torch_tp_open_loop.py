"""Open-loop tensor-parallel serving (``serve.py --tp N --open-loop``):
one admission for the model group (serving/ingress.py::TickBroadcast).

Four gloo ranks (a data 2 x model 2 mesh: two replicas of a TP = 2 pair,
tests/torch_tp_ranks.py) serve a seeded Poisson and a bursty open-loop
schedule on a FakeClock, eight requests of two priorities through two
lanes and a small pool, so arrivals defer and high-priority ones preempt.
Each pair's first rank admits on its clock and broadcasts each tick's
decisions; its partner applies them. Every rank's token streams,
``stats()`` and ``report()`` must equal the single-device server's, and
that run's tokens the reference's AsyncServer's on the same schedule.
"""
import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro.serving.ingress import AsyncServer as RefAsyncServer
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.telemetry import FakeClock as RefFakeClock
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import spawn_ranks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(smoke_model):
    cfg = ranks.smoke_cfg()
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def tp(port):
    return spawn_ranks(ranks.open_loop_rank, 4, port[1], device="cpu")


@pytest.fixture(scope="module")
def single(port):
    return {name: ranks.open_loop(*port, **kw)
            for name, kw in ranks.OPEN_LOOP.items()}


@pytest.mark.parametrize("schedule", tuple(ranks.OPEN_LOOP))
def test_tp_open_loop_equals_single_device(tp, single, schedule):
    want = single[schedule]
    assert want["stats"]["ingress_deferrals"] > 0
    assert want["stats"]["ingress_preemptions"] > 0
    for rank, res in enumerate(tp):
        got = res[schedule]
        assert got["tokens"] == want["tokens"], rank
        assert got["stats"] == want["stats"], rank
        assert got["report"] == want["report"], rank


@pytest.mark.parametrize("schedule", tuple(ranks.OPEN_LOOP))
def test_single_device_open_loop_equals_reference(smoke_model, single,
                                                  schedule):
    """The reference's AsyncServer on the same schedule, batcher shape,
    watermark and virtual tick: the same streams and ingress counters."""
    cfg, _, params = smoke_model
    pool = dict(ranks.POOL, num_blocks=14, decode_width=2)
    pool["cache_dtype"] = jax.numpy.float32
    b = RefPagedBatcher(cfg, params, sync="device", window=3, **pool)
    server = RefAsyncServer(b, clock=RefFakeClock(),
                            step_time_s=ranks.OPEN_LOOP_STEP,
                            admit_watermark=1)
    handles = server.run_sync(ranks.open_loop_workload(
        ranks.smoke_cfg(), **ranks.OPEN_LOOP[schedule]))
    want = single[schedule]
    assert {h.rid: tuple(h.tokens) for h in handles} == want["tokens"]
    rs = server.stats()
    for key in ("ingress_ticks", "ingress_preemptions", "ingress_deferrals"):
        assert rs[key] == want["stats"][key], key
