"""A split's two halves and their streams (``core/partition.py``).

On the card ``_concurrent`` runs a split's aligned half on the device's
side stream and its flexible half on the current one, forking and joining
with stream waits and telling the caching allocator which stream reads
what; here that protocol is held on stand-in streams and tensors, in
order. On the CPU the halves run one after the other, and never ask for a
stream. A plan that splits every site (weight, act and hybrid at the
prefill chunk lengths, weight at M = 1 inside the decode loop) gives the
reference engine's greedy tokens on the fp32 llama3 and zamba2 smoke
models with the reference's parameters, under fast and host sync; the
paged batcher takes a latency table (``table=``) and serves the same
tokens on a plan solved from it."""
from contextlib import contextmanager
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.engine import InferenceEngine as RefEngine
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import characteristics as ch
from repro_torch.core import partition
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.partition import HeteroCtx, QuantWeight
from repro_torch.core.profiler import (LatencyTable, model_weight_shapes,
                                       profile_analytic)
from repro_torch.core.solver import Decision, PartitionPlan, PartitionSolver
from repro_torch.kernels.hetero_matmul.ops import quantize_weight
from repro_torch.serving.scheduler import PagedBatcher, Request

BUCKETS = (32, 64)
PROMPT_LEN, NEW_TOKENS = 77, 5


# ------------------------------------------- the protocol, on stand-ins --

class _Stream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append(f"{self.name} waits {other.name}")


class _Tensor:
    """Stands for a CUDA tensor: a device and ``record_stream``."""

    def __init__(self, name, log):
        self.name, self.log = name, log
        self.device = torch.device("cuda", 0)

    def record_stream(self, stream):
        self.log.append(f"{self.name} read on {stream.name}")


@pytest.fixture
def card(monkeypatch):
    """Stand-in streams for device cuda:0: ``torch.cuda.current_stream``
    follows ``torch.cuda.stream`` blocks, and every call is logged."""
    log = []
    main, side = _Stream("main", log), _Stream("side", log)
    current = [main]

    @contextmanager
    def stream(s):
        log.append(f"enter {s.name}")
        current.append(s)
        try:
            yield
        finally:
            current.pop()
            log.append(f"leave {s.name}")

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current[-1])
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(partition, "side_stream", lambda device: side)
    return log, current


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_concurrent_forks_and_joins_around_the_halves(card, quantized):
    """Fork (side waits for current), the reads marked on the side stream,
    the aligned half launched inside the side stream's block, the flexible
    half on the current stream, the join (current waits for side), and the
    aligned output marked as read on the current stream."""
    log, current = card
    x2 = _Tensor("x2", log)
    if quantized:
        w = QuantWeight(_Tensor("wq", log), _Tensor("scale", log), "int8",
                        8)
        reads = ["x2 read on side", "wq read on side", "scale read on side"]
    else:
        w = _Tensor("w", log)
        reads = ["x2 read on side", "w read on side"]
    ya = _Tensor("ya", log)

    def aligned():
        log.append(f"aligned on {current[-1].name}")
        return ya

    def flexible():
        log.append(f"flexible on {current[-1].name}")
        return "yf"

    assert partition._concurrent(aligned, flexible, x2, w) == (ya, "yf")
    assert log == ["side waits main", *reads, "enter side",
                   "aligned on side", "leave side", "flexible on main",
                   "main waits side", "ya read on main"]


def test_one_stream_hook_keeps_both_halves_on_the_current_stream(card,
                                                                 monkeypatch):
    """With the hook answering the current stream (the card's one-stream
    arm) the same protocol runs, every wait and mark on that stream."""
    log, current = card
    monkeypatch.setattr(partition, "side_stream",
                        lambda device: current[-1])
    x2, w, ya = (_Tensor(n, log) for n in ("x2", "w", "ya"))
    partition._concurrent(lambda: ya, lambda: "yf", x2, w)
    assert log == ["main waits main", "x2 read on main", "w read on main",
                   "enter main", "leave main", "main waits main",
                   "ya read on main"]


def test_cpu_halves_run_in_order_without_a_stream(monkeypatch):
    def no_stream(device):
        raise AssertionError("a CPU split asked for a stream")
    monkeypatch.setattr(partition, "side_stream", no_stream)
    order = []
    x2, w = torch.ones((3, 4)), torch.ones((4, 5))
    out = partition._concurrent(lambda: order.append("aligned") or 1,
                                lambda: order.append("flexible") or 2, x2, w)
    assert out == (1, 2) and order == ["aligned", "flexible"]


# ------------------------------------------------- every strategy's split --

def _plan(site, rows):
    plan = PartitionPlan("t", "fast")
    for M, s, n, b in rows:
        plan.decisions[(site, M)] = Decision(site, M, s, 0.0, n, b)
    return plan


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_each_split_goes_through_concurrent_once(monkeypatch, quantized):
    """weight, act and hybrid call ``_concurrent`` once each (the hybrid's
    two flexible products are one half); the unsplit strategies never. Every
    result equals the plain product."""
    calls = []
    inner = partition._concurrent

    def spy(aligned, flexible, x2, w):
        calls.append(x2.shape[0])
        return inner(aligned, flexible, x2, w)
    monkeypatch.setattr(partition, "_concurrent", spy)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((96, 300)).astype(np.float32))
    if quantized:
        w = QuantWeight(*quantize_weight(w), "int8", 96)
    dense = w.dequant() if quantized else w
    rows = [(5, "xla_only", 0, 0), (7, "pad", 0, 128), (128, "mxu_only", 0, 0),
            (130, "weight", 128, 0), (260, "act", 0, 256),
            (300, "hybrid", 128, 256), (1, "weight", 128, 0)]
    ctx = HeteroCtx(plan=_plan("w", rows))
    for M, *_ in rows:
        x = torch.from_numpy(rng.standard_normal((M, 96)).astype(np.float32))
        torch.testing.assert_close(ctx.matmul(x, w, name="w"), x @ dense,
                                   rtol=1e-5, atol=1e-4)
    assert calls == [130, 260, 300, 1]


# ------------------------------------------- a plan that splits every site --

def split_plan(cfg, ms):
    """Every site of ``cfg`` split: by weight at M = 1, and at each chunk
    length of ``ms`` by weight, act or hybrid in turn."""
    plan = PartitionPlan(arch=cfg.name, sync_mode="fast")
    kinds = ("weight", "act", "hybrid")
    for i, (site, (_, N)) in enumerate(model_weight_shapes(cfg).items()):
        n = max(128, N // 256 * 128)
        plan.decisions[(site, 1)] = Decision(site, 1, "weight", 0.0, n)
        for j, M in enumerate(ms):
            kind = kinds[(i + j) % 3]
            plan.decisions[(site, M)] = Decision(
                site, M, kind, 0.0, 0 if kind == "act" else n,
                0 if kind == "weight" else max(1, M // 2))
    return plan


def _fp32(cfg):
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", params=["llama3-8b", "zamba2-2.7b"])
def models(request):
    arch = request.param
    ref_cfg = _fp32(ref_configs.get_smoke_config(arch))
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(7))
    cfg = _fp32(get_smoke_config(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    prompt = np.random.default_rng(3).integers(0, 256, (1, PROMPT_LEN))
    ref = RefEngine(ref_cfg, ref_params, mode="xla",
                    prefill_strategy="hetero", buckets=BUCKETS, max_len=256)
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32),
                                   max_new_tokens=NEW_TOKENS)).tolist()
    return cfg, params, prompt, want


@pytest.mark.parametrize("fast_sync", [True, False], ids=["fast", "host"])
def test_split_everything_plan_gives_the_reference_tokens(models, fast_sync,
                                                          monkeypatch):
    """Prefill chunks (64, 13) split by weight / act / hybrid at every site
    and each decode step split by weight at M = 1 (the decode step given the
    engine's HeteroCtx, so its loop holds the splits): the reference
    engine's tokens, and every split site passed through ``_concurrent``."""
    cfg, params, prompt, want = models
    seen = set()
    inner = partition._concurrent

    def spy(aligned, flexible, x2, w):
        seen.add(x2.shape[0])
        return inner(aligned, flexible, x2, w)
    monkeypatch.setattr(partition, "_concurrent", spy)
    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy="hetero", fast_sync=fast_sync,
                          plan=split_plan(cfg, (64, 13)), buckets=BUCKETS,
                          device="cpu")
    eng.model = replace(eng.model, decode_step=partial(
        eng.model.decode_step, hetero_ctx=eng.ctx))
    assert eng._bucket_chunks(PROMPT_LEN) == [(64, 64), (13, 13)]
    assert eng.generate(prompt, NEW_TOKENS).tolist() == want
    assert seen == {64, 13, 1}


def _requests(prompts, n):
    return [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, p in enumerate(prompts)]


def test_paged_batcher_plans_from_a_given_table():
    """``PagedBatcher(table=)``: the plan is solved from the table on its
    spec (a measured-mode H100 table here), the tokens equal the
    engine-less arm's; a table profiled for other weights is refused."""
    cfg = _fp32(get_smoke_config("llama3-8b"))
    table = profile_analytic(cfg, ch.H100)
    table = LatencyTable(spec=ch.H100, mode="measured", sites=table.sites,
                         entries=dict(table.entries))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 70, 130)]
    outs = {}
    for mode in ("hetero-tensor", None):
        cb = PagedBatcher(cfg, num_blocks=24, block_size=32,
                          max_blocks_per_seq=8, decode_width=4,
                          sync="device", window=4, engine_mode=mode,
                          table=table if mode else None, device="cpu")
        reqs = _requests(prompts, 6)
        cb.run(reqs)
        outs[mode] = [r.output for r in reqs]
        if mode:
            plan = cb.ctx.plan
    assert outs["hetero-tensor"] == outs[None]
    want = PartitionSolver(table, ch.H100, sync_mode="fast").solve(cfg)
    assert plan.decisions == want.decisions
    with pytest.raises(ValueError, match="table profiled for weights"):
        PagedBatcher(cfg, engine_mode="hetero-tensor", weight_quant="int8",
                     table=table, device="cpu")


def test_split_plan_covers_every_site_and_strategy():
    plan = split_plan(get_config("llama3-8b"), (256, 44))
    kinds = {d.strategy for d in plan.decisions.values()}
    assert kinds == {"weight", "act", "hybrid"}
    for (site, M), d in plan.decisions.items():
        assert d.strategy != "xla_only"
        if d.strategy != "act":
            assert d.n_split % 128 == 0 and d.n_split > 0
        if M == 1:
            assert d.strategy == "weight"
