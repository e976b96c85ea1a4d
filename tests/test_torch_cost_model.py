"""The port's cost model, profiler and solver against the reference.

On the reference's V5E model the port's plan equals the reference's on
every config the port has: the plain decisions, the MIXED pairs of the
reference's tests, the VERIFY shapes k in {1, 2, 4} x lanes in {1, 4},
the decode KV layout, both gain accounts and every ``describe()`` string.
The H100 spec and a seeded synthetic measured table keep the properties of
``tests/test_solver_properties.py``. ``profile_measured`` under an injected
clock is deterministic and covers what the reference's covers. HeteroCtx's
fields ``order_exchange``, ``layer_mxu_threshold``, ``stationary`` and
``verify_key`` act as the reference's do, on the same inputs and plan."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import profiler as ref_profiler
from repro.core.engine import build_hetero_ctx as ref_build_hetero_ctx
from repro.core.engine import build_plan as ref_build_plan
from repro.core.partition import HeteroCtx as RefHeteroCtx
from repro.core.solver import Decision as RefDecision
from repro.core.solver import PartitionPlan as RefPlan
from repro.core.solver import PartitionSolver as RefSolver
from repro_torch import configs
from repro_torch.core import characteristics as ch
from repro_torch.core.engine import build_hetero_ctx, build_plan
from repro_torch.core.partition import HeteroCtx
from repro_torch.core.profiler import (LatencyTable, model_weight_shapes,
                                       profile_analytic, profile_measured)
from repro_torch.core.solver import (ALIGN, Decision, PartitionPlan,
                                     PartitionSolver)
from repro_torch.serving.telemetry import FakeClock

ARCHS = configs.ARCHS
# the reference tests' serving pairs (tests/test_solver_properties.py)
MIXED_PAIRS = ((64, 4), (128, 8), (256, 8))
VERIFY_KS = tuple((k, lanes) for k in (1, 2, 4) for lanes in (1, 4))
MS = (1, 7, 64, 100, 128, 192, 300, 511, 512, 1000, 2048)
# fp32 sums of HeteroCtx's paths, taken in another order than XLA's
FP32_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, smoke):
    if smoke:
        return configs.get_smoke_config(arch), \
            ref_configs.get_smoke_config(arch)
    return configs.get_config(arch), ref_configs.get_config(arch)


# ------------------------------------------------------ V5E: the reference --

@pytest.mark.parametrize("weight_quant", [None, "int8", "w4a16"],
                         ids=["fp", "int8", "w4a16"])
@pytest.mark.parametrize("sync_mode", ["fast", "host"])
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_v5e_plan_equals_reference(arch, smoke, sync_mode, weight_quant):
    cfg, ref = _configs(arch, smoke)
    kw = dict(sync_mode=sync_mode, mixed_pairs=MIXED_PAIRS,
              verify_ks=VERIFY_KS, weight_quant=weight_quant)
    table, plan = build_plan(cfg, **kw)
    ref_table, ref_plan = ref_build_plan(ref, **kw)
    assert table.spec is ch.V5E and table.mode == ref_table.mode
    assert table.sites == ref_table.sites
    assert table.entries == ref_table.entries
    for mine, theirs in ((plan.decisions, ref_plan.decisions),
                         (plan.mixed_decisions, ref_plan.mixed_decisions),
                         (plan.verify_decisions, ref_plan.verify_decisions)):
        assert mine.keys() == theirs.keys()
        for key, dec in mine.items():
            assert dataclasses.asdict(dec) == \
                dataclasses.asdict(theirs[key]), key
            assert dec.describe() == theirs[key].describe()
    assert plan.kv_mode == ref_plan.kv_mode
    assert (plan.arch, plan.sync_mode, plan.weight_quant) == \
        (ref_plan.arch, ref_plan.sync_mode, ref_plan.weight_quant)
    solver = PartitionSolver(table, sync_mode=sync_mode)
    ref_solver = RefSolver(ref_table, sync_mode=sync_mode)
    for site in table.sites:
        for mp, md in MIXED_PAIRS:
            assert solver.mixed_gain_us(site, mp, md) == \
                ref_solver.mixed_gain_us(site, mp, md)
        for k, lanes in VERIFY_KS:
            assert solver.verify_gain_us(site, k, lanes) == \
                ref_solver.verify_gain_us(site, k, lanes)


def test_extra_ms_and_cost_functions_equal_reference():
    """``extra_ms`` joins the grid as in the reference; the two cost
    functions ported with the model give the reference's numbers."""
    from repro.core import characteristics as ref_ch
    cfg, ref = _configs("llama3-8b", False)
    _, plan = build_plan(cfg, extra_ms=(32, 96))
    _, ref_plan = ref_build_plan(ref, extra_ms=(32, 96))
    assert plan.decisions == {k: Decision(**dataclasses.asdict(d))
                              for k, d in ref_plan.decisions.items()}
    for a, b in ((1, 2), (10 ** 6, 3 * 10 ** 7)):
        assert ch.dual_path_memory_time_us(a, b) == \
            ref_ch.dual_path_memory_time_us(a, b)
    for M in (1, 135, 1000):
        assert ch.compile_time_model_us(M, 64, 64) == \
            ref_ch.compile_time_model_us(M, 64, 64)


def test_v5e_spec_is_the_reference_verbatim():
    from repro.core import characteristics as ref_ch
    assert dataclasses.asdict(ch.V5E) == dataclasses.asdict(ref_ch.V5E)
    assert ch.V5E.clock_hz == ref_ch.V5E.clock_hz


# ------------------------------------------------------------ H100 spec --

def test_h100_spec_has_every_field_and_its_own_tile_rate():
    fields = {f.name for f in dataclasses.fields(ch.TPUSpec)}
    assert fields <= {f.name for f in dataclasses.fields(ch.H100)}
    assert ch.H100.name == "h100_sxm5"
    assert ch.H100.peak_flops_bf16 == 989e12 and ch.H100.hbm_bw == 3.35e12
    assert 0 < ch.H100.bw_frac_single <= 1 and 0 < ch.H100.bw_frac_dual <= 1
    assert 0 < ch.H100.xla_eff <= 1 and 0 < ch.H100.mxu_eff <= 1
    # the tile rate scales the stage model's compute and nothing else
    at_peak = dataclasses.replace(ch.H100, mxu_eff=1.0)
    c, b = ch.mxu_matmul_parts(256, 4096, 7168, ch.H100)
    c1, b1 = ch.mxu_matmul_parts(256, 4096, 7168, at_peak)
    assert b == b1 and c == pytest.approx(c1 / ch.H100.mxu_eff, rel=1e-12)
    # every cost function takes either spec
    for spec in (ch.V5E, ch.H100):
        assert ch.xla_matmul_time_us(64, 512, 512, spec) > 0
        assert ch.combine_dual((1.0, 10), (2.0, 20), spec) >= 2.0
        assert ch.sync_cost_us("host", spec) == spec.dispatch_us


def _synthetic_measured(cfg, seed: int) -> LatencyTable:
    """A measured-mode H100 table: the H100 model's entries at the
    reference's measured grid, each scaled by a seeded factor in
    [0.6, 1.6), aligned-path entries only where K and N are 128-aligned."""
    rng = np.random.default_rng(seed)
    base = profile_analytic(cfg, ch.H100, Ms=(1, 32, 128, 256, 512))
    table = LatencyTable(spec=ch.H100, mode="measured",
                         sites=dict(base.sites))
    for (site, M, path), t in sorted(base.entries.items()):
        K, N = base.sites[site]
        if path == "mxu" and (K % ALIGN or N % ALIGN):
            continue
        table.entries[(site, M, path)] = t * rng.uniform(0.6, 1.6)
    return table


@pytest.fixture(params=[(a, src) for a in ARCHS
                        for src in ("h100", "measured")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def h100_solver(request):
    arch, src = request.param
    cfg = configs.get_config(arch)
    table = (profile_analytic(cfg, ch.H100) if src == "h100"
             else _synthetic_measured(cfg, seed=ARCHS.index(arch)))
    solver = PartitionSolver(table, sync_mode="fast")
    assert solver.spec is ch.H100
    return cfg, solver


def test_h100_best_never_worse_than_xla_only(h100_solver):
    cfg, s = h100_solver
    for site in s.table.sites:
        for M in MS:
            dec = s.solve_site(site, M)
            assert dec.t_us <= s.table.lookup(site, M, "xla") + 1e-9, \
                f"{cfg.name}: {dec.describe()}"


def test_h100_split_points_aligned_and_interior(h100_solver):
    _, s = h100_solver
    for site, (_, N) in s.table.sites.items():
        for M in MS:
            dec = s.solve_site(site, M)
            if dec.strategy in ("weight", "hybrid"):
                assert dec.n_split % ALIGN == 0, dec.describe()
                assert 0 < dec.n_split < N, dec.describe()
            if dec.strategy in ("act", "hybrid"):
                assert 0 < dec.m_bucket < M, dec.describe()


def test_h100_mixed_pairs_consistent(h100_solver):
    _, s = h100_solver
    for site in s.table.sites:
        for mp, md in MIXED_PAIRS:
            dec = s.solve_mixed(site, mp, md)
            assert dec.strategy == "mixed" and dec.m_bucket == mp
            assert dec.M == mp + md
            assert s.mixed_gain_us(site, mp, md) >= 0.0, dec.describe()


def test_h100_verify_is_the_plain_search(h100_solver):
    _, s = h100_solver
    for site in s.table.sites:
        for k, lanes in VERIFY_KS:
            v, d = s.solve_verify(site, k, lanes), \
                s.solve_site(site, lanes * (k + 1))
            assert (v.strategy, v.t_us, v.M) == (d.strategy, d.t_us, d.M)


def test_solver_prices_on_the_tables_spec():
    """A V5E table plans on V5E unless told otherwise; an H100 table on
    H100 (engine.build_plan and predicted_prefill_us included)."""
    from repro_torch.core.engine import InferenceEngine
    cfg = configs.get_smoke_config("llama3-8b")
    measured = _synthetic_measured(configs.get_config("llama3-8b"), 0)
    assert PartitionSolver(profile_analytic(cfg)).spec is ch.V5E
    assert PartitionSolver(measured).spec is ch.H100
    assert PartitionSolver(measured, ch.V5E).spec is ch.V5E
    full = configs.get_config("llama3-8b")
    _, plan = build_plan(full, table=measured)
    want = PartitionSolver(measured, ch.H100).solve(full)
    assert plan.decisions == want.decisions
    eng = InferenceEngine(cfg, mode="xla",
                          table=profile_analytic(cfg, ch.H100),
                          device="cpu")
    h100 = PartitionSolver(eng.table, ch.H100)
    assert eng.predicted_prefill_us(300) == pytest.approx(
        cfg.n_layers * sum(h100.solve_site(s, 300).t_us
                           for s in eng.table.sites if s != "head"))


# ------------------------------------------------------------ save / load --

def test_plan_round_trip_keeps_every_key_space(tmp_path):
    cfg = configs.get_config("llama3-8b")
    _, plan = build_plan(cfg, mixed_pairs=MIXED_PAIRS, verify_ks=VERIFY_KS,
                         weight_quant="int8")
    path = tmp_path / "plan.json"
    plan.save(path)
    back = PartitionPlan.load(path)
    assert back == plan
    assert back.kv_mode == plan.kv_mode and back.weight_quant == "int8"
    assert back.mixed_decision("w_gate", 64, 4) == \
        plan.mixed_decisions[("w_gate", 64, 4)]
    assert back.verify_decision("wq", 2, 4) == \
        plan.verify_decisions[("wq", 2, 4)]
    # the reference reads the port's file to the same decisions
    ref = RefPlan.load(path)
    assert {k: dataclasses.asdict(d) for k, d in ref.verify_decisions.items()} \
        == {k: dataclasses.asdict(d) for k, d in plan.verify_decisions.items()}


@pytest.mark.parametrize("mode", ["analytic", "measured"])
def test_table_round_trip_keeps_mode_and_spec(tmp_path, mode):
    cfg = configs.get_config("zamba2-2.7b")
    table = (profile_analytic(cfg, ch.H100, weight_quant="w4a16")
             if mode == "analytic" else _synthetic_measured(cfg, 3))
    path = tmp_path / "table.json"
    table.save(path)
    back = LatencyTable.load(path)
    assert back.spec is ch.H100 and back.mode == mode
    assert back.weight_quant == table.weight_quant
    assert back.sites == table.sites and back.entries == table.entries
    assert LatencyTable.load(path, ch.V5E).spec is ch.V5E
    ref = ref_profiler.LatencyTable.load(path)
    assert ref.mode == mode and ref.entries == table.entries


# --------------------------------------------------------- profile_measured --

class TickingClock(FakeClock):
    """A FakeClock that moves 1 us at every reading."""

    def now(self) -> float:
        t = super().now()
        self.advance(1e-6)
        return t


def _aligned_config(port: bool):
    """llama3's smoke model at 128-aligned widths, in either package."""
    get = configs.get_smoke_config if port else \
        ref_configs.get_smoke_config
    return get("llama3-8b").with_(d_model=128, n_heads=4, n_kv_heads=2,
                                  d_ff=384, vocab_size=640)


@pytest.mark.parametrize("weight_quant", [None, "int8", "w4a16"],
                         ids=["fp", "int8", "w4a16"])
def test_profile_measured_deterministic_under_an_injected_clock(
        weight_quant):
    cfg = _aligned_config(True)
    runs = [profile_measured(cfg, (1, 32, 128), device="cpu",
                             weight_quant=weight_quant, clock=TickingClock(),
                             max_kn=4096) for _ in range(2)]
    a, b = runs
    assert a.entries == b.entries and a.sites == b.sites
    assert a.mode == "measured" and a.spec is ch.V5E
    assert a.weight_quant == weight_quant
    # each fenced call reads the clock twice: one tick apart
    assert all(v == pytest.approx(1.0) for v in a.entries.values())


def test_profile_measured_covers_the_references_keys():
    """The reference's sites, token counts and aligned-path coverage (an
    mxu entry where K and N are 128-aligned), capped alike."""
    cfg, ref = _aligned_config(True), _aligned_config(False)
    ms = (1, 32, 128)
    mine = profile_measured(cfg, ms, device="cpu", clock=TickingClock(),
                            max_kn=256, repeats=1)
    theirs = ref_profiler.profile_measured(ref, ms, repeats=1, max_kn=256)
    assert mine.sites == theirs.sites
    assert set(mine.entries) == set(theirs.entries)
    assert any(p == "mxu" for (_, _, p) in mine.entries)
    assert any(p == "xla" and (s, m, "mxu") not in mine.entries
               for (s, m, p) in mine.entries)


def test_profile_measured_uncapped_keeps_the_models_sites():
    cfg = configs.get_smoke_config("zamba2-2.7b")
    full = profile_measured(cfg, (1, 8), device="cpu", clock=TickingClock())
    assert full.sites == model_weight_shapes(cfg)
    capped = profile_measured(cfg, (1, 8), device="cpu",
                              clock=TickingClock(), max_kn=32)
    assert capped.sites == {s: (min(k, 32), min(n, 32))
                            for s, (k, n) in model_weight_shapes(cfg).items()}
    assert max(max(kn) for kn in full.sites.values()) > 32
    # a measured table plans: the solver takes it as it is
    _, plan = build_plan(cfg, table=full)
    assert plan.decisions and plan.kv_mode in ("head", "seq")


# ------------------------------------------------------ HeteroCtx's fields --

def _pair(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("stationary", ["output", "weight"])
@pytest.mark.parametrize("order_exchange", [True, False],
                         ids=["exchange", "no-exchange"])
@pytest.mark.parametrize("M,K,N", [(9, 96, 300), (200, 64, 40)],
                         ids=["thin", "tall"])
def test_mxu_fields_match_reference(order_exchange, stationary, M, K, N):
    """``order_exchange`` and ``stationary`` on the aligned path (mode
    'mxu'): the port's padded kernel call against the reference's Pallas
    kernel in interpret mode, the same exchange predicate on V5E."""
    tx, jx = _pair((M, K), 1)
    tw, jw = _pair((K, N), 2)
    ctx = HeteroCtx(mode="mxu", order_exchange=order_exchange,
                    stationary=stationary)
    ref = RefHeteroCtx(mode="mxu", interpret=True,
                       order_exchange=order_exchange, stationary=stationary)
    assert _rel(ctx.matmul(tx, tw).numpy(), ref.matmul(jx, jw)) <= FP32_TOL


def test_exchange_predicate_chooses_both_orders():
    """The shapes above take both orders, so the flag is exercised."""
    thin = ch.mxu_matmul_time_us(300, 96, 9) < ch.mxu_matmul_time_us(9, 96,
                                                                     300)
    tall = ch.mxu_matmul_time_us(40, 64, 200) < ch.mxu_matmul_time_us(200,
                                                                      64, 40)
    assert thin != tall


def _record_paths(ctx):
    seen = []
    for name in ("_mxu", "_xla"):
        inner = getattr(ctx, name)

        def rec(*a, _inner=inner, _name=name):
            seen.append(_name)
            return _inner(*a)
        setattr(ctx, name, rec)
    return seen


@pytest.mark.parametrize("threshold", [1, 64, 128, 512])
def test_layer_mxu_threshold_matches_reference(threshold):
    """hetero-layer mode: the same path taken at every M of a sweep, and
    the same product within fp32."""
    ctx = HeteroCtx(mode="hetero-layer", layer_mxu_threshold=threshold)
    ref = RefHeteroCtx(mode="hetero-layer", interpret=True,
                       layer_mxu_threshold=threshold)
    mine, theirs = _record_paths(ctx), _record_paths(ref)
    tw, jw = _pair((64, 160), 4)
    for M in (1, 63, 64, 127, 128, 300):
        tx, jx = _pair((M, 64), M)
        assert _rel(ctx.matmul(tx, tw).numpy(), ref.matmul(jx, jw)) \
            <= FP32_TOL
    assert mine == theirs
    assert mine == ["_mxu" if M >= threshold else "_xla"
                    for M in (1, 63, 64, 127, 128, 300)]


def _synthetic_plans(site, N):
    """The same hand-made decisions in both packages: every strategy."""
    rows = [(5, "xla_only", 0, 0), (7, "pad", 0, 128),
            (128, "mxu_only", 0, 0), (130, "weight", 128, 0),
            (260, "act", 0, 256), (300, "hybrid", 128, 256),
            (1, "weight", 128, 0)]
    plan, ref = PartitionPlan("p", "fast"), RefPlan("p", "fast")
    for M, s, n, b in rows:
        plan.decisions[(site, M)] = Decision(site, M, s, 0.0, n, b)
        ref.decisions[(site, M)] = RefDecision(site, M, s, 0.0, n, b)
    return plan, ref, [r[0] for r in rows]


@pytest.mark.parametrize("stationary", ["output", "weight"])
@pytest.mark.parametrize("order_exchange", [True, False],
                         ids=["exchange", "no-exchange"])
def test_tensor_level_strategies_match_reference(order_exchange,
                                                 stationary):
    """hetero-tensor mode over a plan holding every strategy: the port's
    execute (the CPU runs both halves in order) against the reference's
    with the same decisions, fields and inputs."""
    K, N = 96, 300
    plan, ref_plan, ms = _synthetic_plans("w", N)
    ctx = HeteroCtx(plan=plan, order_exchange=order_exchange,
                    stationary=stationary)
    ref = RefHeteroCtx(plan=ref_plan, interpret=True,
                       order_exchange=order_exchange, stationary=stationary)
    tw, jw = _pair((K, N), 7)
    for M in ms:
        tx, jx = _pair((M, K), 10 + M)
        y = ctx.matmul(tx, tw, name="w")
        assert y.shape == (M, N)
        assert _rel(y.numpy(), ref.matmul(jx, jw, name="w")) <= FP32_TOL, M


@pytest.mark.parametrize("k,lanes", [(1, 1), (2, 4), (4, 1), (4, 4)])
def test_for_verify_resolves_the_references_decision(monkeypatch, k, lanes):
    """A ``for_verify(k, lanes)`` view and the plain context resolve, at
    every site and M = lanes*(k+1), the decision the reference's resolve
    (its VERIFY decision first, then the plain grid)."""
    cfg, ref_cfg = _configs("llama3-8b", False)
    kw = dict(sync_mode="host", verify_ks=VERIFY_KS)
    ctx = build_hetero_ctx(cfg, "hetero-tensor", **kw)
    ref = ref_build_hetero_ctx(ref_cfg, "hetero-tensor", interpret=True,
                               **kw)
    view, ref_view = ctx.for_verify(k, lanes), ref.for_verify(k, lanes)
    assert view.verify_key == ref_view.verify_key == (k, lanes)
    assert ctx.verify_key is None and view.plan is ctx.plan
    seen = {"mine": [], "theirs": []}
    monkeypatch.setattr(HeteroCtx, "execute", lambda self, dec, x2, w:
                        seen["mine"].append(dec.describe()) or x2)
    monkeypatch.setattr(RefHeteroCtx, "execute", lambda self, dec, x2, w:
                        seen["theirs"].append(dec.describe()) or x2)
    M = lanes * (k + 1)
    for site in model_weight_shapes(cfg):
        for c in (view, ctx):
            c._tensor_level(torch.zeros((M, 8)), None, site, M)
        for c in (ref_view, ref):
            c._tensor_level(jnp.zeros((M, 8)), None, site, M, 8)
    assert seen["mine"] == seen["theirs"]
    assert len(seen["mine"]) == 2 * len(model_weight_shapes(cfg))
    assert all("verify[" in d for d in seen["mine"][::2])
