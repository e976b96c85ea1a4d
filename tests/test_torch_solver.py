"""The port's configs, cost model and solver against the reference: the
same configuration fields, and the same plan, decision for decision."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro.core.engine import build_plan as ref_build_plan
from repro_torch import configs
from repro_torch.core.engine import build_plan
from repro_torch.core.solver import PartitionPlan

ARCHS = configs.ARCHS


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, smoke):
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (configs.get_config, ref_configs.get_config))
    cfg, ref = get(arch), ref_get(arch)
    for f in dataclasses.fields(cfg):
        if f.name == "ssm" and ref.ssm is not None:
            continue          # two classes of one shape: compared below
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    # the port covers the dense decoder-only family and the Mamba2 hybrid,
    # whose SSMConfig equals the reference's field by field
    if ref.family == "hybrid":
        assert cfg.ssm is not None
        for f in dataclasses.fields(ref.ssm):
            assert getattr(cfg.ssm, f.name) == getattr(ref.ssm, f.name), \
                f"ssm.{f.name}"
        assert {f.name for f in dataclasses.fields(cfg.ssm)} == \
            {f.name for f in dataclasses.fields(ref.ssm)}
    else:
        assert ref.family == "dense" and ref.ssm is None
    assert ref.moe is None and ref.rwkv is None and not ref.encoder_only
    assert cfg.head_dim == ref.head_dim
    assert cfg.n_params == ref.n_params


def _plan_key(plan):
    return {k: (d.strategy, d.n_split, d.m_bucket)
            for k, d in plan.decisions.items()}


@pytest.mark.parametrize("sync_mode", ["fast", "host"])
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_build_plan_matches_reference(smoke, sync_mode):
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (configs.get_config, ref_configs.get_config))
    cfg, ref = get("llama3-8b"), ref_get("llama3-8b")
    if smoke:
        cfg = cfg.with_(param_dtype="float32", compute_dtype="float32")
        ref = ref.with_(param_dtype="float32", compute_dtype="float32")
    table, plan = build_plan(cfg, sync_mode=sync_mode)
    ref_table, ref_plan = ref_build_plan(ref, sync_mode=sync_mode)
    assert table.sites == ref_table.sites
    assert _plan_key(plan) == _plan_key(ref_plan)
    for k, d in plan.decisions.items():
        assert d.t_us == pytest.approx(ref_plan.decisions[k].t_us, rel=1e-12)


def test_llama3_8b_plan_sends_prefill_to_the_aligned_path():
    """The slice's premise: at every prefill M up to 256 all eight sites of
    llama3-8b split by weight, so every prefill chunk launches the GEMM."""
    _, plan = build_plan(configs.get_config("llama3-8b"))
    for M in (64, 128, 192, 256):
        for site in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "head"):
            d = plan.decision(site, M)
            assert d.strategy == "weight" and 0 < d.n_split, (site, M, d)
            assert d.n_split % 128 == 0
    assert plan.decision("w_gate", 256).n_split == 7168
    assert plan.decision("head", 256).n_split == 64128


def test_plan_save_load_round_trip(tmp_path):
    _, plan = build_plan(configs.get_smoke_config("llama3-8b"))
    path = tmp_path / "plan.json"
    plan.save(path)
    back = PartitionPlan.load(path)
    assert back.arch == plan.arch and back.sync_mode == plan.sync_mode
    assert back.decisions == plan.decisions


def test_lookup_nearest_m_fallback():
    _, plan = build_plan(configs.get_config("llama3-8b"))
    assert plan.lookup("wq", 256) is plan.decision("wq", 256)
    assert plan.lookup("wq", 250) is plan.decision("wq", 256)
    assert plan.lookup("wq", 40) is plan.decision("wq", 64)
    assert plan.lookup("nonexistent", 64) is None
