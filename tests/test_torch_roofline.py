"""The port's roofline (roofline/analysis.py) against the reference's
(``repro.roofline.analysis``).

On the same records written to a temporary directory (a full record, a
probe pair with its base, a skipped record, a failed one and a missing
one), the port's ``analyze_cell(..., spec=V5E)`` equals the reference's
field for field and ``markdown_table`` byte for byte; ``model_flops_for``
equals the reference's on every arch x shape. On ``H100`` the collective
term charges NVLink (18 x 25 GB/s) for a group of at most 8 ranks and the
network share of a GPU (50 GB/s) for more; a record of the port's own dry
run (``counted_by: trace``) is read as an exact count.
"""
import json

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref
from repro_torch.core.characteristics import H100, V5E
from repro_torch.roofline import analysis


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(arch, shape, mesh="pod16x16", *, scale=1.0, n_layers=32,
            probe=0):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "probe": probe,
        "kv_mode": "auto", "variant": "", "serve_fsdp": False, "ok": True,
        "probe_seq_scale": scale, "n_layers_used": n_layers,
        "memory": {"argument_size_in_bytes": int(3.1e9 * (1 + probe)),
                   "output_size_in_bytes": int(2.9e9),
                   "alias_size_in_bytes": int(2.8e9),
                   "temp_size_in_bytes": int(7.7e9 + 1e8 * probe)},
        "cost": {"flops": 4.7e14 * (1 + probe), "bytes accessed":
                 2.3e12 * (1 + 0.5 * probe)},
        "collectives": {
            "all-gather": {"count": 867 + probe, "bytes": 9.4e10 + probe,
                           "group": 16},
            "all-reduce": {"count": 503, "bytes": 5.6e10 * (1 + probe),
                           "group": 16},
            "reduce-scatter": {"count": 12, "bytes": 3.0e8, "group": 8},
            "collective-permute": {"count": 4, "bytes": 1.0e7, "group": 2}},
        "lower_s": 1.5, "compile_s": 7.25, "n_devices": 256}


def _write(tmp_path, name, rec):
    (tmp_path / f"{name}.json").write_text(json.dumps(rec))


# (arch, shape) of each case and how its records are written
CASES = ("full", "probe pair", "skipped", "failed", "missing")


@pytest.fixture()
def records(tmp_path):
    _write(tmp_path, "llama3-8b__train_4k__pod16x16",
           _record("llama3-8b", "train_4k"))
    _write(tmp_path, "rwkv6-3b__prefill_32k__pod16x16",
           _record("rwkv6-3b", "prefill_32k"))
    for p in (1, 2):
        _write(tmp_path, f"rwkv6-3b__prefill_32k__pod16x16__probe{p}",
               _record("rwkv6-3b", "prefill_32k", scale=8.0, n_layers=p,
                       probe=p))
    _write(tmp_path, "llama3-8b__long_500k__pod16x16",
           {"arch": "llama3-8b", "shape": "long_500k", "mesh": "pod16x16",
            "skipped": True, "ok": True, "reason":
            "long_500k requires sub-quadratic attention (SSM/hybrid only)"})
    _write(tmp_path, "zamba2-2.7b__decode_32k__pod16x16",
           {"arch": "zamba2-2.7b", "shape": "decode_32k",
            "mesh": "pod16x16", "ok": False,
            "error": "RuntimeError: out of memory"})
    return tmp_path


CELLS = {"full": ("llama3-8b", "train_4k"),
         "probe pair": ("rwkv6-3b", "prefill_32k"),
         "skipped": ("llama3-8b", "long_500k"),
         "failed": ("zamba2-2.7b", "decode_32k"),
         "missing": ("qwen3-1.7b", "decode_32k")}


@pytest.mark.parametrize("case", CASES)
def test_v5e_cell_matches_reference(records, case):
    arch, shape = CELLS[case]
    got = analysis.analyze_cell(arch, shape, out_dir=records, spec=V5E)
    want = ref.analyze_cell(arch, shape, out_dir=records)
    assert vars(got) == vars(want)
    assert got.row() == want.row()


def test_v5e_markdown_table_matches_reference(records):
    got = [analysis.analyze_cell(a, s, out_dir=records, spec=V5E)
           for a, s in CELLS.values()]
    want = [ref.analyze_cell(a, s, out_dir=records) for a, s in
            CELLS.values()]
    assert analysis.markdown_table(got) == ref.markdown_table(want)


@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", list(REF_ARCHS))
def test_model_flops_match_reference(arch, shape):
    assert analysis.model_flops_for(arch, shape) == \
        ref.model_flops_for(arch, shape)


@pytest.mark.parametrize("op", list(analysis.RING_FACTORS))
@pytest.mark.parametrize("group", [1, 2, 8, 16, 256])
def test_h100_collective_term_by_group(op, group):
    coll = {op: {"count": 3, "bytes": 6.4e9, "group": group}}
    f = analysis.RING_FACTORS[op](group)
    rate = 18 * 25e9 if group <= 8 else 50e9
    assert analysis._coll_seconds(coll, H100) == pytest.approx(
        6.4e9 * f / rate, rel=1e-12)
    assert analysis._coll_seconds(coll, V5E) == ref._coll_seconds(coll)


def test_trace_record_is_an_exact_count(tmp_path):
    rec = _record("llama3-8b", "train_4k")
    rec.update(counted_by="trace", shape_spec={
        "seq_len": 4096, "global_batch": 2, "kind": "train"})
    _write(tmp_path, "llama3-8b__train_4k__rank1", {**rec, "n_devices": 1})
    cell = analysis.analyze_cell("llama3-8b", "train_4k", mesh="rank1",
                                 out_dir=tmp_path)
    assert cell.ok and cell.note == "trace"
    assert cell.compute_s == pytest.approx(4.7e14 / H100.peak_flops_bf16)
    assert cell.model_flops == pytest.approx(
        6.0 * analysis.get_config("llama3-8b").n_params_active * 4096 * 2)
    assert cell.roofline_fraction == pytest.approx(
        cell.model_flops / H100.peak_flops_bf16 / cell.bound_time_s)
