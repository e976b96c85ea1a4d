"""The port's dry run (launch/dryrun.py) and its count
(roofline/count.py).

* ``_probe_cfg`` and ``_probe_shape`` equal the reference's on every arch x
  shape; ``run_cell`` on every unsupported cell writes the reference's
  skipped record (reason, ok, skipped, arch, shape, mesh).
* ROADMAP M11b's check: on a fake 2 x 2 mesh the dry run of a llama3 smoke
  train and decode cell and of a zamba2 smoke train cell counts the
  collectives (op, count, bytes, group), FLOPs and kernel calls that a
  real four-rank gloo CPU run of the same step counts (ranks:
  tests/torch_roofline_ranks.py, spawned once).
* Depth: on a dense smoke config, ``probe1 + (units - 1) * (probe2 -
  probe1)`` equals the full-depth count of FLOPs and bytes exactly (an
  eager trace counts every layer).
* One production cell, llama3-8b ``train_4k`` on 16 x 16 (a fake group of
  256 ranks): it traces, and its FLOPs hold the flash kernels' by
  ``kernels/work.py``'s formula.
* A fake CUDA trace of every wrapper leaves each ``.launches`` as it was.
"""
import json
import os

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_roofline_ranks as ranks
from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro_torch.configs import SHAPES, cell_is_supported, get_config
from repro_torch.kernels import work
from repro_torch.kernels.build import COUNTED
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.hetero_matmul.ops import (mxu_matmul, mxu_q4_matmul,
                                                   mxu_quant_matmul)
from repro_torch.kernels.ssm_scan.ops import ssd_chunk, ssd_chunk_bwd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.serving.telemetry import FakeClock

jax.devices()                        # the backend is up before the import
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

CELLS = [(a, s) for a in REF_ARCHS for s in REF_SHAPES]
UNSUPPORTED = [(a, s) for a, s in CELLS
               if not cell_is_supported(get_config(a), SHAPES[s])[0]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size steps gain nothing from intra-op threads, and the suite's
    workers share the machine's cores (each rank sets its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real_counts():
    return spawn_ranks(ranks.counted_steps_rank, 4, device="cpu")[0]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_probes_match_reference(arch, shape):
    for n in (1, 2):
        got = dryrun._probe_cfg(get_config(arch), n)
        want = ref_dryrun._probe_cfg(ref_get_config(arch), n)
        assert got.n_layers == want.n_layers
        pshape, scale = dryrun._probe_shape(got, SHAPES[shape])
        wshape, wscale = ref_dryrun._probe_shape(want, REF_SHAPES[shape])
        assert (pshape.seq_len, pshape.global_batch, pshape.kind, scale) \
            == (wshape.seq_len, wshape.global_batch, wshape.kind, wscale)


@pytest.mark.parametrize("arch,shape", UNSUPPORTED)
def test_unsupported_cell_writes_reference_record(tmp_path, arch, shape):
    got = dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "port"))
    want = ref_dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "ref"))
    keys = ("reason", "ok", "skipped", "arch", "shape", "mesh")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    name = f"{arch}__{shape}__pod16x16.json"
    on_disk = json.loads((tmp_path / "port" / name).read_text())
    assert on_disk == got and got["skipped"] and got["ok"]


@pytest.mark.parametrize("case", ranks.COUNT_CASES, ids=lambda c: c[0])
def test_fake_mesh_counts_a_real_gloo_run(real_counts, case):
    name, arch, kind, kv_mode = case
    with dryrun.fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        rec = dryrun.trace_step(ranks.smoke_fp32(arch), mesh,
                                ranks.count_shape(kind), kv_mode=kv_mode,
                                clock=FakeClock())
    real = real_counts[name]
    assert rec["collectives"] == real["collectives"]
    assert rec["collectives"]            # the 2 x 2 step communicates
    assert rec["cost"]["flops"] == real["cost"]["flops"] > 0
    assert rec["kernel_calls"] == real["kernel_calls"]
    assert rec["kernel_calls"]           # the kernels traced as operators
    assert rec["n_devices"] == 4 and rec["lower_s"] == 0.0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_pair_recovers_full_depth(kind):
    cfg = ranks.smoke_fp32("llama3-8b").with_(n_layers=5)
    shape = ranks.count_shape(kind)
    with dryrun.fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        p1, p2, full = (dryrun.trace_step(c, mesh, shape)["cost"] for c in (
            dryrun._probe_cfg(cfg, 1), dryrun._probe_cfg(cfg, 2), cfg))
    for key in ("flops", "bytes accessed"):
        assert p1[key] + (cfg.n_layers - 1) * (p2[key] - p1[key]) \
            == full[key], key
        assert p2[key] > p1[key]


def test_production_cell_traces(tmp_path):
    rec = dryrun.run_cell("llama3-8b", "train_4k", out_dir=str(tmp_path),
                          clock=FakeClock())
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == 256 and rec["counted_by"] == "trace"
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    # 8 kv heads do not divide the model axis of 16: every model rank runs
    # attention whole, over its 16 sequences of 4096 (with remat: the
    # forward twice a layer, with its log-sum-exp, the backward once)
    cfg = get_config("llama3-8b")
    L, args = cfg.n_layers, (16, 4096, 4096, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, 2, True)
    assert rec["kernel_calls"] == {"flash_attention": 2 * L,
                                   "flash_attention_bwd": L}
    fwd = work.flash(*args, lse=True)[0]
    bwd = work.flash_bwd(*args)[0]
    assert rec["kernel_flops"] == {"flash_attention": 2 * L * fwd,
                                   "flash_attention_bwd": L * bwd}
    assert rec["cost"]["flops"] > 2 * L * fwd + L * bwd
    assert json.loads((tmp_path / "llama3-8b__train_4k__pod16x16.json")
                      .read_text())["cost"] == rec["cost"]


def test_fake_cuda_trace_launches_nothing():
    before = {w.__name__: w.launches for w in COUNTED}
    bf = dict(dtype=torch.bfloat16, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    with FakeTensorMode():
        x, w = torch.empty((256, 512), **bf), torch.empty((512, 384), **bf)
        wq = torch.empty((512, 384), dtype=torch.int8, device="cuda")
        wq4 = torch.empty((256, 384), dtype=torch.int8, device="cuda")
        scale = torch.empty((384,), **f32)
        assert mxu_matmul(x, w).shape == (256, 384)
        assert mxu_quant_matmul(x, wq, scale).shape == (256, 384)
        assert mxu_q4_matmul(x, wq4, scale).shape == (256, 384)
        q, k = torch.empty((2, 64, 8, 128), **bf), torch.empty(
            (2, 64, 2, 128), **bf)
        o = flash_attention(q, k, k)
        assert o.shape == q.shape and o.device.type == "cuda"
        lse = torch.empty((2, 8, 64), **f32)
        assert [t.shape for t in flash_attention_bwd(q, k, k, o, lse, o)] \
            == [q.shape, k.shape, k.shape]
        n = torch.empty((1,), dtype=torch.int32, device="cuda")
        q1 = torch.empty((2, 8, 128), **bf)
        assert decode_attention(q1, k, k, n).shape == q1.shape
        xb, B_ = torch.empty((1, 64, 4, 16), **f32), torch.empty(
            (1, 64, 16), **f32)
        seg, S = torch.empty((1, 64, 4), **f32), torch.empty((1, 4, 16, 16),
                                                            **f32)
        y, S_new = ssd_chunk(xb, B_, B_, seg, S)
        assert (y.shape, S_new.shape) == (xb.shape, S.shape)
        assert len(ssd_chunk_bwd(xb, B_, B_, seg, S, y, S_new)) == 5
    assert {w.__name__: w.launches for w in COUNTED} == before
