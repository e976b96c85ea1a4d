"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell on
one rank of the production mesh, the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell on 256 / 512 placeholder
devices and reads XLA's analyses. The port runs one process a rank, so a
cell is this rank's step (``launch/steps.py::make_step_and_specs``) over
a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: its collectives move
nothing), called once on fake tensors of each ``ExampleArg``'s local shape
(``FakeTensorMode``: nothing allocated, no kernel launched) under
``roofline/count.py``'s count. The kernels trace as their operators'
fake implementations with their work from ``kernels/work.py``, the
card's route, not their plain versions. The fake tensors are CUDA tensors
where this PyTorch has CUDA; on a CPU-only build they are CPU tensors
(a fake CUDA tensor that autograd must accumulate into aborts such a
build), which trace the same operators: the wrappers send a fake tensor of
either device to the kernel's operator.

Per cell this writes a JSON record with the reference's keys where their
meaning carries:
  - ``memory``: argument / output / alias / temp bytes of the rank
    (``temp_size_in_bytes`` is the peak of live storage less the
    arguments, the result included; the roofline's per-chip sum counts a
    result that is not an argument updated in place twice);
  - ``cost``: ``flops`` and ``bytes accessed`` of the rank (an eager count
    of every layer: the scan undercount the reference's probes correct
    does not arise here; ``--probe N`` still cuts the depth to N units);
  - ``collectives``: ``{op: {count, bytes, group}}`` under HLO names;
  - ``lower_s``: the trace's time on the injected clock (``serving/
    telemetry.py``: ``MonotonicClock``, ``FakeClock`` under test).
Keys without a counterpart: ``compile_s`` and ``hlo_bytes`` (nothing is
compiled) are not written; the port adds ``kernel_calls`` (calls per
kernel operator), ``counted_by`` ("trace"), ``shape_spec`` and
``trace_device``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
         [--multipod] [--probe 0|1|2] [--kv-mode auto|head|seq]
         [--out artifacts/dryrun_torch]
  python -m repro_torch.launch.dryrun --all [--multipod]
"""
import argparse
import dataclasses
import json
import sys
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist


def _probe_cfg(cfg, n_units: int):
    """Reduce depth to n_units 'repeating units' (layers, or zamba periods)."""
    if cfg.ssm is not None:
        return cfg.with_(n_layers=n_units * cfg.ssm.attn_every)
    return cfg.with_(n_layers=n_units)


def _probe_shape(cfg, shape):
    """Cap probe sequence length for chunked-recurrence archs (rwkv) whose
    unrolled chunk loops would blow up HLO size; costs are linear in S and
    are rescaled by the roofline (field ``probe_seq_scale``)."""
    if shape.kind == "decode":
        return shape, 1.0
    # rwkv is strictly token-linear (attention-free) -> exact rescale.
    # zamba: capped at 8192 (the reference's compile-time cap, kept so the
    # probe pair means the same); the (1/attn_every of layers)
    # shared-attention quadratic component is underestimated by the
    # linear rescale.
    cap = 4096 if cfg.rwkv is not None else (8192 if cfg.ssm is not None
                                             else None)
    if cap and shape.seq_len > cap:
        scale = shape.seq_len / cap
        return dataclasses.replace(shape, seq_len=cap), scale
    return shape, 1.0


def trace_device() -> str:
    """The fake tensors' device: the card's where this PyTorch has CUDA
    (see the module's docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_args(example_args, device: str):
    """Each ``ExampleArg`` of the tree as a tensor of its local shape on
    ``device``; call it under a ``FakeTensorMode``."""
    from .steps import ExampleArg
    if isinstance(example_args, ExampleArg):
        return torch.empty(example_args.local_shape,
                           dtype=example_args.dtype, device=device)
    if isinstance(example_args, dict):
        return {k: fake_args(v, device) for k, v in example_args.items()}
    if isinstance(example_args, (list, tuple)):
        return type(example_args)(fake_args(v, device)
                                  for v in example_args)
    return example_args


def trace_call(step, example_args, *, device: str | None = None,
               clock=None) -> dict:
    """``step`` called once on fake tensors of ``example_args``' local
    shapes, counted (``roofline/count.py``): the record's ``cost``,
    ``collectives``, ``memory``, ``kernel_calls``, ``kernel_flops``,
    ``lower_s`` and ``trace_device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..roofline.count import count_call
    from ..serving.telemetry import MonotonicClock
    clock = clock if clock is not None else MonotonicClock()
    device = device or trace_device()
    t0 = clock.now()
    with FakeTensorMode():
        _, rec = count_call(step, *fake_args(example_args, device))
    rec["lower_s"] = round(clock.now() - t0, 2)
    rec["trace_device"] = device
    return rec


def trace_step(cfg, mesh, shape, *, kv_mode: str = "auto",
               seq_shard: bool = True, serve_fsdp: bool = False,
               device: str | None = None, clock=None) -> dict:
    """The cell's step (``make_step_and_specs``) on this rank of ``mesh``
    (over a fake process group, or a real one of one rank), traced by
    :func:`trace_call`; adds ``n_devices``."""
    from .steps import make_step_and_specs
    step, args, _ = make_step_and_specs(cfg, mesh, shape, kv_mode=kv_mode,
                                        seq_shard=seq_shard,
                                        serve_fsdp=serve_fsdp)
    rec = trace_call(step, args, device=device, clock=clock)
    rec["n_devices"] = mesh.size()
    return rec


@contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process rank 0) for
    the block, unless a group is up already (then that one)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             probe: int = 0, kv_mode: str = "auto", seq_shard: bool = True,
             serve_fsdp: bool = False, variant: str = "",
             out_dir: str = "artifacts/dryrun_torch", clock=None) -> dict:
    from ..configs import SHAPES, cell_is_supported, get_config
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}" + (f"__probe{probe}" if probe else "")
    if variant:
        cell += f"__{variant}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "probe": probe, "kv_mode": kv_mode, "variant": variant,
           "serve_fsdp": serve_fsdp, "ok": False}

    ok, reason = cell_is_supported(cfg, shape)
    if not ok:
        rec.update(skipped=True, reason=reason, ok=True)
        return _save(rec, cell, out_dir)

    probe_scale = 1.0
    if probe:
        cfg = _probe_cfg(cfg, probe)
        shape, probe_scale = _probe_shape(cfg, shape)
    rec["probe_seq_scale"] = probe_scale
    rec["n_layers_used"] = cfg.n_layers

    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            rec.update(trace_step(cfg, mesh, shape, kv_mode=kv_mode,
                                  seq_shard=seq_shard, serve_fsdp=serve_fsdp,
                                  clock=clock))
        rec["counted_by"] = "trace"
        rec["shape_spec"] = {"seq_len": shape.seq_len,
                             "global_batch": shape.global_batch,
                             "kind": shape.kind}
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _save(rec, cell, out_dir)


def _save(rec: dict, cell: str, out_dir: str) -> dict:
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    status = "OK" if rec.get("ok") else "FAIL"
    if rec.get("skipped"):
        status = "SKIP"
    print(f"[dryrun] {cell}: {status}"
          + (f" trace={rec.get('lower_s')}s" if rec.get("ok") and not rec.get("skipped") else "")
          + (f" reason={rec.get('reason', rec.get('error', ''))[:120]}"
             if status != "OK" else ""))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--probe", type=int, default=0)
    ap.add_argument("--kv-mode", default="auto")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--serve-fsdp", action="store_true",
                    help="legacy: FSDP-shard weights in serving too "
                         "(the pre-i1 baseline)")
    ap.add_argument("--variant", default="",
                    help="artifact suffix for perf-iteration records")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import ASSIGNED_ARCHS, SHAPES
        rc = 0
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                r = run_cell(arch, shape, multi_pod=args.multipod,
                             kv_mode=args.kv_mode, out_dir=args.out)
                rc |= 0 if r.get("ok") else 1
        sys.exit(rc)

    r = run_cell(args.arch, args.shape, multi_pod=args.multipod,
                 probe=args.probe, kv_mode=args.kv_mode,
                 seq_shard=not args.no_seq_shard,
                 serve_fsdp=args.serve_fsdp, variant=args.variant,
                 out_dir=args.out)
    sys.exit(0 if r.get("ok") else 1)


if __name__ == "__main__":
    main()
