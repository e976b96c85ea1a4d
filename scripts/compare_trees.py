#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in the order given.

    python3 scripts/compare_trees.py [--host-only] TREE [TREE ...]

Each TREE is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``);
give them in turns (parent, change, change, parent) so that drift of the
card or its host shows. Each runs in a process of its own, importing only
that tree's ``chip_smoke`` and ``repro_torch``, and prints one JSON line:

- the paged llama3-8b int8 + int8 KV and W4A16 pairs of
  ``chip_smoke.phase_full``: the hetero-tensor arm's tok/s, prefill and
  decode seconds and kernel launches (the engine-less arm and the profiled
  run's top kernels are in the ``[full]`` and ``[profile]`` lines written
  to standard error);
- llama3-8b's single-request engine, hetero-tensor and xla with fast sync;
- the host's cost per wrapper call (a loop of calls timed with
  ``time.perf_counter``, the card left to run behind; the best of three)
  of decode attention, flash attention, the int8 and W4A16 GEMMs, the SSD
  chunk at path shapes and the fp GEMM at w_gate's (256, 4096, 7168) (the
  SSD and fp GEMM loops kept short enough that the launch queue never
  fills and makes the host wait for the card);
- the device time (torch.profiler) and CUDA-events time per call of the
  int8 and W4A16 GEMMs at w_gate's (256, 4096, 8960) block and of the SSD
  chunk at zamba2-2.7b's L = 256.

With ``--host-only``, each tree measures the host's cost per wrapper
call and llama3-8b's single-request engine (hetero-tensor and xla, fast
sync) only (a few minutes for four trees).

Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _host_us(fn, iters: int = 2000) -> float:
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()  # repolint: disable=determinism -- the host's wall time per call is what this measures
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()  # repolint: disable=determinism -- the host's wall time per call is what this measures
        best = min(best, (t1 - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return best


def one(tree: str, host_only: bool = False) -> dict:
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    import chip_smoke as c
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.ssm_scan.ops import ssd_chunk

    assert c.__file__.startswith(tree), c.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    c.phase_card_and_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 32, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, 324, 8, 128), generator=g, device="cuda").bfloat16()
    n = torch.full((1,), 301, dtype=torch.int32, device="cuda")
    qf = torch.randn((1, 44, 32, 128), generator=g, device="cuda").bfloat16()
    kf = torch.randn((1, 300, 8, 128), generator=g, device="cuda").bfloat16()
    x = torch.randn((128, 4096), generator=g, device="cuda").bfloat16()
    wq, s = ops.quantize_weight(torch.randn((4096, 2560), generator=g,
                                            device="cuda"))
    wq4, s4 = ops.quantize_weight_int4(torch.randn((4096, 2560), generator=g,
                                                   device="cuda"))
    ssd = c._ssd_inputs(g, 1, 256, 80, 64, 64, "bfloat16", True, 5248)
    host = {"decode": _host_us(lambda: decode_attention(q, k, k, n)),
            "flash": _host_us(lambda: flash_attention(qf, kf, kf)),
            "int8": _host_us(lambda: ops.mxu_quant_matmul(x, wq, s)),
            "w4a16": _host_us(lambda: ops.mxu_q4_matmul(x, wq4, s4)),
            "ssd": _host_us(lambda: ssd_chunk(*ssd), iters=200)}
    xg = torch.randn((256, 4096), generator=g, device="cuda").bfloat16()
    wg = torch.randn((4096, 7168), generator=g, device="cuda").bfloat16()
    host["fp_wgate"] = _host_us(lambda: ops.mxu_matmul(xg, wg), iters=200)
    keep = ("tok_per_s", "prefill_s", "decode_s")
    if host_only:
        cfg, params = c.full_model()
        engine = c.phase_engine_full(cfg, params, None,
                                     arms=(("hetero-tensor", True),
                                           ("xla", True)), gates=())
        return {"tree": tree, "host_us_per_call": host,
                "engine": {label: {key: arm[key] for key in keep}
                           for label, arm in engine.items()}}
    w_full = torch.randn((4096, 14336), generator=g, device="cuda")
    q8, s8 = ops.quantize_weight(w_full)
    q4, s4g = ops.quantize_weight_int4(w_full)
    runs = {"int8_wgate": lambda: ops.mxu_quant_matmul(xg, q8[:, :8960],
                                                       s8[:8960]),
            "w4a16_wgate": lambda: ops.mxu_q4_matmul(xg, q4[:, :8960],
                                                     s4g[:8960]),
            "ssd_l256": lambda: ssd_chunk(*ssd)}
    kernels = {name: {"device_ms": c.device_ms(run),
                      "ms": c.cuda_time_ms(run)} for name, run in runs.items()}
    c.FULL_PAIRS = (("int8+kv8", "int8", "int8"), ("w4a16", "w4a16", None))
    cfg, params = c.full_model()
    paged = c.phase_full(cfg, params)
    engine = c.phase_engine_full(cfg, params, None,
                                 arms=(("hetero-tensor", True),
                                       ("xla", True)), gates=())
    return {"tree": tree, "host_us_per_call": host, "kernels": kernels,
            **{f"paged_{label}": {key: arm[key]
                                  for key in (*keep, "gemm_launches")}
               for label, arm in paged.items()},
            "engine": {label: {key: arm[key] for key in keep}
                       for label, arm in engine.items()}}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("[compare] " + json.dumps(one(sys.argv[2], sys.argv[3:] == [
            "--host-only"])), flush=True)
        return 0
    flags = [a for a in sys.argv[1:] if a == "--host-only"]
    trees = [a for a in sys.argv[1:] if a != "--host-only"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", tree,
                               *flags], capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        for line in proc.stdout.splitlines():
            if line.startswith("[compare] "):
                print(line[len("[compare] "):], flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
