#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in the order given.

    python3 scripts/compare_trees.py TREE [TREE ...]

Each TREE is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``);
give them in turns (parent, change, change, parent) so that drift of the
card or its host shows. Each runs in a process of its own, importing only
that tree's ``chip_smoke`` and ``repro_torch``, and prints one JSON line:

- the paged llama3-8b int8 + int8 KV pair of ``chip_smoke.phase_full``:
  the hetero-tensor arm's tok/s, prefill and decode seconds and kernel
  launches (the engine-less arm and the profiled run's top kernels are in
  the ``[full]`` and ``[profile]`` lines written to standard error);
- llama3-8b's single-request engine, hetero-tensor and xla with fast sync;
- the host's cost per wrapper call (a loop of calls timed with
  ``time.perf_counter``, the card left to run behind; the best of three)
  of decode attention, flash attention and the int8 GEMM at path shapes.

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


def one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    import chip_smoke as c
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.hetero_matmul import ops

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
    host = {"decode": _host_us(lambda: decode_attention(q, k, k, n)),
            "flash": _host_us(lambda: flash_attention(qf, kf, kf)),
            "int8": _host_us(lambda: ops.mxu_quant_matmul(x, wq, s))}
    c.FULL_PAIRS = (("int8+kv8", "int8", "int8"),)
    cfg, params = c.full_model()
    paged = c.phase_full(cfg, params)["int8+kv8"]
    engine = c.phase_engine_full(cfg, params,
                                 arms=(("hetero-tensor", True),
                                       ("xla", True)), gates=())
    keep = ("tok_per_s", "prefill_s", "decode_s")
    return {"tree": tree, "host_us_per_call": host,
            "paged_int8_kv8": {key: paged[key]
                               for key in (*keep, "gemm_launches")},
            "engine": {label: {key: arm[key] for key in keep}
                       for label, arm in engine.items()}}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("[compare] " + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        for line in proc.stdout.splitlines():
            if line.startswith("[compare] "):
                print(line[len("[compare] "):], flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
