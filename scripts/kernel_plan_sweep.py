#!/usr/bin/env python3
"""Device time of three of the port's kernels at every launch plan they
take, at the serving path's shapes, on the card.

    python3 scripts/kernel_plan_sweep.py

- the int8 weight GEMM (bf16, ``mxu_quant_matmul``) at each tile width and
  the first four splits of K that ``gemm_splits`` allows, beside the fp GEMM
  (``mxu_matmul`` on the dequantized bf16 weight) at the same plan and
  ``torch.matmul``'s bf16 product, at w_gate's (256, 4096, 8960) and wq's
  (128, 4096, 2560) aligned blocks and at a shape of exactly 132 tiles;
- split-KV decode attention at each split count up to the largest the
  cache allows, at llama3-8b's and zamba2-2.7b's decode shapes, beside
  SDPA, with the split pass and the combine timed apart;
- the SSD chunk at zamba2-2.7b's L = 256 and 88 with 10, 20, 40 and 80
  heads (its grid is one block per head and row tile, plus one for the
  state): how the time of the grid compares with that of a block whose SM
  it shares with no other, with C.B^T and the chunk kernel timed apart.

Each GEMM row has CUDA events time over 200 back-to-back calls
(``ms``: device-bound at these sizes, the host's ~40 µs a call being
shorter) and torch.profiler's device time (``device_ms``), which drops
events now and then and reads low when it does; decode rows give the
profiler's time per kernel. Prints one JSON line per row; needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402

GEMM_SHAPES = ((256, 4096, 8960), (128, 4096, 2560), (128, 4096, 128 * 132))
DECODE_SHAPES = ((32, 8, 128, 324, 301), (32, 32, 80, 616, 601))


def _by_kernel(fn, iters: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches, in µs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {_kernel_name(e.key): getattr(e, "self_device_time_total", 0.0)
            / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _kernel_name(key: str) -> str:
    """``decode_split`` of ``void (anonymous namespace)::decode_split<...>
    (...)``."""
    return key.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("<")[0].split("(")[0]


def gemm_rows(g):
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import quant_matmul_ref
    for M, K, N in GEMM_SHAPES:
        x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
        wq, s = ops.quantize_weight(torch.randn((K, N), generator=g,
                                                device="cuda"))
        w = (wq.float() * s).bfloat16()
        ref = quant_matmul_ref(x, wq, s)
        base = {"shape": [M, K, N], "plan": list(ops.gemm_plan(M, N, K)),
                "matmul_bf16_ms": chip_smoke.cuda_time_ms(
                    lambda: torch.matmul(x, w), iters=200)}
        for bn in ops.TILE_NS:
            for split in ops.gemm_splits(K)[:4]:
                plan = (128, bn, split)
                y = ops.mxu_quant_matmul(x, wq, s, plan=plan)
                row = {**base, "kernel": "quant_matmul_int8",
                       "forced_plan": list(plan),
                       "blocks": M // 128 * (N // bn) * split,
                       "rel_err": chip_smoke.rel_err(y, ref),
                       "ms": chip_smoke.cuda_time_ms(
                           lambda: ops.mxu_quant_matmul(x, wq, s, plan=plan),
                           iters=200),
                       "device_ms": chip_smoke.device_ms(
                           lambda: ops.mxu_quant_matmul(x, wq, s,
                                                        plan=plan)),
                       "fp_gemm_ms": chip_smoke.cuda_time_ms(
                           lambda: ops.mxu_matmul(x, w, plan=plan),
                           iters=200)}
                print(json.dumps(row), flush=True)


def decode_rows(g):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_split_plan,
                                                          max_decode_split)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    for Hq, Hkv, D, S, L in DECODE_SHAPES:
        q = torch.randn((1, Hq, D), generator=g, device="cuda").bfloat16()
        k = torch.randn((1, S, Hkv, D), generator=g, device="cuda").bfloat16()
        v = torch.randn((1, S, Hkv, D), generator=g, device="cuda").bfloat16()
        n = torch.full((1,), L, dtype=torch.int32, device="cuda")
        ref = decode_attention_ref(q, k, v, n)
        qt = q[:, :, None, :].contiguous()
        kt, vt = (t[:, :L].transpose(1, 2).contiguous() for t in (k, v))
        sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True))
        plan = decode_split_plan(1, Hkv, S)
        for n_split in range(1, max_decode_split(S) + 1):
            run = lambda: decode_attention(q, k, v, n,           # noqa: E731
                                           n_split=n_split)
            row = {"kernel": "decode_attention", "shape": [Hq, Hkv, D, S, L],
                   "n_split": n_split, "plan": plan,
                   "blocks": Hkv * n_split,
                   "rel_err": chip_smoke.rel_err(run(), ref),
                   "device_ms": chip_smoke.device_ms(run),
                   "by_kernel_us": _by_kernel(run),
                   "sdpa_device_ms": sdpa}
            print(json.dumps(row), flush=True)


def ssd_rows(g):
    from repro_torch.kernels.ssm_scan.ops import ssd_chunk
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref
    for L in (256, 88):
        for nh in (10, 20, 40, 80):
            args = chip_smoke._ssd_inputs(g, 1, L, nh, 64, 64, "bfloat16",
                                          True, 5248)
            y, s = ssd_chunk(*args)
            y_ref, s_ref = ssd_chunk_ref(*args)
            run = lambda: ssd_chunk(*args)                        # noqa: E731
            row = {"kernel": "ssd_chunk", "shape": [1, L, nh, 64, 64],
                   "blocks": nh * (-(-L // 64) + 1),
                   "rel_err": max(chip_smoke.rel_err(y, y_ref),
                                  chip_smoke.rel_err(s, s_ref)),
                   "ms": chip_smoke.cuda_time_ms(run, iters=200),
                   "device_ms": chip_smoke.device_ms(run),
                   "by_kernel_us": _by_kernel(run),
                   **chip_smoke._ssd_bound(1, L, nh, 64, 64)}
            print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_plan_sweep: CUDA is not available", file=sys.stderr)
        return 2
    chip_smoke.phase_card_and_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    gemm_rows(g)
    decode_rows(g)
    ssd_rows(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
