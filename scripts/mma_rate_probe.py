#!/usr/bin/env python3
"""The rate of ``mma.sync`` on the card, the ceiling of the SSD chunk
backward's split-fp32 products (``ssd_bwd_tc`` in ``csrc/ssd_chunk.cu``
issues ``mma.sync`` m16n8k8 TF32, three a split product).

    python3 scripts/mma_rate_probe.py

Prints one JSON line: the throughput (TFLOP/s) of ``mma.sync`` m16n8k8
TF32 and m16n8k16 bf16 from a kernel in which every warp issues
independent products on registers (eight accumulators a warp, 4 or 8
blocks of 256 threads an SM), timed by CUDA events on the second of two
launches. Needs one CUDA card and nvcc; builds under ``build/probe/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "build" / "probe"

MMA_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <bool TF32>
__global__ void mma_loop(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                     "{%0, %1, %2, %3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                       "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                       "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                     "{%0, %1, %2, %3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                       "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                       "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int tf32, float* out, int blocks, int iters, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (tf32) mma_loop<true><<<blocks, 256>>>(out, iters);
    else mma_loop<false><<<blocks, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  return (int)cudaGetLastError();
}
'''


def _nvcc() -> str:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build
    return build._nvcc()


def mma_rates() -> dict:
    import torch
    PROBE.mkdir(parents=True, exist_ok=True)
    (PROBE / "mma.cu").write_text(MMA_SRC)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(PROBE / "libmma.so"), str(PROBE / "mma.cu")],
                   check=True)
    lib = ctypes.CDLL(str(PROBE / "libmma.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    ms = ctypes.c_float()
    rates = {}
    for tf32, name, flop in ((1, "tf32_m16n8k8", 16 * 8 * 8 * 2),
                             (0, "bf16_m16n8k16", 16 * 8 * 16 * 2)):
        for per_sm in (4, 8):
            iters = 4096
            assert lib.run(tf32, ctypes.c_void_p(out.data_ptr()),
                           sms * per_sm, iters, ctypes.byref(ms)) == 0
            n = sms * per_sm * 8 * iters * 8       # warps x iters x 8 mma
            rates[f"{name} {per_sm} blocks an SM"] = n * flop / ms.value / 1e9
    return {"probe": "mma", "tflop_s": rates,
            "card": torch.cuda.get_device_name(0)}


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        print("mma_rate_probe: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(mma_rates()), flush=True)
