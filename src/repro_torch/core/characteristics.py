"""The reference's TPU cost model, copied verbatim for the solver.

THESE CONSTANTS DESCRIBE A TPU v5e, NOT THE H100 THIS PORT RUNS ON. They are
``repro.core.characteristics`` (the paper's §3 characteristics ported to
TPU v5e), kept unchanged on purpose: with the same cost model the solver
makes the same decisions as the JAX package, so the aligned-path kernel is
launched on exactly the sites where the reference launches it. None of
these numbers was measured on the card. An H100 spec and a measured
latency table replace them in a later slice.

Two execution paths with qualitatively different cost models:

  * MXU path (aligned; the paper's NPU): weight-stationary systolic model
    with 128-lane stage padding (NPU-1), order sensitivity (NPU-2) and
    shape sensitivity (NPU-3).
  * XLA path (flexible; the paper's GPU): linear in FLOPs at a lower
    effective peak plus a fixed kernel overhead (GPU-1), and a large
    host-sync cost when the host blocks per kernel (GPU-2).
  * Memory-1: one engine's streams reach only a fraction of peak bandwidth;
    two concurrent engines aggregate closer to peak.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TPUSpec:
    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12      # per chip
    hbm_bw: float = 819e9                # B/s
    ici_bw: float = 50e9                 # B/s per link
    ici_links: int = 4                   # 2D torus (v5e)
    vmem_bytes: int = 64 * 2 ** 20       # usable VMEM budget (conservative)
    mxu_tile: int = 128                  # systolic array edge
    n_mxu: int = 4
    dispatch_us: float = 50.0            # host->device dispatch+sync latency
    device_sync_us: float = 1.0          # on-device inter-step latency
    # Memory-1: achievable HBM fraction by concurrent stream count
    bw_frac_single: float = 0.62         # one engine (paper: 40-45/68 GB/s)
    bw_frac_dual: float = 0.90           # two engines  (paper: ~60/68 GB/s)
    # XLA-path effective compute efficiency on arbitrary shapes
    xla_eff: float = 0.45
    xla_kernel_overhead_us: float = 3.0

    @property
    def clock_hz(self) -> float:
        # peak = 2 * tile^2 * n_mxu * clock
        return self.peak_flops_bf16 / (2 * self.mxu_tile ** 2 * self.n_mxu)


V5E = TPUSpec()


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mxu_matmul_parts(M: int, K: int, N: int, spec: TPUSpec = V5E,
                     *, bytes_per_el: int = 2,
                     w_bytes_per_el: float | None = None) -> tuple[float, int]:
    """(compute_us, hbm_bytes) for x[M,K] @ w[K,N] on the MXU path
    (weight-stationary systolic model): per (k,n) weight tile one pipeline
    refill plus ceil(M/128) row streams."""
    if w_bytes_per_el is None:
        w_bytes_per_el = bytes_per_el
    t = spec.mxu_tile
    tm, tk, tn = _ceil(M, t), _ceil(K, t), _ceil(N, t)
    reload_cycles = t                       # systolic pipeline refill per tile
    compute_cycles = tk * tn * (reload_cycles + tm * t) / spec.n_mxu
    compute_us = compute_cycles / spec.clock_hz * 1e6
    w_bytes = K * N * w_bytes_per_el
    x_bytes = M * K * bytes_per_el
    o_bytes = M * N * bytes_per_el
    reload_factor = 1.0 if w_bytes + x_bytes < spec.vmem_bytes else \
        max(1.0, tm / 8)                   # streaming reloads when oversized
    nbytes = int(x_bytes + w_bytes * min(reload_factor, 4.0) + o_bytes)
    return compute_us, nbytes


def xla_matmul_parts(M: int, K: int, N: int, spec: TPUSpec = V5E,
                     *, bytes_per_el: int = 2,
                     w_bytes_per_el: float | None = None) -> tuple[float, int]:
    """(compute_us incl. kernel overhead, hbm_bytes) for the flexible path:
    linear in FLOPs (GPU-1) at a lower effective peak, any shape."""
    if w_bytes_per_el is None:
        w_bytes_per_el = bytes_per_el
    flops = 2.0 * M * K * N
    nbytes = (M * K + M * N) * bytes_per_el + K * N * w_bytes_per_el
    compute_us = flops / (spec.peak_flops_bf16 * spec.xla_eff) * 1e6 \
        + spec.xla_kernel_overhead_us
    return compute_us, int(nbytes)


def combine_single(parts: tuple[float, int], spec: TPUSpec = V5E) -> float:
    """Latency of one path running alone (single-stream bandwidth)."""
    c, b = parts
    return max(c, b / (spec.hbm_bw * spec.bw_frac_single) * 1e6)


def combine_dual(parts_a: tuple[float, int], parts_b: tuple[float, int],
                 spec: TPUSpec = V5E) -> float:
    """Latency of two concurrent paths sharing the aggregated-bandwidth pool
    (Memory-1: dual streams reach bw_frac_dual of peak)."""
    ca, ba = parts_a
    cb, bb = parts_b
    mem_us = (ba + bb) / (spec.hbm_bw * spec.bw_frac_dual) * 1e6
    return max(ca, cb, mem_us)


# bytes a weight element streams from memory, by storage format
WEIGHT_BYTES_PER_EL = {None: 2.0, "int8": 1.0, "w4a16": 0.5}


def mxu_matmul_time_us(M: int, K: int, N: int, spec: TPUSpec = V5E,
                       *, bytes_per_el: int = 2,
                       w_bytes_per_el: float | None = None) -> float:
    return combine_single(mxu_matmul_parts(M, K, N, spec,
                                           bytes_per_el=bytes_per_el,
                                           w_bytes_per_el=w_bytes_per_el), spec)


def xla_matmul_time_us(M: int, K: int, N: int, spec: TPUSpec = V5E,
                       *, bytes_per_el: int = 2,
                       w_bytes_per_el: float | None = None) -> float:
    return combine_single(xla_matmul_parts(M, K, N, spec,
                                           bytes_per_el=bytes_per_el,
                                           w_bytes_per_el=w_bytes_per_el), spec)


def sync_cost_us(mode: str, spec: TPUSpec = V5E) -> float:
    """GPU-2: 'host' = blocking host sync per kernel (clFinish analogue);
    'fast' = on-device chaining (the paper's flag-polling analogue)."""
    return spec.dispatch_us if mode == "host" else spec.device_sync_us
