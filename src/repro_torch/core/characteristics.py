"""Hardware cost models for the solver: the reference's TPU v5e, verbatim,
and the H100 that the port runs on.

``TPUSpec`` / ``V5E`` are ``repro.core.characteristics`` (the paper's §3
characteristics ported to TPU v5e), kept unchanged on purpose: planned on
them, the solver makes the JAX package's decisions, which the CPU parity
tests hold it to. ``GPUSpec`` / ``H100`` carry the same fields for an H100
SXM5 80GB: datasheet peaks, and constants calibrated on the card by
``chip_smoke.py``'s characterize phase (each names its run). A latency
table measured on the card (``profiler.profile_measured``) carries
``H100``, so the solver prices its analytic split candidates on it.

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


@dataclass(frozen=True)
class GPUSpec(TPUSpec):
    """A card in ``TPUSpec``'s fields, so every cost function takes either.
    ``mxu_tile`` is the aligned kernel's 128-row tile and ``vmem_bytes`` the
    on-chip working set (L2). Fields more: ``mxu_eff``, the aligned
    path's effective share of ``peak_flops_bf16`` in the stage model of
    :func:`mxu_matmul_parts`, which sets its tile rate (``clock_hz``; the
    TPU's systolic model has no such share, and ``n_mxu`` cancels there);
    ``node_size``, the cards that one node joins by ``ici_bw x
    ici_links`` (NVLink), and ``net_bw``, each card's share of the network
    between nodes (bytes a second; 0: none), which the roofline charges a
    collective over a group larger than a node
    (``roofline/analysis.py``)."""
    mxu_eff: float = 1.0
    node_size: int = 8
    net_bw: float = 0.0

    @property
    def clock_hz(self) -> float:
        return self.peak_flops_bf16 * self.mxu_eff / (
            2 * self.mxu_tile ** 2 * self.n_mxu)


# NVIDIA H100 SXM5 80GB. Datasheet (NVIDIA H100 Tensor Core GPU data sheet,
# SXM5, dense, at the 700 W limit): the peaks, HBM3 bandwidth, 50 MB of L2,
# 132 SMs and NVLink 4 (18 links of 25 GB/s each way). The calibrated
# constants come from chip_smoke.py's characterize phase (its
# "[characterize]" lines) on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, in the run of 2026-10-17 that PERF.md §6 records.
H100 = GPUSpec(
    name="h100_sxm5",
    peak_flops_bf16=989e12,              # datasheet, dense bf16
    hbm_bw=3.35e12,                      # datasheet, HBM3
    ici_bw=25e9,                         # datasheet, NVLink 4 per link, each way
    ici_links=18,                        # datasheet, NVLink 4
    vmem_bytes=50 * 2 ** 20,             # datasheet, L2
    mxu_tile=128,                        # the aligned GEMM's row tile
    n_mxu=132,                           # SMs (cancels in the stage model)
    # calibrated on the card (phase A; card, limit and run above)
    dispatch_us=14.26,            # measure_dispatch_overhead: launch + fence
    device_sync_us=0.141,         # one cross-stream event wait, device side
    bw_frac_single=0.878,         # one stream's copy rate / hbm_bw
    bw_frac_dual=0.899,           # two concurrent streams' copy rate / hbm_bw
    xla_eff=0.623,                # torch.matmul at the llama3-8b sites, M = 256
    xla_kernel_overhead_us=20.91,  # fenced torch.matmul at M = 1, beyond its bytes
    mxu_eff=0.738,                # HeteroCtx._mxu at those sites / the stage model
    node_size=8,                  # datasheet, HGX H100 8-GPU board
    net_bw=50e9,                  # datasheet, one ConnectX-7 (400 Gb/s) a GPU
)


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


def dual_path_memory_time_us(bytes_a: int, bytes_b: int,
                             spec: TPUSpec = V5E) -> float:
    """Memory-1: two concurrent streams share an aggregated-bandwidth pool."""
    return (bytes_a + bytes_b) / (spec.hbm_bw * spec.bw_frac_dual) * 1e6


def sync_cost_us(mode: str, spec: TPUSpec = V5E) -> float:
    """GPU-2: 'host' = blocking host sync per kernel (clFinish analogue);
    'fast' = on-device chaining (the paper's flag-polling analogue)."""
    return spec.dispatch_us if mode == "host" else spec.device_sync_us


def compile_time_model_us(M: int, K: int, N: int) -> float:
    """'NPU graph generation' analogue (paper Fig 8): per-graph build
    latency, affine in sequence length, calibrated to the paper's own
    measurements (~100 ms/graph at S=135, ~500 ms/graph at S=1000)."""
    return 5e4 + 350.0 * M
