"""Performance profiler (paper §4.4, "Performance Profiler").

A LatencyTable maps (site, token count M, path) to microseconds. Two modes:

  * ``analytic`` — the cost model of a spec (core/characteristics.py); on
    ``V5E``, the default, the solver plans what the JAX package plans.
  * ``measured`` — the paper's characterize step: both paths timed on the
    device as ``HeteroCtx`` runs them (``profile_measured``). On the card
    the table carries ``H100``.

The profiling space is the paper's: the model's weight shapes only, token
counts on the standard bucket grid plus probes around each bucket edge.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..configs import dtype_of
from ..device import resolve_device
from .characteristics import (H100, V5E, WEIGHT_BYTES_PER_EL, TPUSpec,
                              mxu_matmul_time_us, xla_matmul_time_us)

STANDARD_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
PROBE_MS = (1, 8, 32, 64, 96, 128, 192, 256, 320, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096)
# the specs a saved table may name
SPECS = {spec.name: spec for spec in (V5E, H100)}


def model_weight_shapes(cfg) -> dict[str, tuple[int, int]]:
    """Site name -> (K, N) for every partitionable matmul in the model. An
    MoE model's ``w_*`` sites take the routed expert's shape and its
    shared expert adds ``shared/w_*`` (the model runs the shared expert
    under the routed names); a hybrid adds its mamba blocks' in_proj and
    out_proj; RWKV has its own nine sites."""
    d, hd = cfg.d_model, cfg.head_dim
    sites = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "head": (d, cfg.vocab_size),
    }
    if cfg.moe:
        sites.update({
            "w_gate": (d, cfg.moe.d_ff_expert),
            "w_up": (d, cfg.moe.d_ff_expert),
            "w_down": (cfg.moe.d_ff_expert, d),
        })
        if cfg.moe.d_ff_shared:
            sites.update({
                "shared/w_gate": (d, cfg.moe.d_ff_shared),
                "shared/w_up": (d, cfg.moe.d_ff_shared),
                "shared/w_down": (cfg.moe.d_ff_shared, d),
            })
    else:
        sites.update({
            "w_gate": (d, cfg.d_ff),
            "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d),
        })
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * d
        nh = d_in // cfg.ssm.head_dim
        sites["in_proj"] = (d, 2 * d_in + 2 * cfg.ssm.d_state + nh)
        sites["out_proj"] = (d_in, d)
    if cfg.rwkv is not None:
        sites = {"wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
                 "wo": (d, d), "wk_ffn": (d, cfg.d_ff),
                 "wv_ffn": (cfg.d_ff, d), "wr_ffn": (d, d),
                 "head": (d, cfg.vocab_size)}
    return sites


@dataclass
class LatencyTable:
    """entries[(site, M, path)] = microseconds. path in {'mxu','xla'}."""
    spec: TPUSpec = V5E
    entries: dict = field(default_factory=dict)
    sites: dict = field(default_factory=dict)
    mode: str = "analytic"            # analytic | measured
    weight_quant: str | None = None   # None | "int8" | "w4a16" (storage)

    def lookup(self, site: str, M: int, path: str) -> float:
        key = (site, M, path)
        if key in self.entries:
            return self.entries[key]
        return self.interpolate(site, M, path)

    def interpolate(self, site: str, M: int, path: str) -> float:
        """GPU-1 linear / NPU-1 stage interpolation for unseen M."""
        ms = sorted({m for (s, m, p) in self.entries if s == site and p == path})
        if not ms:
            K, N = self.sites[site]
            f = mxu_matmul_time_us if path == "mxu" else xla_matmul_time_us
            return f(M, K, N, self.spec,
                     w_bytes_per_el=WEIGHT_BYTES_PER_EL[self.weight_quant])
        if path == "mxu":
            # stage model: latency of the next bucketed M (staircase)
            m_up = next((m for m in ms if m >= M), ms[-1])
            scale = 1.0 if m_up >= M else M / ms[-1]
            return self.entries[(site, m_up, path)] * max(scale, 1.0)
        # linear model through the two nearest points
        lo = max((m for m in ms if m <= M), default=ms[0])
        hi = next((m for m in ms if m >= M), ms[-1])
        tlo, thi = self.entries[(site, lo, path)], self.entries[(site, hi, path)]
        if hi == lo:
            return tlo * M / lo
        w = (M - lo) / (hi - lo)
        return tlo + w * (thi - tlo)

    def save(self, path) -> None:
        Path(path).write_text(json.dumps({
            "mode": self.mode, "spec": self.spec.name,
            "weight_quant": self.weight_quant,
            "sites": {k: list(v) for k, v in self.sites.items()},
            "entries": [[s, m, p, t] for (s, m, p), t in
                        self.entries.items()]}))

    @classmethod
    def load(cls, path, spec: TPUSpec | None = None) -> "LatencyTable":
        """The saved table, on ``spec`` or else the spec it names."""
        data = json.loads(Path(path).read_text())
        t = cls(spec=spec or SPECS[data["spec"]], mode=data["mode"],
                weight_quant=data.get("weight_quant"))
        t.sites = {k: tuple(v) for k, v in data["sites"].items()}
        for s, m, p, v in data["entries"]:
            t.entries[(s, int(m), p)] = float(v)
        return t


def profile_analytic(cfg, spec: TPUSpec = V5E,
                     Ms: Iterable[int] = PROBE_MS, *,
                     weight_quant: str | None = None) -> LatencyTable:
    """``weight_quant`` prices the weight stream at its storage bytes per
    element (int8 1 B, w4a16 0.5 B): memory-bound entries drop, compute-
    bound ones barely move, and the solver re-plans around the shift."""
    wb = WEIGHT_BYTES_PER_EL[weight_quant]
    table = LatencyTable(spec=spec, mode="analytic",
                         weight_quant=weight_quant)
    table.sites = model_weight_shapes(cfg)
    for site, (K, N) in table.sites.items():
        for M in Ms:
            table.entries[(site, M, "mxu")] = mxu_matmul_time_us(
                M, K, N, spec, w_bytes_per_el=wb)
            table.entries[(site, M, "xla")] = xla_matmul_time_us(
                M, K, N, spec, w_bytes_per_el=wb)
    return table


def profile_measured(cfg, Ms: Iterable[int] = (1, 32, 128, 256, 512), *,
                     repeats: int = 3, max_kn: int | None = None,
                     device="cuda", dtype=None,
                     weight_quant: str | None = None,
                     clock=None) -> LatencyTable:
    """Time the two paths per (site, M) on ``device`` (the card unless
    ``"cpu"`` is asked for) as ``HeteroCtx`` runs them: ``_xla`` and
    ``_mxu``, the latter with its stage padding and order exchange, so the
    table prices what executes. Each entry is the median of ``repeats``
    fenced calls after a first one, the host's dispatch included (prefill
    runs eagerly), read on ``clock`` (``MonotonicClock`` unless one is
    injected). Operands are normal draws from seed 0 in ``dtype`` (the
    model's compute dtype unless given); ``weight_quant`` ('int8' | 'w4a16')
    quantizes each weight with the port's quantizers, so the aligned path
    launches its dequantizing GEMM and the flexible path dequantizes, as a
    quantized deployment does. The aligned path is timed where K and N are
    multiples of 128, as in the reference; elsewhere the table falls back
    to its spec's model. ``max_kn`` caps K and N (and the stored sites) for
    quick runs on the CPU; leave it off on the card, or the solver prices
    full-width splits on capped shapes. The table's spec is ``H100`` on the
    card and ``V5E`` on the CPU."""
    from ..kernels.hetero_matmul.ops import (quantize_weight,
                                             quantize_weight_int4)
    from ..serving.telemetry import MonotonicClock
    from .partition import ALIGN, HeteroCtx, QuantWeight
    from .sync import fence

    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    clock = clock if clock is not None else MonotonicClock()
    ctx = HeteroCtx(mode="hetero-tensor")
    table = LatencyTable(spec=H100 if device.type == "cuda" else V5E,
                         mode="measured", weight_quant=weight_quant)
    cap = (lambda d: d) if max_kn is None else (lambda d: min(d, max_kn))
    table.sites = {s: (cap(k), cap(n))
                   for s, (k, n) in model_weight_shapes(cfg).items()}
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def weight(K, N):
        w = normal(K, N)
        if weight_quant == "int8":
            return QuantWeight(*quantize_weight(w), "int8", K)
        if weight_quant == "w4a16":
            return QuantWeight(*quantize_weight_int4(w), "w4a16", K)
        return w.to(dtype)

    def bench(fn, *args) -> float:
        fence(fn(*args))
        ts = []
        for _ in range(repeats):
            t0 = clock.now()
            fence(fn(*args))
            ts.append(clock.now() - t0)
        return float(np.median(ts) * 1e6)

    for site, (K, N) in table.sites.items():
        w = weight(K, N)
        for M in Ms:
            x = normal(M, K).to(dtype)
            table.entries[(site, M, "xla")] = bench(ctx._xla, x, w)
            if K % ALIGN == 0 and N % ALIGN == 0:
                table.entries[(site, M, "mxu")] = bench(ctx._mxu, x, w)
    return table
