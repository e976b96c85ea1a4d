"""Performance profiler (paper §4.4): the analytic latency table.

A LatencyTable maps (site, token count M, path) to microseconds. This slice
fills it from the reference's TPU cost model (core/characteristics.py), so
the solver plans what the JAX package plans; a table measured on the card
comes in a later slice. The profiling space is the paper's: the model's
weight shapes only, token counts on the standard bucket grid plus probes
around each bucket edge.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from .characteristics import (TPUSpec, V5E, mxu_matmul_time_us,
                              xla_matmul_time_us)

STANDARD_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
PROBE_MS = (1, 8, 32, 64, 96, 128, 192, 256, 320, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096)


def model_weight_shapes(cfg) -> dict[str, tuple[int, int]]:
    """Site name -> (K, N) for every partitionable matmul of a dense model."""
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "head": (d, cfg.vocab_size),
        "w_gate": (d, cfg.d_ff),
        "w_up": (d, cfg.d_ff),
        "w_down": (cfg.d_ff, d),
    }


@dataclass
class LatencyTable:
    """entries[(site, M, path)] = microseconds. path in {'mxu','xla'}."""
    spec: TPUSpec = V5E
    entries: dict = field(default_factory=dict)
    sites: dict = field(default_factory=dict)

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
            return f(M, K, N, self.spec)
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


def profile_analytic(cfg, spec: TPUSpec = V5E,
                     Ms: Iterable[int] = PROBE_MS) -> LatencyTable:
    table = LatencyTable(spec=spec)
    table.sites = model_weight_shapes(cfg)
    for site, (K, N) in table.sites.items():
        for M in Ms:
            table.entries[(site, M, "mxu")] = mxu_matmul_time_us(M, K, N, spec)
            table.entries[(site, M, "xla")] = xla_matmul_time_us(M, K, N, spec)
    return table
