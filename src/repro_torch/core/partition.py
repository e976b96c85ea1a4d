"""Partition execution: the HeteroCtx that models thread through every matmul.

``HeteroCtx.matmul(x, w, name=site)`` consults the PartitionPlan (or the
engine mode) and executes the chosen strategy:

  xla_only : one flexible-path matmul (``torch.matmul``)
  mxu_only : the aligned-path GEMM kernel (``kernels/hetero_matmul``), with
             M/K/N padded to 128 (the NPU's stage padding) and the order
             exchange y = (w^T @ x^T)^T where the cost model prefers it
  pad      : mxu_only with M padded up to the decision's bucket
  weight   : the 128-aligned major column block on the aligned path, the
             remainder columns on the flexible path
  act      : the first ``m_bucket`` tokens on the aligned path, the ragged
             tail on the flexible path
  hybrid   : act bucketing + weight split of the bucketed part

The two halves of a split run one after the other on the current stream;
two-stream concurrency is later work. Weights keep the reference's
``[K, N]`` layout, and slices and transposes reach the kernel as strided
views, never as copies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.hetero_matmul.ops import mxu_matmul
from .characteristics import mxu_matmul_time_us
from .solver import Decision, PartitionPlan

ALIGN = 128
LAYER_MXU_THRESHOLD = 128      # hetero-layer: M >= this -> aligned path


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor's ``axis`` up to a multiple of ``mult``;
    returns ``x`` itself (no copy) when already aligned."""
    r = x.shape[axis] % mult
    if r == 0:
        return x
    pad = [0, 0, 0, 0]                       # F.pad order: last dim first
    pad[1 if axis in (1, -1) else 3] = mult - r
    return F.pad(x, pad)


def matmul_any(x: torch.Tensor, w: torch.Tensor, name: Optional[str] = None):
    """Plan-free matmul — the model code's path when no HeteroCtx is given."""
    return x @ w


@dataclass
class HeteroCtx:
    """mode: 'xla' | 'mxu' | 'hetero-layer' | 'hetero-tensor'."""
    mode: str = "hetero-tensor"
    plan: Optional[PartitionPlan] = None

    # ---------------------------------------------------------- primitives --
    def _mxu(self, x2, w):
        """Aligned-path matmul (output-stationary, the reference's order)
        with stage padding + NPU-2 order exchange."""
        M, K = x2.shape
        N = w.shape[1]
        use_exchange = mxu_matmul_time_us(N, K, M) < mxu_matmul_time_us(M, K, N)
        xp = _pad_to(_pad_to(x2, ALIGN, 0), ALIGN, 1)
        wp = _pad_to(_pad_to(w.to(x2.dtype), ALIGN, 0), ALIGN, 1)
        if use_exchange:
            y = mxu_matmul(wp.T, xp.T).T
        else:
            y = mxu_matmul(xp, wp)
        return y[:M, :N]

    def _xla(self, x2, w):
        return x2 @ w.to(x2.dtype)

    # ------------------------------------------------------------ dispatch --
    def matmul(self, x, w, name: Optional[str] = None):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        M, N = x2.shape[0], w.shape[1]
        if self.mode == "xla":
            y = self._xla(x2, w)
        elif self.mode == "mxu":
            y = self._mxu(x2, w)
        elif self.mode == "hetero-layer":
            y = self._mxu(x2, w) if M >= LAYER_MXU_THRESHOLD else \
                self._xla(x2, w)
        else:
            y = self._tensor_level(x2, w, name, M)
        return y.reshape(*lead, N)

    def _tensor_level(self, x2, w, name, M):
        dec = None
        if self.plan is not None and name is not None:
            dec = self.plan.decision(name, M)
            if dec is None:       # nearest-M fallback (solver probes a grid)
                ms = sorted({m for (s, m) in self.plan.decisions if s == name})
                if ms:
                    nearest = min(ms, key=lambda m: abs(m - M))
                    dec = self.plan.decision(name, nearest)
        if dec is None:
            return self._mxu(x2, w) if M >= ALIGN else self._xla(x2, w)
        return self.execute(dec, x2, w)

    def execute(self, dec: Decision, x2, w):
        M, N = x2.shape[0], w.shape[1]
        s = dec.strategy
        if s == "xla_only":
            return self._xla(x2, w)
        if s in ("mxu_only", "pad"):
            return self._mxu(x2, w)     # _mxu pads M internally (stage padding)
        if s == "weight":
            n = min(dec.n_split, N - 1)
            y1 = self._mxu(x2, w[:, :n])
            y2 = self._xla(x2, w[:, n:])
            return torch.cat([y1, y2], dim=-1)
        if s == "act":
            b = min(dec.m_bucket, M - 1) if dec.m_bucket < M else M - ALIGN
            b = max(b, 1)
            y1 = self._mxu(x2[:b], w)
            y2 = self._xla(x2[b:], w)
            return torch.cat([y1, y2], dim=0)
        if s == "hybrid":
            b = max(min(dec.m_bucket, M - 1), 1)
            n = min(dec.n_split, N - 1)
            y1a = self._mxu(x2[:b], w[:, :n])
            y1b = self._xla(x2[:b], w[:, n:])
            y2 = self._xla(x2[b:], w)
            return torch.cat([torch.cat([y1a, y1b], dim=-1), y2], dim=0)
        raise ValueError(f"unknown strategy {s}")
