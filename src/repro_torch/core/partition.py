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

On the card the two halves of a weight / act / hybrid split run
concurrently, as the solver prices them (Memory-1): the aligned half on the
device's side stream (``side_stream``, made once), the flexible half on the
current stream. The side stream waits for the current one before it
starts, and the current one waits for the side stream before the ``cat``;
inside a CUDA graph capture that fork and join are captured as well. On the
CPU the halves run one after the other. Weights keep the reference's
``[K, N]`` layout, and slices and transposes reach the kernel as strided
views, never as copies.

Speculative-decoding verification dispatches use a view from
``for_verify(k, lanes)``: the same strategies, but sites resolve through
the plan's VERIFY decisions (``solver.solve_verify``) first.

A weight may be a :class:`QuantWeight` (int8 or packed int4 codes with a
per-column scale): the aligned path then launches the dequantizing GEMMs
(``mxu_quant_matmul`` / ``mxu_q4_matmul``), the flexible path and the
plan-free ``matmul_any`` dequantize first, and every strategy splits it by
columns with ``slice_n``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels.hetero_matmul.ops import (mxu_matmul, mxu_q4_matmul,
                                         mxu_quant_matmul)
from ..kernels.hetero_matmul.ref import unpack_int4
from .characteristics import mxu_matmul_time_us
from .solver import Decision, PartitionPlan

ALIGN = 128


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor's ``axis`` up to a multiple of ``mult``;
    returns ``x`` itself (no copy) when already aligned."""
    r = x.shape[axis] % mult
    if r == 0:
        return x
    pad = [0, 0, 0, 0]                       # F.pad order: last dim first
    pad[1 if axis in (1, -1) else 3] = mult - r
    return F.pad(x, pad)


def _pad_vec(v: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor up to a multiple of ``mult`` (no copy when
    already aligned)."""
    r = v.shape[0] % mult
    return v if r == 0 else F.pad(v, (0, mult - r))


class QuantWeight:
    """A quantized weight that goes wherever an fp weight does.

    Per-output-channel symmetric quantization in one of two formats:

      * ``int8``  — ``wq`` int8 ``[..., K, N]``, ``scale`` f32 ``[..., N]``
      * ``w4a16`` — ``wq`` int8 ``[..., ceil(K/2), N]``, two int4 codes per
        byte along K (rows 2r, 2r+1 -> low, high nibble), the same scale

    ``k`` is the LOGICAL contraction dim (the int4 packer zero-pads odd K).
    Leading axes stack layers: ``qw[i]`` is layer ``i``'s weight, a view.
    """

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, fmt: str,
                 k: int):
        if fmt not in ("int8", "w4a16"):
            raise ValueError(f"unknown weight format {fmt!r}")
        self.wq = wq
        self.scale = scale
        self.fmt = fmt
        self.k = int(k)

    @property
    def shape(self) -> tuple:
        """Logical ``[..., K, N]`` shape (what the fp weight would report)."""
        return (*self.wq.shape[:-2], self.k, self.wq.shape[-1])

    @property
    def n(self) -> int:
        return self.wq.shape[-1]

    def __getitem__(self, i: int) -> "QuantWeight":
        """Layer ``i`` of a stacked weight (views of codes and scales)."""
        return QuantWeight(self.wq[i], self.scale[i], self.fmt, self.k)

    def to(self, device) -> "QuantWeight":
        return QuantWeight(self.wq.to(device), self.scale.to(device),
                           self.fmt, self.k)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantize-then-cast expansion (the flexible path's operand and
        the kernels' oracle)."""
        if self.fmt == "int8":
            q = self.wq.float()
        else:
            q = unpack_int4(self.wq)[..., :self.k, :].float()
        return (q * self.scale.float()[..., None, :]).to(dtype)

    def slice_n(self, a: int, b: int) -> "QuantWeight":
        """Column slice (views): packing runs along K, so any split point
        of N is representable."""
        return QuantWeight(self.wq[..., :, a:b], self.scale[..., a:b],
                           self.fmt, self.k)


def _weight_cols(w, a: int, b: int):
    return w.slice_n(a, b) if isinstance(w, QuantWeight) else w[:, a:b]


def matmul_any(x: torch.Tensor, w, name: Optional[str] = None):
    """Plan-free matmul over fp or quantized weights — the model code's
    path when no HeteroCtx is given (a QuantWeight dequantizes first)."""
    if isinstance(w, QuantWeight):
        return x @ w.dequant(x.dtype)
    return x @ w


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of CUDA ``device`` on which a split runs its aligned
    half: one per device, made at its first use."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _side_stream(index)


@lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(device=index)


def _weight_tensors(w) -> tuple:
    return (w.wq, w.scale) if isinstance(w, QuantWeight) else (w,)


def _concurrent(aligned: Callable, flexible: Callable, x2, w):
    """``(aligned(), flexible())``, the two halves of a split of
    ``x2 @ w``. On the card ``aligned`` runs on the device's side stream
    (its wrappers launch on the current stream, so the call goes inside
    ``torch.cuda.stream(side)``) and ``flexible`` on the current stream;
    the side stream first waits for the current one, and the current one
    waits for the side stream before returning, so a CUDA graph capture
    records the fork and the join. For the caching allocator: ``x2`` and
    the weight, made on the current stream, are marked as read on the side
    stream; the aligned output, made on the side stream, as read on the
    current one. On the CPU the halves run one after the other."""
    if x2.device.type != "cuda":
        return aligned(), flexible()
    main = torch.cuda.current_stream(x2.device)
    side = side_stream(x2.device)
    side.wait_stream(main)
    for t in (x2, *_weight_tensors(w)):
        t.record_stream(side)
    with torch.cuda.stream(side):
        ya = aligned()
    yf = flexible()
    main.wait_stream(side)
    ya.record_stream(main)
    return ya, yf


@dataclass
class HeteroCtx:
    """mode: 'xla' | 'mxu' | 'hetero-layer' | 'hetero-tensor'.

    ``order_exchange``: let the aligned path take y = (w^T @ x^T)^T where
    the cost model prefers it; ``layer_mxu_threshold``: the token count
    from which hetero-layer mode takes the aligned path; ``stationary``:
    the aligned kernel's grid order ('output' or 'weight');
    ``verify_key``: (k, lanes) of a verification view (``for_verify``)."""
    mode: str = "hetero-tensor"
    plan: Optional[PartitionPlan] = None
    order_exchange: bool = True
    layer_mxu_threshold: int = 128       # hetero-layer: M >= this -> aligned
    stationary: str = "output"
    verify_key: Optional[tuple] = None

    def for_verify(self, k: int, lanes: int = 1) -> "HeteroCtx":
        """This context for verification dispatches: the same plan and
        mode, its sites resolved through the VERIFY decisions solved for
        (k, lanes)."""
        return replace(self, verify_key=(k, lanes))

    # ---------------------------------------------------------- primitives --
    def _mxu(self, x2, w):
        """Aligned-path matmul with stage padding + NPU-2 order exchange.
        The exchange is priced on the reference's V5E model, as the
        reference prices it, whatever spec planned the split: a measured
        table times this method, exchange included, so the plan prices
        what runs. A QuantWeight goes to the dequantizing kernels instead;
        the exchange is fp-only (packed codes cannot become the streamed
        operand)."""
        if isinstance(w, QuantWeight):
            return self._mxu_quant(x2, w)
        M, K = x2.shape
        N = w.shape[1]
        use_exchange = (self.order_exchange and
                        mxu_matmul_time_us(N, K, M) < mxu_matmul_time_us(M, K, N))
        xp = _pad_to(_pad_to(x2, ALIGN, 0), ALIGN, 1)
        wp = _pad_to(_pad_to(w.to(x2.dtype), ALIGN, 0), ALIGN, 1)
        if use_exchange:
            y = mxu_matmul(wp.T, xp.T, stationary=self.stationary).T
        else:
            y = mxu_matmul(xp, wp, stationary=self.stationary)
        return y[:M, :N]

    def _mxu_quant(self, x2, w: QuantWeight):
        """Stage padding for the quantized kernels: codes pad with 0 and
        scales with 0 (the padded columns are sliced off); x pads along K
        with zeros, so code rows past the logical K add nothing. Packed
        int4 rows pad to a multiple of 64, i.e. half the padded K."""
        M, N = x2.shape[0], w.n
        xp = _pad_to(_pad_to(x2, ALIGN, 0), ALIGN, 1)
        sp = _pad_vec(w.scale, ALIGN)
        if w.fmt == "int8":
            wqp = _pad_to(_pad_to(w.wq, ALIGN, 0), ALIGN, 1)
            y = mxu_quant_matmul(xp, wqp, sp)
        else:
            wqp = _pad_to(_pad_to(w.wq, ALIGN // 2, 0), ALIGN, 1)
            y = mxu_q4_matmul(xp, wqp, sp)
        return y[:M, :N]

    def _xla(self, x2, w):
        if isinstance(w, QuantWeight):
            return x2 @ w.dequant(x2.dtype)
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
            y = self._mxu(x2, w) if M >= self.layer_mxu_threshold else \
                self._xla(x2, w)
        else:
            y = self._tensor_level(x2, w, name, M)
        return y.reshape(*lead, N)

    def _tensor_level(self, x2, w, name, M):
        dec = None
        if self.plan is not None and name is not None:
            if self.verify_key is not None:
                dec = self.plan.verify_decision(name, *self.verify_key)
            if dec is None:
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
            y1, y2 = _concurrent(
                lambda: self._mxu(x2, _weight_cols(w, 0, n)),
                lambda: self._xla(x2, _weight_cols(w, n, N)), x2, w)
            return torch.cat([y1, y2], dim=-1)
        if s == "act":
            b = min(dec.m_bucket, M - 1) if dec.m_bucket < M else M - ALIGN
            b = max(b, 1)
            y1, y2 = _concurrent(lambda: self._mxu(x2[:b], w),
                                 lambda: self._xla(x2[b:], w), x2, w)
            return torch.cat([y1, y2], dim=0)
        if s == "hybrid":
            b = max(min(dec.m_bucket, M - 1), 1)
            n = min(dec.n_split, N - 1)
            y1a, (y1b, y2) = _concurrent(
                lambda: self._mxu(x2[:b], _weight_cols(w, 0, n)),
                lambda: (self._xla(x2[:b], _weight_cols(w, n, N)),
                         self._xla(x2[b:], w)), x2, w)
            return torch.cat([torch.cat([y1a, y1b], dim=-1), y2], dim=0)
        raise ValueError(f"unknown strategy {s}")
