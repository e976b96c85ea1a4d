"""Wrapper of the SSD chunk kernel (``csrc/ssd_chunk.cu``) and the chunk scan.

``ssd_chunk(xb, B_, C_, seg, S_prev)`` has the contract of
``repro.kernels.ssm_scan.kernel.ssd_chunk_pallas``: one Mamba2 chunk step,
all operands fp32, returning fp32 (y ``[B,L,nh,hd]``, S_new
``[B,nh,hd,N]``). The wrapper calls its ``repro_torch`` operator
(``kernels/library.py``): a CUDA tensor launches the kernel or raises;
only tensors that lie on the CPU take the plain version (``ref.py``); fake
tensors get outputs of the right shape. On the card one call is two
launches (C.B^T once per batch into a scratch the wrapper allocates, then
the chunk step); ``ssd_chunk.launches`` counts calls.

The gradient: where grad is enabled and an input requires it, a call goes
through ``_SSDChunk``, which saves its inputs and whose backward runs the
backward kernel through ``ssd_chunk_bwd`` (three launches a call: C.B^T,
the per-head jobs, the sums over heads; ``ssd_chunk_bwd.launches`` counts
calls); on CPU tensors its plain version, ``ssd_chunk_bwd_ref``. Every
other call runs the forward alone. ``torch.utils.checkpoint`` recomputing
a layer in backward reruns the forward.

``ssd_scan`` is the port of ``repro.kernels.ssm_scan.ops.ssd_scan``: the
whole scan as a host loop of ``ssd_chunk`` calls, the state passed from one
launch to the next on the device. ``chunk_inputs`` and ``scan_chunks`` are
its two halves, which ``models/mamba2.py::ssd_chunked`` shares.
"""
from __future__ import annotations

import ctypes

import torch

from .. import work
from ..build import counted, entry
from ..library import kernel_op, routed
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

MAX_DIM = 64                   # the kernel's largest head dim and state size
CB_TILE = 64                   # the C.B^T scratch's side: L rounded up to it


def _check(xb, B_, C_, seg, S_prev) -> None:
    if xb.ndim != 4 or B_.ndim != 3 or C_.shape != B_.shape or seg.ndim != 3 \
            or S_prev.ndim != 4:
        raise ValueError(
            f"expected xb [B,L,nh,hd], B_/C_ [B,L,N], seg [B,L,nh], S_prev "
            f"[B,nh,hd,N]; got {tuple(xb.shape)}, {tuple(B_.shape)}, "
            f"{tuple(C_.shape)}, {tuple(seg.shape)}, {tuple(S_prev.shape)}")
    Bb, L, nh, hd = xb.shape
    N = B_.shape[-1]
    if B_.shape[:2] != (Bb, L) or seg.shape != (Bb, L, nh) \
            or S_prev.shape != (Bb, nh, hd, N):
        raise ValueError(
            f"shape mismatch: xb {tuple(xb.shape)}, B_ {tuple(B_.shape)}, "
            f"seg {tuple(seg.shape)}, S_prev {tuple(S_prev.shape)}")
    if L < 1:
        raise ValueError("an empty chunk")
    ops = (xb, B_, C_, seg, S_prev)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"operands must be float32, got "
                        f"{[t.dtype for t in ops]}")
    if any(t.device != xb.device for t in ops):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in ops]}")


def _check_layout(xb, B_, C_, seg, S_prev) -> None:
    hd, N = xb.shape[-1], B_.shape[-1]
    if hd > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"head dim {hd} or state size {N} > {MAX_DIM}")
    if xb.stride(3) != 1 or (xb.shape[2] > 1 and xb.stride(2) != hd) \
            or B_.stride(2) != 1 or C_.stride(2) != 1 or seg.stride(2) != 1 \
            or not S_prev.is_contiguous():
        raise ValueError(
            f"strides xb {xb.stride()}, B_ {B_.stride()}, C_ {C_.stride()}, "
            f"seg {seg.stride()}, S_prev {S_prev.stride()}: the last dims "
            "must be packed and S_prev contiguous")


def _launch(xb, B_, C_, seg, S_prev):
    Bb, L, nh, hd = xb.shape
    N = B_.shape[-1]
    _check_layout(xb, B_, C_, seg, S_prev)
    launch = entry("ssd_chunk", "ssd_chunk_fwd", *[ctypes.c_void_p] * 8,
                   *[ctypes.c_int] * 5, *[ctypes.c_longlong] * 8)
    y = torch.empty(xb.shape, dtype=torch.float32, device=xb.device)
    S_new = torch.empty(S_prev.shape, dtype=torch.float32, device=xb.device)
    Lp = -(-L // CB_TILE) * CB_TILE
    cb = torch.empty((Bb, Lp, Lp), dtype=torch.float32, device=xb.device)
    launch(xb.device, xb.data_ptr(), B_.data_ptr(), C_.data_ptr(),
           seg.data_ptr(), S_prev.data_ptr(), y.data_ptr(), S_new.data_ptr(),
           cb.data_ptr(), Bb, L, nh, hd, N,
           *[s for t in (xb, B_, C_, seg) for s in (t.stride(0), t.stride(1))])
    ssd_chunk.launches += 1
    return y, S_new


def _chunk_work(xb, B_, *args) -> tuple[int, int]:
    Bb, L, nh, hd = xb.shape
    return work.ssd_chunk(Bb, L, nh, hd, B_.shape[-1])


_ssd_fwd = kernel_op(
    "ssd_chunk(Tensor xb, Tensor b, Tensor c, Tensor seg, Tensor s_prev) "
    "-> (Tensor, Tensor)",
    cpu=ssd_chunk_ref, cuda=_launch,
    fake=lambda xb, B_, C_, seg, S_prev: (
        xb.new_empty(xb.shape, dtype=torch.float32),
        xb.new_empty(S_prev.shape, dtype=torch.float32)),
    work=_chunk_work)


class _SSDChunk(torch.autograd.Function):
    """The chunk step's forward, and its backward."""

    @staticmethod
    def forward(ctx, xb, B_, C_, seg, S_prev):
        y, S_new = _ssd_fwd(xb, B_, C_, seg, S_prev)
        ctx.save_for_backward(xb, B_, C_, seg, S_prev)
        return y, S_new

    @staticmethod
    def backward(ctx, dy, dS_new):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy, dS_new)


def ssd_chunk(xb: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
              seg: torch.Tensor, S_prev: torch.Tensor):
    """One SSD chunk step: (y ``[B,L,nh,hd]``, S_new ``[B,nh,hd,N]``)."""
    _check(xb, B_, C_, seg, S_prev)
    if not routed(xb):
        raise ValueError(f"unsupported device {xb.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xb, B_, C_, seg, S_prev)):
        return _SSDChunk.apply(xb, B_, C_, seg, S_prev)
    return _ssd_fwd(xb, B_, C_, seg, S_prev)


counted(ssd_chunk)


def _launch_bwd(xb, B_, C_, seg, S_prev, dy, dS_new):
    Bb, L, nh, hd = xb.shape
    N = B_.shape[-1]
    _check_layout(xb, B_, C_, seg, S_prev)
    if dy.stride(3) != 1 or (nh > 1 and dy.stride(2) != hd):
        dy = dy.contiguous()
    dS_new = dS_new.contiguous()
    launch = entry("ssd_chunk", "ssd_chunk_bwd", *[ctypes.c_void_p] * 18,
                   *[ctypes.c_int] * 5, *[ctypes.c_longlong] * 10)
    f32 = dict(dtype=torch.float32, device=xb.device)
    dxb, dB, dC = (torch.empty(t.shape, **f32) for t in (xb, B_, C_))
    dseg, dS_prev = torch.empty(seg.shape, **f32), torch.empty(S_prev.shape,
                                                               **f32)
    T = -(-L // CB_TILE)
    cb = torch.empty((Bb, T * CB_TILE, T * CB_TILE), **f32)
    dbh, dch = (torch.empty((Bb, nh, L, N), **f32) for _ in range(2))
    dsr, dsc = (torch.empty((Bb, nh, L), **f32) for _ in range(2))
    dtot = torch.empty((Bb, nh, T + 1), **f32)
    launch(xb.device, *(t.data_ptr() for t in (
        xb, B_, C_, seg, S_prev, dy, dS_new, dxb, dB, dC, dseg, dS_prev, cb,
        dbh, dch, dsr, dsc, dtot)), Bb, L, nh, hd, N,
        *[s for t in (xb, B_, C_, seg, dy) for s in (t.stride(0),
                                                     t.stride(1))])
    ssd_chunk_bwd.launches += 1
    return dxb, dB, dC, dseg, dS_prev


_ssd_bwd = kernel_op(
    "ssd_chunk_bwd(Tensor xb, Tensor b, Tensor c, Tensor seg, "
    "Tensor s_prev, Tensor dy, Tensor ds_new) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=ssd_chunk_bwd_ref, cuda=_launch_bwd,
    fake=lambda xb, B_, C_, seg, S_prev, dy, dS_new: tuple(
        t.new_empty(t.shape, dtype=torch.float32)
        for t in (xb, B_, C_, seg, S_prev)),
    work=lambda xb, B_, *args: work.ssd_chunk_bwd(*xb.shape, B_.shape[-1]))


def ssd_chunk_bwd(xb, B_, C_, seg, S_prev, dy, dS_new):
    """The gradient of ``ssd_chunk(xb, B_, C_, seg, S_prev)`` given dy
    ``[B,L,nh,hd]`` and dS_new ``[B,nh,hd,N]``: (dxb, dB_, dC_, dseg,
    dS_prev), all fp32 (``ref.ssd_chunk_bwd_ref``). On the card every sum
    runs in a fixed order, so a gradient repeats bitwise."""
    _check(xb, B_, C_, seg, S_prev)
    if dy.shape != xb.shape or dS_new.shape != S_prev.shape:
        raise ValueError(f"dy {tuple(dy.shape)}, dS_new "
                         f"{tuple(dS_new.shape)} for xb {tuple(xb.shape)}, "
                         f"S_prev {tuple(S_prev.shape)}")
    if dy.dtype != torch.float32 or dS_new.dtype != torch.float32:
        raise TypeError(f"dy {dy.dtype}, dS_new {dS_new.dtype}: float32")
    if dy.device != xb.device or dS_new.device != xb.device:
        raise ValueError(f"operands on different devices: {xb.device}, "
                         f"{dy.device}, {dS_new.device}")
    if not routed(xb):
        raise ValueError(f"unsupported device {xb.device}")
    return _ssd_bwd(xb, B_, C_, seg, S_prev, dy, dS_new)


counted(ssd_chunk_bwd)


def chunk_inputs(xh, dt, A, B_, C_, L: int):
    """The scan's fp32 operands for chunks of ``L`` steps (S a multiple of
    L): xb = xh * dt, B_, C_, and seg, the inclusive cumsum of dt * A
    within each chunk. xh [B,S,nh,hd]; dt [B,S,nh] (post-softplus); A [nh]
    (negative); B_, C_ [B,S,N]."""
    Bb, S, nh, _ = xh.shape
    da = (dt * A[None, None, :]).float()
    xb = (xh * dt[..., None]).float()
    seg = da.reshape(Bb, S // L, L, nh).cumsum(dim=2).reshape(Bb, S, nh)
    return xb, B_.float(), C_.float(), seg


def scan_chunks(xb, B_, C_, seg, L: int, state):
    """``ssd_chunk`` over each run of ``L`` steps in order, the state passed
    on from launch to launch. Returns (y [B,S,nh,hd], final state)."""
    ys = []
    for i in range(xb.shape[1] // L):
        sl = slice(i * L, (i + 1) * L)
        y, state = ssd_chunk(xb[:, sl], B_[:, sl], C_[:, sl], seg[:, sl],
                             state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_scan(xh, dt, A, B_, C_, *, chunk: int = 256):
    """The whole SSD scan from a zero state; S must be a multiple of
    ``min(chunk, S)``. Returns (y [B,S,nh,hd] fp32, final state
    [B,nh,hd,N] fp32)."""
    Bb, S, nh, hd = xh.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    state = torch.zeros((Bb, nh, hd, B_.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    return scan_chunks(*chunk_inputs(xh, dt, A, B_, C_, L), L, state)
