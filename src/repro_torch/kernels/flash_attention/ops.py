"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=)`` is the port of
``repro.kernels.flash_attention.ops.flash_attention``: GQA attention of q
``[B,Sq,Hq,D]`` over k/v ``[B,Sk,Hkv,D]``, causal (aligned bottom-right,
so a chunk at cache position ``Sk - Sq`` sees its prefix) or not. The
kernel takes any D <= 128 as it is, so nothing is padded here. bf16 / fp16
run on the tensor cores and round the probabilities to the input type
before the P V product (``ref.attention_rounded_p_ref``); fp32 stays true
fp32. Each wrapper calls its ``repro_torch`` operator
(``kernels/library.py``): a CUDA tensor launches the kernel or raises;
only tensors that lie on the CPU take the plain version (``ref.py``);
fake tensors get outputs of the right shape.
``flash_attention.launches`` counts launches.

The gradient (``csrc/flash_attention_bwd.cu``): where grad is enabled and
an input requires it, a call goes through ``_FlashAttention``, whose
forward also writes each row's log-sum-exp (fp32 ``[B, Hq, Sq]``) and
whose backward runs the backward kernel through ``flash_attention_bwd``
(``flash_attention_bwd.launches`` counts its launches); on CPU tensors
the plain versions of both (``attention_ref`` with ``lse_ref``, and
``attention_bwd_ref``). Every other call runs the forward alone, with no
log-sum-exp. ``torch.utils.checkpoint`` recomputing a layer in backward
reruns that forward, log-sum-exp included.
"""
from __future__ import annotations

import ctypes

import torch

from .. import work
from ..build import counted, entry
from ..library import kernel_op, routed
from .ref import attention_bwd_ref, attention_ref, lse_ref

MAX_D = 128                    # both attention kernels' largest head dim
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(q, k, v, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    B2, Sk, Hkv, D2 = k.shape
    if B != B2 or D != D2 or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got {Sq} > {Sk}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}:"
                        " all one of float32, bfloat16, float16")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def head_strides(t: torch.Tensor) -> tuple[int, int]:
    """(batch, sequence) strides of a ``[B, S, H, D]`` operand whose heads
    are packed (unit stride along D, stride D between heads), as a cache
    prefix ``cache[:, :n]`` is. Raises for any other layout."""
    _, _, H, D = t.shape
    if t.stride(3) != 1 or (H > 1 and t.stride(2) != D):
        raise ValueError(f"strides {t.stride()} of {tuple(t.shape)}: heads "
                         "must be packed along the last two dims")
    return t.stride(0), t.stride(1)


def _launch(q, k, v, causal: bool, lse: torch.Tensor | None = None
            ) -> torch.Tensor:
    launch = entry("flash_attention", "flash_attention_fwd",
                   *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 6,
                   *[ctypes.c_longlong] * 8, *[ctypes.c_int] * 2)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in head_strides(t)]
    launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           None if lse is None else lse.data_ptr(), B, Sq, Sk, Hkv,
           Hq // Hkv, D, *strides, int(causal), DTYPE_CODE[q.dtype])
    flash_attention.launches += 1
    return o


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


def _lse_shape(q: torch.Tensor) -> tuple:
    B, Sq, Hq, _ = q.shape
    return (B, Hq, Sq)


def _cuda_fwd(q, k, v, causal: bool, with_lse: bool):
    lse = (torch.empty(_lse_shape(q), dtype=torch.float32, device=q.device)
           if with_lse else _no_lse(q))
    return _launch(q, k, v, causal, lse if with_lse else None), lse


def _cpu_fwd(q, k, v, causal: bool, with_lse: bool):
    return (attention_ref(q, k, v, causal=causal),
            lse_ref(q, k, causal=causal) if with_lse else _no_lse(q))


def _fake_fwd(q, k, v, causal: bool, with_lse: bool):
    return (q.new_empty(q.shape),
            q.new_empty(_lse_shape(q) if with_lse else (0,),
                        dtype=torch.float32))


def _fwd_work(q, k, v, causal: bool, with_lse: bool) -> tuple[int, int]:
    B, Sq, Hq, D = q.shape
    return work.flash(B, Sq, k.shape[1], Hq, k.shape[2], D, q.element_size(),
                      causal, with_lse)


_flash_fwd = kernel_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
    "bool with_lse) -> (Tensor, Tensor)",
    cpu=_cpu_fwd, cuda=_cuda_fwd, fake=_fake_fwd, work=_fwd_work)


class _FlashAttention(torch.autograd.Function):
    """The forward with its log-sum-exp, and the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _flash_fwd(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention, output in ``q.dtype``; fp32 softmax statistics."""
    _check(q, k, v, causal)
    if not routed(q):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal, False)[0]


counted(flash_attention)


def _launch_bwd(q, k, v, o, lse, do, causal: bool):
    launch = entry("flash_attention_bwd", "flash_attention_bwd",
                   *[ctypes.c_void_p] * 10, *[ctypes.c_int] * 8)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch(q.device, *(t.data_ptr() for t in (q, k, v, o, do, lse, delta,
                                               dq, dk, dv)),
           B, Sq, Sk, Hkv, Hq // Hkv, D, int(causal), DTYPE_CODE[q.dtype])
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _bwd_work(q, k, v, o, lse, do, causal: bool) -> tuple[int, int]:
    B, Sq, Hq, D = q.shape
    return work.flash_bwd(B, Sq, k.shape[1], Hq, k.shape[2], D,
                          q.element_size(), causal)


_flash_bwd = kernel_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
    "Tensor dout, bool causal) -> (Tensor, Tensor, Tensor)",
    cpu=lambda q, k, v, o, lse, do, causal: attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal),
    cuda=_launch_bwd,
    fake=lambda q, k, v, o, lse, do, causal: (
        q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)),
    work=_bwd_work)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=)`` given its
    output ``o``, its rows' log-sum-exp ``lse`` (fp32 ``[B, Hq, Sq]``) and
    the output's gradient ``do``; each in its input's type, accumulated in
    fp32 (bf16 / fp16 round P and dS to the input type before their
    products, ``ref.attention_bwd_ref``)."""
    _check(q, k, v, causal)
    B, Sq, Hq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, Hq, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} for q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"o {o.dtype}, do {do.dtype}, lse {lse.dtype}: o "
                        "and do in q's type, lse float32")
    if not routed(q):
        raise ValueError(f"unsupported device {q.device}")
    return _flash_bwd(q, k, v, o, lse, do, causal)


counted(flash_attention_bwd)
