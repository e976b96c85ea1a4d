"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=)`` is the port of
``repro.kernels.flash_attention.ops.flash_attention``: GQA attention of q
``[B,Sq,Hq,D]`` over k/v ``[B,Sk,Hkv,D]``, causal (aligned bottom-right,
so a chunk at cache position ``Sk - Sq`` sees its prefix) or not. The
kernel takes any D <= 128 as it is, so nothing is padded here. bf16 / fp16
run on the tensor cores and round the probabilities to the input type
before the P V product (``ref.attention_rounded_p_ref``); fp32 stays true
fp32. A CUDA tensor launches the kernel or raises; only tensors that lie on
the CPU take the plain version (``ref.py``). ``flash_attention.launches``
counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import counted, entry
from .ref import attention_ref

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


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    launch = entry("flash_attention", "flash_attention_fwd",
                   *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 6,
                   *[ctypes.c_longlong] * 8, *[ctypes.c_int] * 2)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in head_strides(t)]
    launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           B, Sq, Sk, Hkv, Hq // Hkv, D, *strides, int(causal),
           DTYPE_CODE[q.dtype])
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention, output in ``q.dtype``; fp32 softmax statistics."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"unsupported device {q.device}")


counted(flash_attention)
