"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k_cache, v_cache, length)`` is the port of
``repro.kernels.decode_attention.ops.decode_attention``: one query token
per sequence, q ``[B,Hq,D]``, over dense caches ``[B,Smax,Hkv,D]`` (any
Smax) valid up to one ``length`` for the whole batch. On the card the
length stays on the device: a Python int is filled in there, a tensor is
read by the kernel itself, so a decode loop that keeps its position on
the device never reads it on the host. A CUDA tensor launches the kernel or
raises; only tensors that lie on the CPU take the plain version
(``ref.py``). ``decode_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..flash_attention.ops import DTYPE_CODE, MAX_D, head_strides
from .ref import decode_attention_ref

MAX_G = 8


def _check(q, k_cache, v_cache) -> None:
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"expected q [B,Hq,D], caches [B,Smax,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    B2, _, Hkv, D2 = k_cache.shape
    if B != B2 or D != D2 or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if q.dtype not in DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}: all one of float32, bfloat16, "
                        "float16")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k_cache.device}, {v_cache.device}")


def _device_length(length, device) -> torch.Tensor:
    """``length`` as one int32 on ``device``: a tensor is not read on the
    host, an int is filled in on the device (no copy)."""
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.device != device:
            raise ValueError(f"length must be one element on {device}, got "
                             f"{tuple(length.shape)} on {length.device}")
        return length.reshape(1).to(torch.int32)
    return torch.full((1,), int(length), dtype=torch.int32, device=device)


def _launch(q, k_cache, v_cache, length) -> torch.Tensor:
    from ..build import entry

    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D > MAX_D or Hq // Hkv > MAX_G:
        raise ValueError(f"head dim {D} (max {MAX_D}) or {Hq // Hkv} query "
                         f"heads per kv head (max {MAX_G})")
    if q.stride(2) != 1 or (Hq > 1 and q.stride(1) != D):
        raise ValueError(f"q strides {q.stride()}: heads must be packed")
    launch = entry("decode_attention", "decode_attention_fwd",
                   *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 5,
                   *[ctypes.c_longlong] * 6, ctypes.c_int)
    n = _device_length(length, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    (k_b, k_s), (v_b, v_s) = head_strides(k_cache), head_strides(v_cache)
    launch(q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           o.data_ptr(), n.data_ptr(), B, Smax, Hkv, Hq // Hkv, D,
           q.stride(0), k_b, k_s, v_b, v_s, o.stride(0), DTYPE_CODE[q.dtype])
    decode_attention.launches += 1
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """Attention of one token per sequence over the first ``length`` cache
    rows; output in ``q.dtype``, fp32 softmax statistics."""
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    if q.device.type == "cuda":
        return _launch(q, k_cache, v_cache, length)
    raise ValueError(f"unsupported device {q.device}")


decode_attention.launches = 0
