"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k_cache, v_cache, length)`` is the port of
``repro.kernels.decode_attention.ops.decode_attention``: one query token
per sequence, q ``[B,Hq,D]``, over dense caches ``[B,Smax,Hkv,D]`` (any
Smax) valid up to one ``length`` for the whole batch. On the card the
length stays on the device: a Python int is filled in there, a tensor is
read by the kernel itself, so a decode loop that keeps its position on
the device never reads it on the host. The kernel splits the cache over
:func:`decode_split_plan`'s number of blocks per (batch, kv head), a count
taken from host-known sizes only, and combines the splits in a second pass
of the same launch. The wrapper calls its ``repro_torch`` operator
(``kernels/library.py``), the length as one int32 on the query's device:
a CUDA tensor launches the kernel or raises; only tensors that lie on the
CPU take the plain version (``ref.py``); fake tensors get an output of
the right shape. ``decode_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import work
from ..build import counted, entry
from ..flash_attention.ops import DTYPE_CODE, MAX_D, head_strides
from ..hetero_matmul.ops import H100_SMS, sm_count
from ..library import kernel_op, routed
from .ref import decode_attention_ref

MAX_G = 8
# a split takes at least MIN_SPLIT_KEYS cache rows at a full cache; the
# combine stages at most MAX_SPLITS (m, l) pairs per row in shared memory
MIN_SPLIT_KEYS = 32
MAX_SPLITS = 64
WAVES = 2


def max_decode_split(Smax: int) -> int:
    """The most splits a cache of ``Smax`` rows takes."""
    return max(1, min(MAX_SPLITS, Smax // MIN_SPLIT_KEYS))


@lru_cache(maxsize=None)
def decode_split_plan(B: int, Hkv: int, Smax: int, n_sm: int = H100_SMS
                      ) -> int:
    """Key splits per (batch, kv head): the fewest whose B * Hkv * n_split
    blocks fill the ``n_sm`` SMs ``WAVES`` times, at most
    :func:`max_decode_split`. Host-known sizes only, never the length, so a
    decode loop that keeps its length on the device launches a fixed grid.
    (llama3-8b at 324 rows: 10 splits, 80 blocks; zamba2-2.7b at 616 rows:
    9 splits, 288 blocks. The combine's time grows with the split, the
    split pass's falls with it: both were timed on the card, PERF.md.)"""
    return max(1, min(-(-WAVES * n_sm // (B * Hkv)), max_decode_split(Smax)))


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


def _launch(q, k_cache, v_cache, length, n_split) -> torch.Tensor:
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if D > MAX_D or G > MAX_G:
        raise ValueError(f"head dim {D} (max {MAX_D}) or {G} query "
                         f"heads per kv head (max {MAX_G})")
    if q.stride(2) != 1 or (Hq > 1 and q.stride(1) != D):
        raise ValueError(f"q strides {q.stride()}: heads must be packed")
    launch = entry("decode_attention", "decode_attention_fwd",
                   *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6,
                   *[ctypes.c_longlong] * 6, ctypes.c_int)
    n_split = n_split or decode_split_plan(B, Hkv, Smax,
                                           sm_count(q.device.index))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # per (batch, kv head, split, query head): (m, l), then acc[D]
    scratch = torch.empty(B * Hkv * n_split * G * (D + 2),
                          dtype=torch.float32, device=q.device)
    (k_b, k_s), (v_b, v_s) = head_strides(k_cache), head_strides(v_cache)
    launch(q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           o.data_ptr(), length.data_ptr(), scratch.data_ptr(), B, Smax,
           Hkv, G, D, n_split, q.stride(0), k_b, k_s, v_b, v_s, o.stride(0),
           DTYPE_CODE[q.dtype])
    decode_attention.launches += 1
    return o


def _work(q, k_cache, v_cache, length, n_split) -> tuple[int, int]:
    B, Hq, D = q.shape
    return work.decode(B, Hq, k_cache.shape[2], D, k_cache.shape[1],
                       q.element_size())


_decode = kernel_op(
    "decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
    "Tensor length, int? n_split) -> Tensor",
    cpu=lambda q, k, v, length, n_split: decode_attention_ref(q, k, v,
                                                              length),
    cuda=_launch,
    fake=lambda q, k, v, length, n_split: q.new_empty(q.shape),
    work=_work)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     n_split: int | None = None) -> torch.Tensor:
    """Attention of one token per sequence over the first ``length`` cache
    rows; output in ``q.dtype``, fp32 softmax statistics. ``n_split``
    overrides :func:`decode_split_plan`'s split (1 ..
    :func:`max_decode_split`) on the card."""
    _check(q, k_cache, v_cache)
    if n_split is not None and not 1 <= n_split <= max_decode_split(
            k_cache.shape[1]):
        raise ValueError(f"n_split {n_split} outside 1.."
                         f"{max_decode_split(k_cache.shape[1])}")
    if not routed(q):
        raise ValueError(f"unsupported device {q.device}")
    return _decode(q, k_cache, v_cache, _device_length(length, q.device),
                   n_split)


counted(decode_attention)
