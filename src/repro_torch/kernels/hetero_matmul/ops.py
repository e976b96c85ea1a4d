"""Wrapper of the aligned-path GEMM (``csrc/hetero_matmul.cu``).

``mxu_matmul(x, w)`` is the port of ``repro.kernels.hetero_matmul.ops
.mxu_matmul``: ``[..., K] @ [K, N]`` with fp32 accumulation, all of M, K and
N multiples of 128. A CUDA tensor launches the kernel or raises; only
tensors that lie on the CPU take the plain version (``ref.matmul_ref``).
``mxu_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import matmul_ref

ALIGN = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STATIONARY_CODE = {"output": 0, "weight": 1}


def _check(x: torch.Tensor, w: torch.Tensor, stationary: str) -> None:
    if stationary not in _STATIONARY_CODE:
        raise ValueError(f"stationary must be 'output' or 'weight', "
                         f"got {stationary!r}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    (M, K), (K2, N) = x.shape, w.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if M % ALIGN or K % ALIGN or N % ALIGN:
        raise ValueError(f"misaligned ({M},{K},{N}): every dim must be a "
                         f"multiple of {ALIGN}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"unsupported dtypes x={x.dtype}, w={w.dtype}: both "
                        "must be one of float32, bfloat16, float16")
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}")


def operand_layout(t: torch.Tensor) -> tuple[int, int]:
    """(leading dimension, trans) of a 2-D operand as the kernel reads it:
    row-major with leading dimension ``ld`` (trans 0), or the transpose of a
    row-major array (trans 1) — a column slice ``w[:, a:b]`` is the first,
    ``w.T`` the second. Raises for any other stride pattern."""
    R, C = t.shape
    s0, s1 = t.stride()
    if s1 == 1 and s0 >= C:
        return s0, 0
    if s0 == 1 and s1 >= R:
        return s1, 1
    raise ValueError(f"operand strides {t.stride()} for shape {tuple(t.shape)}"
                     " are neither row- nor column-major")


def _launch(x: torch.Tensor, w: torch.Tensor, stationary: str) -> torch.Tensor:
    from ..build import load

    lib = load("hetero_matmul")
    fn = lib.hetero_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M, K = x.shape
    N = w.shape[1]
    lda, trans_a = operand_layout(x)
    ldb, trans_b = operand_layout(w)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    scratch = None
    if stationary == "weight" and x.dtype != torch.float32:
        scratch = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 M, N, K, lda, ldb, trans_a, trans_b, _DTYPE_CODE[x.dtype],
                 _STATIONARY_CODE[stationary], stream)
    if err != 0:
        lib.hetero_matmul_error_string.restype = ctypes.c_char_p
        lib.hetero_matmul_error_string.argtypes = [ctypes.c_int]
        msg = lib.hetero_matmul_error_string(err).decode()
        raise RuntimeError(f"hetero_matmul launch failed: {msg} ({err})")
    mxu_matmul.launches += 1
    return y


def mxu_matmul(x: torch.Tensor, w: torch.Tensor, *,
               stationary: str = "output") -> torch.Tensor:
    """``[..., K] @ [K, N]`` on the aligned path, output in ``x.dtype``.
    Shapes must be aligned; operands may be strided (see
    :func:`operand_layout`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim != 2 else x
    _check(x2, w, stationary)
    if x2.device.type == "cpu":
        y = matmul_ref(x2, w)
    elif x2.device.type == "cuda":
        y = _launch(x2, w, stationary)
    else:
        raise ValueError(f"unsupported device {x2.device}")
    return y.reshape(*lead, w.shape[1])


mxu_matmul.launches = 0
