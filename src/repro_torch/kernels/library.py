"""The port's kernels as operators of the ``repro_torch`` namespace of
``torch.library``, so that PyTorch's tracing sees each one as one call.

:func:`kernel_op` defines an operator from its schema and gives it four
things: a CPU implementation (the kernel's plain version, its outputs
contiguous as the kernel's are), a CUDA implementation (the launch, which
bumps its wrapper's ``.launches``), a fake implementation (outputs of the
right shape and dtype under ``FakeTensorMode``: no launch, no count,
nothing asked of the CUDA runtime) and a FLOP formula from ``kernels/work.py``
(``torch.utils.flop_counter.register_flop_formula``). ``WORK`` maps each
operator to its work function, ``(flops, bytes)`` of one call, which
``roofline/count.py`` charges for it.

The operators are defined with ``Library.define`` / ``Library.impl``, not
the ``torch.library.custom_op`` decorator, whose Python autograd layer
costs several times the dispatcher's own host time a call; they register
no autograd formula: a wrapper that needs a gradient calls its operators
inside its own ``torch.autograd.Function`` (``flash_attention``,
``ssd_chunk``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "DEF")
# operator packet -> work(*args) -> (flops, bytes)
WORK: dict = {}


def kernel_op(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable,
              work: Callable) -> torch._ops.OpOverload:
    """Define ``repro_torch::<schema>`` with its CPU, CUDA and fake
    implementations and its work; returns the operator's default
    overload (what a wrapper calls)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, lambda *args: _contiguous(cpu(*args)), "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet, get_raw=True)(
        lambda *args, out_val=None, **kwargs: work(*args, **kwargs)[0])
    WORK[packet] = work
    return packet.default


def _contiguous(out):
    """A plain version's outputs laid out as the kernel writes them (and
    the fake implementation describes them): contiguous."""
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    return tuple(t.contiguous() for t in out)


def routed(t: torch.Tensor) -> bool:
    """Whether a wrapper sends ``t`` to its operator: CPU and CUDA tensors,
    real or fake (under ``FakeTensorMode`` the operator runs its fake
    implementation); any other device raises in the wrapper."""
    return t.device.type in ("cpu", "cuda")
