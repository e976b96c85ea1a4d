"""Count one call's work as it is dispatched: the port's counterpart of
``repro.roofline.hlo_parse`` and of XLA's ``cost_analysis`` /
``memory_analysis``.

:class:`WorkCount` is a ``TorchDispatchMode``; :func:`count_call` runs a
callable under it and returns what the call did. It sees the same
operators whether the call runs on real tensors (the card, or the CPU) or
is traced on fake ones (``FakeTensorMode``, a fake process group), so one
count serves a dry run and a measured step alike:

* ``cost["flops"]``: each ATen operator by PyTorch's formulas
  (``torch.utils.flop_counter``'s registry, decomposing an operator it has
  no formula for, as ``FlopCounterMode`` does), and each kernel operator
  (``repro_torch::*``, ``kernels/library.py``) by ``kernels/work.py``.
* ``cost["bytes accessed"]``: each dispatched operator's input and output
  bytes; views, allocations and collectives move none here, and a kernel
  operator moves its compulsory bytes (``kernels/work.py``). This is eager,
  unfused traffic: what the card runs outside the kernels, each operator
  reading its inputs from memory and writing its outputs back.
* ``collectives``: ``{op: {"count", "bytes", "group"}}`` under XLA's HLO
  names, as ``collective_summary`` gives them: a c10d all-gather,
  all-reduce, reduce-scatter or all-to-all counts its result's bytes, a
  point-to-point send counts as a ``collective-permute`` of its tensor
  (the receive is the same transfer), a broadcast as a
  ``collective-broadcast``; ``group`` is the largest group size.
* ``memory``: ``argument_size_in_bytes`` (the arguments' tensors),
  ``output_size_in_bytes`` (the result's), ``alias_size_in_bytes`` (the
  result's tensors that live in an argument's storage, updated in place)
  and ``temp_size_in_bytes``, the peak of live storage bytes during the
  call less the arguments (storages are followed through weak references
  from the operator that made them until they die; the result's storages
  are live at the end, so they are part of it). What a kernel allocates
  inside its launch (split-K partials, a contiguous copy) is not seen.
* ``kernel_calls`` and ``kernel_flops``: calls and FLOPs per kernel
  operator, e.g. ``flash_attention``.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels.library import WORK

_c10d = torch.ops.c10d
# c10d operator -> HLO name; each takes its result tensors (an all-reduce's,
# a send's or a broadcast's: its only ones) as its first argument
COLLECTIVES = {
    _c10d.allreduce_: "all-reduce",
    _c10d.allreduce_coalesced_: "all-reduce",
    _c10d._allgather_base_: "all-gather",
    _c10d.allgather_: "all-gather",
    _c10d.allgather_into_tensor_coalesced_: "all-gather",
    _c10d._reduce_scatter_base_: "reduce-scatter",
    _c10d.reduce_scatter_: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced_: "reduce-scatter",
    _c10d.alltoall_base_: "all-to-all",
    _c10d.alltoall_: "all-to-all",
    _c10d.send: "collective-permute",
    _c10d.broadcast_: "collective-broadcast",
}
# run, not counted: a receive (its send is counted), a barrier, and the
# device query that a fake tensor dispatches and a real one does not
_SKIPPED = (_c10d.recv_, _c10d.recv_any_source_, _c10d.barrier,
            torch.ops.prim.device)
_aten = torch.ops.aten
# no bytes: allocations, and a view whose schema does not say it is one
_NO_BYTES = (_aten.empty, _aten.empty_strided, _aten.new_empty,
             _aten.new_empty_strided, _aten.empty_like, _aten._unsafe_view)
# what FlopCounterMode hands back to a tensor subclass unexamined
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default}


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The size of the process group a c10d operator was given (boxed as
    a ``ScriptObject`` in the dispatcher)."""
    pg = next(a for a in args if isinstance(a, (torch.ScriptObject,
                                                dist.ProcessGroup)))
    if isinstance(pg, torch.ScriptObject):
        pg = dist.ProcessGroup.unbox(pg)
    return pg.size()


class WorkCount(TorchDispatchMode):
    """The count of everything dispatched while the mode is active (see
    the module's docstring); :meth:`track_arguments` marks the call's
    arguments before it runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernel_calls: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.collectives: dict = {}
        self._storages = WeakIdKeyDictionary()
        self._arguments: set = set()
        self.argument_storage_bytes = 0
        self.live = 0
        self.peak = 0

    # ----------------------------------------------------------- memory --

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = weakref.ref(st, lambda _, n=n: self._free(n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def track_arguments(self, args) -> int:
        """Mark the storages of ``args``' tensors live; returns the
        arguments' bytes (their tensors', as a rank's blocks)."""
        for t in _tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._arguments:
                self._arguments.add(id(st))
                self.argument_storage_bytes += st.nbytes()
            self._track(t)
        return sum(_nbytes(t) for t in _tensors(args))

    def is_argument(self, t: torch.Tensor) -> bool:
        return id(t.untyped_storage()) in self._arguments

    # --------------------------------------------------------- dispatch --

    def _collective(self, func, args) -> None:
        nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
        rec = self.collectives.setdefault(COLLECTIVES[func._overloadpacket],
                                          [0, 0, 1])
        rec[0] += 1
        rec[1] += nbytes
        rec[2] = max(rec[2], _group_size(args))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        if packet in COLLECTIVES:
            out = func(*args, **kwargs)
            self._collective(func, args)
            return out
        if packet in _SKIPPED:
            return func(*args, **kwargs)
        if packet not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in WORK:
            flops, nbytes = WORK[packet](*args, **kwargs)
            self.bytes += nbytes
            self.kernel_calls[packet.__name__] += 1
            self.kernel_flops[packet.__name__] += flops
        elif packet not in _NO_BYTES and not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in _tensors(
                (args, kwargs))) + sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out


def _is_view(func) -> bool:
    """An operator whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def count_call(fn: Callable, *args, **kwargs) -> tuple[Any, dict]:
    """``fn(*args, **kwargs)`` under a :class:`WorkCount`: (its result, the
    record ``{"cost", "collectives", "memory", "kernel_calls",
    "kernel_flops"}``)."""
    mode = WorkCount()
    arg_bytes = mode.track_arguments((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    outs = {id(t.untyped_storage()): t for t in _tensors(out)}
    return out, {
        "cost": {"flops": float(mode.flops),
                 "bytes accessed": float(mode.bytes)},
        "collectives": {k: {"count": v[0], "bytes": v[1], "group": v[2]}
                        for k, v in mode.collectives.items()},
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": sum(_nbytes(t) for t in outs.values()),
            "alias_size_in_bytes": sum(_nbytes(t) for t in outs.values()
                                       if mode.is_argument(t)),
            "temp_size_in_bytes": mode.peak - mode.argument_storage_bytes},
        "kernel_calls": dict(mode.kernel_calls),
        "kernel_flops": dict(mode.kernel_flops)}

