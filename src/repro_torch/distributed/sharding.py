"""Sharding helpers of the port's tensor-parallel serving: the parts of the
reference's ``repro.distributed.sharding`` that M8 needs.

  * :func:`axis_size` / :func:`axis_rank` — a ``DeviceMesh`` axis's width
    and this rank's coordinate on it, by name.
  * :func:`undivided_dims` — the role of the reference's ``sanitize_spec``:
    the dims of a shape that an axis of the mesh does not divide, which the
    reference would silently replicate. The port never replicates a dim
    that was meant to shard: its callers raise where the reference's
    layout raises.
  * :class:`split_kv_enabled` / :func:`split_kv_active` — the switch of
    the split-KV decode path (distributed/split_kv.py), a context variable
    as in the reference, so two interleaved contexts each see their own
    setting; :func:`split_kv_mesh` is the mesh it runs over.
"""
from __future__ import annotations

import contextvars


def axis_size(mesh, name: str) -> int:
    """Width of ``mesh``'s axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on ``mesh``'s axis ``name``."""
    return mesh.get_local_rank(name)


def undivided_dims(shape, spec, mesh) -> list[int]:
    """Indices of the dims of ``shape`` whose mesh axes in ``spec`` (one
    entry per dim: None, an axis name or a tuple of names, like a
    ``PartitionSpec``) do not divide them."""
    out = []
    for i, (dim, axes) in enumerate(zip(shape, spec)):
        if axes is None:
            continue
        width = 1
        for name in ((axes,) if isinstance(axes, str) else axes):
            width *= axis_size(mesh, name)
        if dim % width:
            out.append(i)
    return out


_SPLIT_KV: contextvars.ContextVar = contextvars.ContextVar(
    "split_kv", default=(False, None))


class split_kv_enabled:
    """Context manager: a one-token decode step of ``layers.attention``
    takes the split-KV path (sequence-sharded cache, owner-local writes, a
    max and two sums to combine) over ``mesh``'s ``model`` axis, or over
    the one local shard when ``mesh`` is None."""

    def __init__(self, enable: bool, mesh=None):
        self.value = (bool(enable), mesh)

    def __enter__(self):
        self.tok = _SPLIT_KV.set(self.value)
        return self

    def __exit__(self, *exc):
        _SPLIT_KV.reset(self.tok)
        return False


def split_kv_active() -> bool:
    return _SPLIT_KV.get()[0]


def split_kv_mesh():
    return _SPLIT_KV.get()[1]
