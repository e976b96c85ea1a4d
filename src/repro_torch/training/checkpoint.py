"""Fault-tolerant checkpointing: async background writes, atomic commits —
the reference's ``repro.training.checkpoint``, with its on-disk layout, so
a checkpoint written by either package restores in the other, leaf for
leaf:

    <dir>/step_<N:08d>/
        manifest.json   ({"step", "leaves": {path: {file, shape, dtype}}})
        <leafpath>.npy  (one file per leaf, "/" in the path as "__";
                         bfloat16 stored as its uint16 bits, numpy having
                         no bfloat16)

A leaf's path is its dict keys joined by "/" (``state/params/embed``), as
the reference names a pytree leaf. The snapshot to host memory is
synchronous; the write runs on a background thread into
``step_<N>.tmp``, which is renamed to ``step_<N>`` last, so a crash
mid-write never leaves a readable but partial checkpoint, and then the
oldest beyond ``keep`` are removed. ``restore(step, like, device=)`` puts
each tensor leaf on ``device`` (default: the device of the leaf of
``like`` it replaces) in that leaf's dtype.

A sharded state (each rank holding its blocks, ``shardings=`` a tree of
``distributed.sharding.NamedSharding`` beside it) saves as the whole
arrays, in the same layout: every rank gathers each leaf, global rank 0
writes, and the others wait for its commit. ``restore(step, like,
shardings)`` gives each rank its own block under ``shardings``, which may
be another mesh's: a checkpoint reshards across meshes, and across the
two packages.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_flatten, tree_unflatten


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in tree_flatten(tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array to save, its logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr)                   # a writable copy, 0-dim kept
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save --
    def save(self, step: int, state: Any, *, blocking: bool = False,
             shardings: Optional[Any] = None):
        """Snapshot to host memory synchronously, write asynchronously.
        With ``shardings`` (a tree like ``state`` of ``NamedSharding``;
        every rank of the mesh calls it): the leaves are gathered whole,
        global rank 0 writes, and the call returns on every rank once the
        checkpoint is committed."""
        if shardings is not None:
            self._save_sharded(step, state, shardings)
            return
        host = [(name, *_host(leaf)) for name, leaf in _leaf_paths(state)]
        if self._thread is not None:
            self._thread.join()          # one outstanding write at a time

        def write():
            d = self.dir / f"step_{step:08d}.tmp"
            if d.exists():
                shutil.rmtree(d)
            d.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}}
            for name, arr, logical_dtype in host:
                fn = name.replace("/", "__") + ".npy"
                np.save(d / fn, arr)
                manifest["leaves"][name] = {
                    "file": fn, "shape": list(arr.shape),
                    "dtype": logical_dtype}
            (d / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            d.rename(final)              # atomic commit
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _save_sharded(self, step: int, state: Any, shardings: Any):
        import torch.distributed as dist
        from ..distributed.sharding import gather_tensor
        sh = dict(_leaf_paths(shardings))
        whole = tree_unflatten([
            (path, gather_tensor(leaf, sh["/".join(path)].spec,
                                 sh["/".join(path)].mesh)
             if isinstance(leaf, torch.Tensor) else leaf)
            for path, leaf in tree_flatten(state)])
        if dist.get_rank() == 0:
            self.save(step, whole, blocking=True)
        dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore --
    def all_steps(self) -> list[int]:
        # uncommitted step_NNNNNNNN.tmp dirs (async write in flight) are not
        # checkpoints: only the atomic rename makes one visible
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp")
                      and (p / "manifest.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Optional[Any] = None,
                *, device=None) -> Any:
        """Rebuild the nested dict of ``like`` from the checkpoint of
        ``step``: a tensor leaf on ``device`` (default: like's leaf's) in
        like's leaf's dtype, a Python scalar leaf as its type. With
        ``shardings`` (a tree like ``like`` of ``NamedSharding``) a tensor
        leaf is this rank's block of the saved array, and ``like``'s
        leaves have the local shapes."""
        from ..distributed.sharding import shard_tensor
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = dict(_leaf_paths(like))
        sh = dict(_leaf_paths(shardings)) if shardings is not None else {}
        out = {}
        for name, meta in manifest["leaves"].items():
            arr = np.load(d / meta["file"])
            tgt = leaves.get(name)
            shape = tuple(arr.shape)
            if sh.get(name) is not None:
                shape = sh[name].local_shape(shape)
            if (tgt is not None and hasattr(tgt, "shape")
                    and shape != tuple(tgt.shape)):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{shape} vs {tuple(tgt.shape)}")
            if isinstance(tgt, torch.Tensor):
                t = _tensor(arr, meta["dtype"])
                if sh.get(name) is not None:
                    t = shard_tensor(t, sh[name].spec, sh[name].mesh)
                out[name] = t.to(
                    device=tgt.device if device is None else device,
                    dtype=tgt.dtype)
            elif not hasattr(tgt, "shape"):      # python scalar leaf
                out[name] = type(tgt)(arr) if tgt is not None else arr.item()
            else:                                # a numpy leaf
                out[name] = arr
        return tree_unflatten([(path, out["/".join(path)])
                               for path, _ in tree_flatten(like)])

