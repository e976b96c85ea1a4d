"""Process groups and meshes of the port, the reference's
``repro.launch.mesh`` for one process per rank.

The reference runs one controller over a mesh of devices; the port runs one
process per rank, each with plain local tensors and explicit collectives.
``init_ranks`` joins this process to the group (``file://`` rendezvous, so
concurrent runs never race for a port); ``make_host_mesh`` lays a
``("data", "model")`` ``DeviceMesh`` over it; ``spawn_ranks`` starts the
ranks of a group as processes and returns what each one computed. NCCL serves CUDA tensors and
gloo CPU tensors; a caller may name gloo for CUDA tensors (several ranks
sharing one card, which NCCL refuses). ``make_production_mesh`` lays the
reference's 16 x 16 (single pod) or 2 x 16 x 16 (two pods) mesh over a
group of 256 or 512 ranks; a fake process group
(``torch.testing._internal.distributed.fake_pg``) builds it in one
process, which is how its shapes are checked without the ranks.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_ranks(world: int, rank: int, rendezvous: str, backend=None, *,
               device="cuda") -> None:
    """Join rank ``rank`` of ``world`` to the default process group at
    ``rendezvous`` (``file:///path`` or ``tcp://host:port``), over
    ``backend`` (by default the one ``device`` takes). With NCCL this rank
    drives card ``rank``, made current here."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    kw = {}
    if backend == "nccl":
        card = torch.device("cuda", rank)
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=rendezvous,
                            world_size=world, rank=rank, **kw)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` of ``data x model`` ranks over
    the initialized default group, whose size must be that product."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group: call init_ranks first")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over the initialized default group: 16 x 16 =
    256 ranks ``("data", "model")``, or with ``multi_pod`` 2 x 16 x 16 =
    512 ranks ``("pod", "data", "model")``; batch and FSDP dims shard over
    the compound ``("pod", "data")`` axes (:func:`data_axes`). Raises
    unless the group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialized "
                           "process group")
    n = 1
    for w in shape:
        n *= w
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, the "
                         f"process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def data_axes(mesh) -> tuple:
    """The batch axes: ('pod', 'data') on a multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def model_axes(mesh) -> tuple:
    return ("model",)


def spawn_ranks(fn, world: int, *args, device="cuda", backend=None) -> list:
    """``fn(rank, *args)`` on each rank of a new ``world``-rank group, one
    spawned process each, joined over ``backend`` (by default the one
    ``device`` takes) at a ``file://`` rendezvous in a fresh temporary
    directory. ``fn`` must be importable (it is pickled by name). Returns
    the ranks' results in rank order; a rank that raises fails the call
    with its traceback, and the other ranks are stopped."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_run_rank, nprocs=world, start_method="spawn",
                           args=(fn, world, tmp, backend, str(device),
                                 args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _run_rank(rank, fn, world, tmp, backend, device, args):
    init_ranks(world, rank, "file://" + os.path.join(tmp, "rendezvous"),
               backend, device=device)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
