"""Pipeline parallelism: a GPipe microbatch schedule over a ``stage`` axis,
the port of ``repro.distributed.pipeline`` for one process per rank.

Layers are split into ``n_stages`` contiguous groups, one a rank of the
mesh's ``stage`` dim. The forward runs ``n_micro + n_stages - 1`` ticks;
at tick ``t`` stage ``s`` runs microbatch ``t - s`` (if there is one) and
every stage hands its activation down the ring to ``(s + 1) % n_stages``
with point-to-point sends (``dist.batch_isend_irecv``); the last stage
records each finished microbatch and, after the last tick, hands the
outputs to every other stage. Bubble fraction = (S-1)/(M+S-1), surfaced by
``pipeline_stats`` so the roofline can weigh PP against TP for deep
models. Forward only. A stage with no microbatch at a tick skips
``layer_fn`` and passes its buffer on; the outputs are the same.

Gloo carries no CUDA tensor point to point, so over gloo (ranks sharing
one card) a hand-off goes through host memory; over NCCL it stays on the
device.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..training.tree import tree_map


def pipeline_stats(n_micro: int, n_stages: int) -> dict:
    ticks = n_micro + n_stages - 1
    return {"ticks": ticks,
            "bubble_fraction": (n_stages - 1) / ticks}


def _exchange(sends: list, recvs: list, group) -> None:
    """Post every ``(tensor, peer)`` send and receive (peers are ranks of
    ``group``) at once and wait for them all; over gloo a CUDA tensor
    travels through a host copy."""
    if not sends and not recvs:
        return
    host = dist.get_backend(group) == "gloo"
    staged = [(t, t.cpu() if host and t.is_cuda else t) for t, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.cpu() if host and t.is_cuda else t,
                      dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer),
                       group)
            for (_, buf), (_, peer) in zip(staged, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for t, buf in staged:
        if buf is not t:
            t.copy_(buf)


def make_pipeline_forward(layer_fn: Callable, n_stages: int, n_micro: int,
                          mesh, *, stage_axis: str = "stage"):
    """layer_fn(stage_params, x) -> x, applied per stage.

    Returns ``forward(params_s, x)``: ``params_s`` is this rank's stage
    params (a pytree whose tensors carry a leading dim of 1, as the
    reference's shard_map body sees them), ``x`` the replicated
    ``[n_micro, mb, ...]`` input; the outputs ``[n_micro, mb, ...]`` are
    returned on every rank (simple GPipe; interleaved 1F1B left as
    config)."""
    group = mesh.get_group(stage_axis)
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"a {n_stages}-stage pipeline over a "
                         f"{stage_axis!r} dim of {dist.get_world_size(group)}")
    sid = dist.get_rank(group)
    last = n_stages - 1

    def forward(params_s, x: torch.Tensor) -> torch.Tensor:
        params_s = tree_map(lambda a: a[0], params_s)
        buf = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        for t in range(n_micro + n_stages - 1):
            mb = t - sid                        # microbatch at this stage
            y = buf
            if 0 <= mb < n_micro:
                y = layer_fn(params_s, x[mb] if sid == 0 else buf)
                if sid == last:
                    outs[mb] = y
            if n_stages > 1:
                buf = torch.empty_like(y)
                _exchange([(y, (sid + 1) % n_stages)],
                          [(buf, (sid - 1) % n_stages)], group)
        if n_stages > 1:                        # the last stage hands off
            if sid == last:
                _exchange([(outs, s) for s in range(last)], [], group)
            else:
                _exchange([], [(outs, last)], group)
        return outs

    return forward
