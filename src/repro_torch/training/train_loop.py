"""End-to-end training loop, the reference's
``repro.training.train_loop``: model + AdamW + data pipeline +
checkpointing + fault tolerance (straggler monitor, crash restart) +
optional int8 error-feedback gradient compression.

A step is ``model.loss`` forward, ``torch.autograd.grad`` of the loss
with respect to every parameter (the attention's backward is the flash
kernel's, ``kernels/flash_attention``; the hybrid's SSD scan's the SSD
chunk kernel's, ``kernels/ssm_scan``), optional compression, then
``optimizer.apply_updates``. The state is a plain dict of tensors on the
step's device with ``step`` a device int32; the step reads nothing back
to the host. It runs on ``device`` (the card unless ``"cpu"`` is asked
for). Weights are ``model.init`` drawn from an explicit generator, or the
caller's (the reference's, through ``convert.params_from_numpy``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import resolve_device
from ..distributed.compression import (compress_grads_with_feedback,
                                       init_error)
from ..models import build_model
from ..serving.telemetry import Clock, MonotonicClock
from . import optimizer as opt
from .checkpoint import CheckpointManager
from .data import SyntheticLM
from .fault_tolerance import RestartPolicy, run_resilient
from .tree import tree_flatten, tree_unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    save_every: int = 50
    ckpt_dir: str = "artifacts/ckpt"
    grad_compression: bool = False
    # SP only useful on real meshes. As in the reference, train() reads
    # nothing of it: a mesh run hands it to launch.steps.build_train_step
    # (seq_shard=), which splits the residual stream over ``model``.
    seq_shard: bool = False
    opt: opt.AdamWConfig = field(default_factory=opt.AdamWConfig)


def loss_and_grads(model, params: dict, inputs, targets):
    """(loss, metrics, grads): ``model.loss`` and the gradient of the loss
    with respect to every parameter, as a dict shaped like ``params``; a
    leaf the loss does not read (the embedding under float inputs) gets a
    zero gradient, as in the reference. Nothing is written to ``params``."""
    items = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for _, t in items]
    loss, metrics = model.loss(
        tree_unflatten([(path, t) for (path, _), t in zip(items, leaves)]),
        inputs, targets)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten([(path, torch.zeros_like(t) if g is None else g)
                            for (path, t), g in zip(items, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg, tcfg: TrainConfig, *, device="cuda"):
    """(model, train_step): ``train_step(state, batch) -> (state,
    metrics)`` with ``batch = {"inputs", "targets"}`` (numpy or tensors;
    moved to ``device``) and metrics ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr`` as 0-dim device tensors. The state's params, m
    and v are updated in place (``optimizer.apply_updates``)."""
    device = resolve_device(device)
    model = build_model(cfg)

    def train_step(state, batch):
        loss, metrics, grads = loss_and_grads(
            model, state["params"],
            torch.as_tensor(batch["inputs"]).to(device),
            torch.as_tensor(batch["targets"]).to(device))
        if tcfg.grad_compression:
            grads, new_err = compress_grads_with_feedback(
                grads, state["ef_error"])
        new_state, om = opt.apply_updates(
            {k: state[k] for k in ("params", "m", "v", "step")}, grads,
            tcfg.opt)
        if tcfg.grad_compression:
            new_state["ef_error"] = new_err
        return new_state, {"loss": loss, **metrics, **om}

    return model, train_step


def train(cfg, tcfg: TrainConfig, shape=None, *, data=None,
          fail_injector=None, log=print, clock: Optional[Clock] = None,
          device="cuda", params: Optional[dict] = None,
          generator: Optional[torch.Generator] = None):
    """Train ``tcfg.steps`` steps under ``run_resilient``: (state, [(step,
    loss)] at step 1 and every ``log_every``, the StepMonitor). ``params``
    (on ``device``) start the run, else ``model.init(generator)`` (seed 0
    on ``device`` when None). ``shape`` (a ``ShapeSpec``) sets the
    synthetic batch, else seq 128 x batch 8 as in the reference."""
    device = resolve_device(device)
    clock = clock if clock is not None else MonotonicClock()
    model, step_fn = make_train_step(cfg, tcfg, device=device)
    if params is None:
        params = model.init(generator, device=device)
    state = opt.init_state(params, tcfg.opt)
    if tcfg.grad_compression:
        state["ef_error"] = init_error(params)

    seq = shape.seq_len if shape else 128
    batch = shape.global_batch if shape else 8
    data = data or SyntheticLM(cfg.vocab_size, seq, batch)
    ckpt = CheckpointManager(tcfg.ckpt_dir)

    losses = []

    def logged_step(state, batch):
        t0 = clock.now()
        state, metrics = step_fn(state, batch)
        step = int(state["step"])
        if step % tcfg.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({clock.now() - t0:.2f}s)")
        return state, metrics

    state, metrics, monitor = run_resilient(
        tcfg.steps, state=state, data=data, step_fn=logged_step,
        ckpt=ckpt, save_every=tcfg.save_every,
        policy=RestartPolicy(), fail_injector=fail_injector, log=log,
        clock=clock)
    return state, losses, monitor
