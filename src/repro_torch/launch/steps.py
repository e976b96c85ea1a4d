"""The train and serve steps and their example arguments for every
(arch x shape) cell, the reference's ``repro.launch.steps`` for one
process per rank.

``make_step_and_specs(cfg, mesh, shape)`` returns ``(step, example_args,
act_spec)``. The step runs on this rank's local tensors with explicit
collectives over the mesh (``distributed/step_plan.py``): the train step
takes ``(state, batch)``, the prefill / decode step ``(params, tokens,
cache)``, an encoder's ``encode`` step ``(params, inputs)``, each tensor
this rank's block under the reference's specs. An example argument
(:class:`ExampleArg`) carries a tensor's global shape, dtype and spec
and this rank's local shape, and allocates nothing (``.meta()`` is a
meta tensor of the local shape): the port's counterpart of a sharded
``ShapeDtypeStruct``. The kernels run on the local shards, as they run
unsharded: flash attention (and its backward) at the local head counts,
decode attention on the local heads of a head-sharded cache, the split-KV
decode on a sequence-sharded one.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.sharding import (NamedSharding, activation_sharding,
                                    axes_of, batch_sharding,
                                    cache_shardings, hidden_spec,
                                    gather_tensor, param_shardings,
                                    resolve_kv_mode, shard_tensor,
                                    split_kv_enabled)
from ..distributed.step_plan import StepPlan
from ..models import build_model
from ..models.moe import _group_count
from ..training import optimizer as opt
from ..training.tree import tree_flatten, tree_map, tree_unflatten


class ExampleArg(NamedTuple):
    """A step argument's global shape, dtype and spec, and this rank's
    local shape."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple
    local_shape: tuple

    def meta(self) -> torch.Tensor:
        """This rank's block as a meta tensor: shape and dtype, no data."""
        return torch.empty(self.local_shape, dtype=self.dtype, device="meta")


def _example(t, sharding: NamedSharding) -> ExampleArg:
    shape = tuple(t.shape)
    return ExampleArg(shape, t.dtype, sharding.spec,
                      sharding.local_shape(shape))


def _examples(tree, shardings):
    return tree_map(_example, tree, shardings)


def _meta_tree(fn) -> dict:
    """The tree ``fn(device)`` would build, as meta tensors: built under a
    fake-tensor mode, so nothing is allocated or drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn("cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _input_struct(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    """Token ids, or the modality stub's float embeddings [audio]."""
    if cfg.family == "audio":
        return torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                           device="meta")
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def param_shapes(model) -> dict:
    """The params of ``model`` as meta tensors (shared: do not modify)."""
    return _param_shapes(model.cfg)


@lru_cache(maxsize=None)
def _param_shapes(cfg) -> dict:
    # a full-size config's fake init takes seconds; each step of a cell
    # asks for it
    return _meta_tree(lambda device: build_model(cfg).init(device=device))


def state_shapes(model) -> dict:
    params = param_shapes(model)
    return {"params": params,
            "m": tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                device="meta"), params),
            "v": tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                device="meta"), params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_shardings(model, mesh) -> dict:
    psh = param_shardings(param_shapes(model), mesh)
    return {"params": psh, "m": psh, "v": psh,
            "step": NamedSharding(mesh, ())}


def _specs(shardings: dict) -> dict:
    return tree_map(lambda s: s.spec, shardings)


def _check_moe_groups(cfg, plan: StepPlan, inputs) -> None:
    """MoE capacity is per dispatch group: a rank's groups must be the
    global batch's groups, or tokens would drop differently."""
    if cfg.moe is None or plan.n_data == 1:
        return
    T = inputs.shape[0] * inputs.shape[1]
    gs = cfg.moe.group_size
    G, G_all = _group_count(T, gs), _group_count(T * plan.n_data, gs)
    if G * plan.n_data != G_all:
        raise ValueError(
            f"MoE dispatch groups straddle ranks: {T} tokens a rank make "
            f"{G} groups of group_size {gs}, the global batch {G_all}; "
            "pick a batch whose per-rank token count is a multiple of "
            "group_size")


class TrainStep:
    """``step(state, batch) -> (state, metrics)`` on this rank's shards;
    :meth:`loss_and_grads` is its first half (the loss, metrics and this
    rank's blocks of the full gradients)."""

    def __init__(self, cfg, mesh, *, opt_cfg, seq_shard: bool):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.act_spec = hidden_spec(mesh, seq_shard=seq_shard)
        self.model = build_model(cfg)
        self.shardings = state_shardings(self.model, mesh)
        self.plan = StepPlan(cfg, mesh, _specs(self.shardings["params"]),
                             seq_shard=seq_shard)
        self._loss = build_model(self.plan.cfg_local).loss

    def loss_and_grads(self, params: dict, inputs, targets):
        plan = self.plan
        _check_moe_groups(self.cfg, plan, inputs)
        items = tree_flatten(params)
        leaves = [t.detach().requires_grad_() for _, t in items]
        local = tree_unflatten([(p, t) for (p, _), t in zip(items, leaves)])
        with activation_sharding(self.act_spec, plan):
            full = plan.gather_params(local)
            loss, metrics = self._loss(full, inputs, targets)
            grads = torch.autograd.grad(
                loss, leaves, grad_outputs=torch.full_like(loss,
                                                           1.0 / plan.world),
                allow_unused=True)
        grads = tree_unflatten([(p, torch.zeros_like(t) if g is None else g)
                                for (p, t), g in zip(items, grads)])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                plan.finish_grads(grads))

    def __call__(self, state: dict, batch: dict):
        loss, metrics, grads = self.loss_and_grads(
            state["params"], batch["inputs"], batch["targets"])
        new_state, om = opt.apply_updates(
            {k: state[k] for k in ("params", "m", "v", "step")}, grads,
            self.opt_cfg, grad_norm=self.plan.global_norm(grads))
        return new_state, {"loss": loss, **metrics, **om}


def build_train_step(cfg: ModelConfig, mesh, *,
                     opt_cfg: Optional[opt.AdamWConfig] = None,
                     seq_shard: bool = True):
    """(step, model, state shardings, act_spec)."""
    step = TrainStep(cfg, mesh, opt_cfg=opt_cfg or opt.AdamWConfig(),
                     seq_shard=seq_shard)
    return step, step.model, step.shardings, step.act_spec


def train_example_args(cfg, model, mesh, shape: ShapeSpec, ssh):
    state = _examples(state_shapes(model), ssh)
    B, S = shape.global_batch, shape.seq_len
    inp = _input_struct(cfg, B, S)
    tgt = torch.empty((B, S), dtype=torch.int32, device="meta")
    batch = {"inputs": _example(inp, batch_sharding(mesh, inp.shape)),
             "targets": _example(tgt, batch_sharding(mesh, tgt.shape))}
    return state, batch


# recurrent state the mixers hold whole (their specs shard it over model)
_MIXER_STATES = ("conv", "ssm", "wkv", "shift1", "shift2")


class ServeStep:
    """A prefill, decode or encode step on this rank's shards. The mixers'
    recurrent states (the Mamba2 conv and SSM states, RWKV-6's shifts and
    WKV state) are stored under the reference's specs but computed whole:
    their blocks over ``model`` are gathered before the step, and each
    rank keeps its own block of the updated state. The KV cache is read
    as stored: a rank's heads, or its sequence block."""

    def __init__(self, cfg, mesh, shape: ShapeSpec, *, kv_mode: str,
                 serve_fsdp: bool):
        self.cfg, self.mesh, self.kind = cfg, mesh, shape.kind
        self.model = build_model(cfg)
        self.act_spec = hidden_spec(mesh, seq_shard=shape.kind != "decode")
        self.psh = param_shardings(param_shapes(self.model), mesh,
                                   fsdp=serve_fsdp)
        self.cache_info = None
        self.kv_mode = None
        kv_spec = ()
        self.use_split = False
        if not cfg.encoder_only:
            cache = _meta_tree(lambda device: self.model.init_cache(
                batch=shape.global_batch, max_len=shape.seq_len,
                device=device))
            m_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
            self.kv_mode = kv_mode
            if kv_mode == "auto" and not cfg.attn_free:
                self.kv_mode = resolve_kv_mode(cfg, mesh)
            csh = cache_shardings(cache, mesh, cfg, kv_mode=self.kv_mode)
            self.cache_info = (cache, csh)
            kv_spec = csh["k"].spec if "k" in csh else ()
            self.use_split = (shape.kind == "decode" and self.kv_mode == "seq"
                              and not cfg.attn_free
                              and shape.seq_len % m_size == 0)
        self.plan = StepPlan(cfg, mesh, _specs(self.psh),
                             seq_shard=shape.kind != "decode",
                             kv_mode=self.kv_mode, kv_spec=kv_spec)
        self.local_model = build_model(self.plan.cfg_local)

    @torch.no_grad()
    def __call__(self, params: dict, tokens, cache: Optional[dict] = None):
        plan = self.plan
        _check_moe_groups(self.cfg, plan, tokens)
        with activation_sharding(self.act_spec, plan):
            full = plan.gather_params(params)
            if self.cfg.encoder_only:
                return self.local_model.encode(full, tokens)
            specs = _specs(self.cache_info[1])
            run = {k: _gather_model(t, specs[k], self.mesh)
                   if k in _MIXER_STATES else t for k, t in cache.items()}
            if self.kind == "prefill":
                logits, out = self.local_model.prefill(full, tokens, run)
            else:
                with split_kv_enabled(self.use_split,
                                      self.mesh if self.use_split else None):
                    logits, out = self.local_model.decode_step(full, tokens,
                                                               run)
        for k in _MIXER_STATES:
            if k in cache:
                cache[k].copy_(_shard_model(out[k], specs[k], self.mesh))
        return logits, {**cache, "index": out["index"]}


def _model_only(spec) -> tuple:
    return tuple("model" if "model" in axes_of(e) else None for e in spec)


def _gather_model(t, spec, mesh):
    return gather_tensor(t, _model_only(spec), mesh)


def _shard_model(t, spec, mesh):
    return shard_tensor(t, _model_only(spec), mesh)


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                     kv_mode: str = "auto", serve_fsdp: bool = False):
    """Prefill or decode step per the shape's kind (encoder-only configs:
    encode). ``serve_fsdp=False``: weights shard over ``model`` only, so a
    step gathers no parameter over data. Returns (step, model, param
    shardings, (cache shapes, cache shardings) or None, act_spec)."""
    step = ServeStep(cfg, mesh, shape, kv_mode=kv_mode,
                     serve_fsdp=serve_fsdp)
    return step, step.model, step.psh, step.cache_info, step.act_spec


def serve_example_args(cfg, model, mesh, shape: ShapeSpec, psh, cache_info):
    params = _examples(param_shapes(model), psh)
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_only:
        inp = _input_struct(cfg, B, S)
        return params, _example(inp, batch_sharding(mesh, inp.shape))
    cache_shapes, csh = cache_info
    tok = (_input_struct(cfg, B, S) if shape.kind == "prefill"
           else torch.empty((B, 1), dtype=torch.int32, device="meta"))
    return (params, _example(tok, batch_sharding(mesh, tok.shape)),
            _examples(cache_shapes, csh))


def make_step_and_specs(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                        kv_mode: str = "auto", seq_shard: bool = True,
                        serve_fsdp: bool = False,
                        opt_cfg: Optional[opt.AdamWConfig] = None):
    """The cell's step: (step, example_args, act_spec). ``opt_cfg`` is the
    train step's AdamW (default ``AdamWConfig()``, as the reference's)."""
    if shape.kind == "train":
        step, model, ssh, act_spec = build_train_step(
            cfg, mesh, opt_cfg=opt_cfg, seq_shard=seq_shard)
        args = train_example_args(cfg, model, mesh, shape, ssh)
    else:
        step, model, psh, cache_info, act_spec = build_serve_step(
            cfg, mesh, shape, kv_mode=kv_mode, serve_fsdp=serve_fsdp)
        args = serve_example_args(cfg, model, mesh, shape, psh, cache_info)
    return step, args, act_spec
