"""Device layouts of the paged serving state, the reference's
``repro.serving.layout`` for one process per rank.

``PagedBatcher`` / ``PagedKVCache`` bookkeeping (block tables, refcounts,
prefix-cache hash chains, admission) reasons about logical block ids and
is the same on every device; what varies is where the tensors live and
which collectives a step issues. A layout owns exactly that:

  * ``DeviceLayout`` — one device: the params and the pool as they are,
    the model's own paged entry points.
  * ``MeshLayout(cfg, mesh)`` — head-wise tensor parallelism over the
    ``model`` axis of a ``torch.distributed`` ``DeviceMesh``. Every rank
    runs the same batcher bookkeeping, deterministically, on plain local
    tensors: its column slices of the weights and its KV heads of the
    pool. The four paged entry points run the unchanged transformer code
    on ``cfg_local`` (the local head counts, ``d_head`` pinned) with
    explicit collectives on the ``model`` group.

Sharding plan (TP = the ``model`` axis width):

  column-sharded (this rank's slice)         replicated
  -----------------------------------------  -------------------------
  wq/wk/wv          output cols (heads)      embed table, all norms
  wo                output cols (d_model/TP) int8 pool scale planes
  w_gate/w_up       output cols (d_ff/TP)    tied head (the embedding)
  w_down            output cols (d_model/TP) block tables / lengths
  head (untied)     output cols (vocab/TP)   draft lanes' params (spec)
  KV pool k/v       axis 3 (KV heads)

Every matrix splits on its OUTPUT axis and ``layers.tp_all_gather``
concatenates the slices in rank order, so TP is an execution schedule, not
a numerics change: each output column is one rank's full-depth reduction,
and greedy streams equal the single-device batcher's bit for bit when the
local products round as the full ones do. A ``QuantWeight``'s codes and
scales both split along N, so W4A16's nibble packing along K is never cut.
Per decode step and layer: two gathers of ``[B, 1, d]`` around wo, a
gather of ``[B, 1, d_ff]`` and one of ``[B, 1, d]`` around w_down, the
int8 pool's max of ``[B]`` slot amaxes per tensor; one gather of the
untied head's ``[B, 1, V]`` logits per step.

Under NCCL the batcher's decode loops are CUDA graphs with the collectives
inside (``capturable``). Gloo's collectives cannot be recorded in a graph,
so under gloo (several ranks sharing a card, or CPU ranks) the loops run
their bodies eagerly: the caller's choice of backend decides it, and
``stats()`` reports it.
"""
from __future__ import annotations

import re
from typing import Callable, NamedTuple

import torch.distributed as dist

from ..core.partition import QuantWeight
from ..distributed.sharding import axis_rank, axis_size, undivided_dims
from ..models import transformer

TP_AXIS = "model"

# param paths whose LAST axis is an output-channel axis sharded over TP
_COL_SHARDED = re.compile(r"(attn/(wq|wk|wv|wo)|ffn/(w_gate|w_up|w_down))$")


class PagedSteps(NamedTuple):
    """The four paged entry points as a layout runs them, each with the
    model's signature (``hetero_ctx=`` included)."""
    paged_prefill: Callable
    paged_decode_step: Callable
    mixed_step: Callable
    paged_verify: Callable


class DeviceLayout:
    """Single-device identity layout."""

    tp = 1
    capturable = True

    def place_params(self, params: dict) -> dict:
        return params

    def init_pool(self, cfg, **kw) -> dict:
        """``transformer.init_paged_cache(cfg, **kw)``: the whole pool."""
        return transformer.init_paged_cache(cfg, **kw)

    def step_fns(self, model) -> PagedSteps:
        """The model's own paged entry points."""
        return PagedSteps(model.paged_prefill, model.paged_decode_step,
                          model.mixed_step, model.paged_verify)


class MeshLayout(DeviceLayout):
    """Head-wise tensor-parallel layout over ``mesh``'s ``model`` axis."""

    def __init__(self, cfg, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if TP_AXIS not in names:
            raise ValueError(f"mesh {names} has no 'model' axis")
        tp = axis_size(mesh, TP_AXIS)
        if cfg.moe is not None or cfg.ssm is not None or cfg.rwkv is not None:
            raise ValueError("tensor-parallel serving supports the dense "
                             "transformer family only")
        for dim, name in ((cfg.n_heads, "n_heads"),
                          (cfg.n_kv_heads, "n_kv_heads"),
                          (cfg.d_model, "d_model"),
                          (cfg.d_ff, "d_ff")):
            if dim % tp:
                raise ValueError(
                    f"cfg.{name}={dim} is not divisible by the model-axis "
                    f"size {tp}; pick a TP width that divides it")
        if not cfg.tie_embeddings and cfg.vocab_size % tp:
            raise ValueError(
                f"untied head: vocab_size={cfg.vocab_size} is not divisible "
                f"by the model-axis size {tp}")
        self.cfg = cfg
        self.mesh = mesh
        self.tp = tp
        self.rank = axis_rank(mesh, TP_AXIS)
        self.group = mesh.get_group(TP_AXIS)
        # gloo's collectives cannot be recorded in a CUDA graph
        self.capturable = dist.get_backend(self.group) == "nccl"
        # each rank runs the unchanged transformer over its own heads;
        # head_dim derives from d_model / n_heads when d_head is 0, so it
        # is pinned before the head counts shrink
        self.cfg_local = cfg.with_(n_heads=cfg.n_heads // tp,
                                   n_kv_heads=cfg.n_kv_heads // tp,
                                   d_head=cfg.head_dim)

    def _col_sharded(self, path: str) -> bool:
        return (_COL_SHARDED.search(path) is not None
                or (path == "head" and not self.cfg.tie_embeddings))

    def shard_plan(self, params: dict) -> dict[str, bool]:
        """Per tree path (``layers/attn/wq``; a QuantWeight's ``/wq`` and
        ``/scale``), whether the leaf is column-sharded over ``model``
        (True) or replicated (False)."""
        plan = {}

        def walk(tree, prefix):
            for key, leaf in tree.items():
                path = f"{prefix}{key}"
                if isinstance(leaf, dict):
                    walk(leaf, path + "/")
                elif isinstance(leaf, QuantWeight):
                    plan[path + "/wq"] = plan[path + "/scale"] = \
                        self._col_sharded(path)
                else:
                    plan[path] = self._col_sharded(path)

        walk(params, "")
        return plan

    def _cols(self, t, path: str):
        """This rank's contiguous block of ``t``'s last axis, in rank
        order (a copy unless the block is the whole axis)."""
        spec = (None,) * (t.ndim - 1) + (TP_AXIS,)
        if undivided_dims(t.shape, spec, self.mesh):
            raise ValueError(f"{path}: last axis {t.shape[-1]} is not "
                             f"divisible by the model-axis size {self.tp}")
        w = t.shape[-1] // self.tp
        return t[..., self.rank * w:(self.rank + 1) * w].contiguous()

    def place_params(self, params: dict) -> dict:
        """This rank's params: its column slice of each column-sharded
        leaf (a QuantWeight's codes and scales both), the replicated
        leaves shared with ``params``. Drop ``params`` afterwards to free
        the other ranks' columns."""
        def place(tree, prefix):
            out = {}
            for key, leaf in tree.items():
                path = f"{prefix}{key}"
                if isinstance(leaf, dict):
                    out[key] = place(leaf, path + "/")
                elif not self._col_sharded(path):
                    out[key] = leaf
                elif isinstance(leaf, QuantWeight):
                    out[key] = QuantWeight(self._cols(leaf.wq, path),
                                           self._cols(leaf.scale, path),
                                           leaf.fmt, leaf.k)
                else:
                    out[key] = self._cols(leaf, path)
            return out

        return place(params, "")

    def init_pool(self, cfg, **kw) -> dict:
        """The pool at this rank's KV heads (axis 3): allocated at the
        local width, never sliced from a full one. The int8 scale planes
        are whole on every rank (one scalar per slot covers all heads)."""
        return transformer.init_paged_cache(self.cfg_local, **kw)

    def step_fns(self, model) -> PagedSteps:
        """The four paged entry points on ``cfg_local`` and the ``model``
        group. A ``hetero_ctx`` is refused: the hetero engine and the mesh
        are separate axes of the machine."""
        def bind(fn):
            def step(*args, hetero_ctx=None, **kw):
                _no_ctx(hetero_ctx)
                return fn(*args, cfg=self.cfg_local, tp_group=self.group,
                          **kw)
            return step

        return PagedSteps(bind(transformer.paged_prefill),
                          bind(transformer.paged_decode_step),
                          bind(transformer.mixed_step),
                          bind(transformer.paged_verify))


def _no_ctx(hetero_ctx):
    if hetero_ctx is not None:
        raise ValueError("tensor-parallel serving does not compose with a "
                         "HeteroCtx engine mode (engine_mode must be None "
                         "when a mesh is given)")


def make_layout(cfg, mesh) -> DeviceLayout:
    return DeviceLayout() if mesh is None else MeshLayout(cfg, mesh)
