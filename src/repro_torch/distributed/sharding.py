"""Sharding rules of the port: DP / FSDP / TP / EP / SP by parameter path,
the reference's ``repro.distributed.sharding`` for one process per rank.

Conventions (single- or multi-pod; D = the compound data axes, M =
"model"), as in the reference:
  * weights: TP dim over M, FSDP dim over D; optimizer states shard as
    the params do.
  * activations between blocks: batch over D, sequence over M (sequence
    parallelism) under ``hidden_spec(seq_shard=True)``.
  * MoE experts over M (EP) when M divides the expert count, else the
    expert FFN's hidden dim over M; the router replicated.
  * KV caches: batch over D; heads over M ("head") or sequence over M
    ("seq": split-KV decode across ranks).

A spec is a tuple with one entry per dim (None, an axis name, or a tuple
of names), trailing Nones trimmed as ``PartitionSpec`` trims them; a
tree of specs is a nested dict shaped like the tree of tensors, whose
paths are the ``"/"``-joined dict keys (``layers/attn/wq``).
``sanitize_spec`` drops a sharding the mesh does not divide, with a
one-time :class:`ShardingDropWarning`; ``param_specs`` / ``cache_specs``
reproduce the reference's specs, drops included. ``NamedSharding`` pairs
a spec with its ``DeviceMesh`` and gives a rank's local shape;
:func:`shard_tensor` cuts this rank's block of a whole tensor and
:func:`gather_tensor` makes the whole tensor from the blocks.

The reference constrains activations with GSPMD; the port runs plain
local tensors with explicit collectives. :class:`activation_sharding`
installs the between-blocks spec and, for a sharded step, its runtime
(``distributed/step_plan.py::StepPlan``). The models call the hooks below
at block boundaries; with no runtime installed every hook returns its
input, so every unsharded path is unchanged.

Also here, from the tensor-parallel serving layout: :func:`axis_size` /
:func:`axis_rank`, :func:`undivided_dims` (``MeshLayout`` raises where
the reference would replicate), and the split-KV decode switch
(:class:`split_kv_enabled`).
"""
from __future__ import annotations

import contextvars
import re
import warnings
from typing import NamedTuple, Optional

import torch

from ..launch.mesh import data_axes


def mesh_sizes(mesh) -> dict:
    """``{axis name: width}`` of a ``DeviceMesh`` (or of any object with
    ``.shape`` and ``.mesh_dim_names``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """Width of ``mesh``'s axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on ``mesh``'s axis ``name``."""
    return mesh.get_local_rank(name)


def axes_of(entry) -> tuple:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes_of(axes):
        n *= sizes[a]
    return n


def undivided_dims(shape, spec, mesh) -> list[int]:
    """Indices of the dims of ``shape`` whose mesh axes in ``spec`` do not
    divide them."""
    return [i for i, (dim, axes) in enumerate(zip(shape, spec))
            if axes is not None and dim % _axis_size(mesh, axes)]


def trim(entries) -> tuple:
    """A spec from per-dim entries, as ``PartitionSpec`` writes it: a
    one-axis tuple as its name, trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# -------------------------------------------------------- parameter rules --

def _param_rules(D, M):
    """(regex over the param path) -> spec. First match wins. The
    reference's table (``repro/distributed/sharding.py:_param_rules``)."""
    return [
        # embeddings / head: the embedding table shards on d_model only
        (r"^embed$",                 (None, D)),
        (r"^head$",                  (D, M)),
        # MoE (stacked [L, E, ...]); the experts are chosen in param_specs
        (r"moe/router$",             (None, D, None)),
        (r"moe/(w_gate|w_up)$",      (None, M, D, None)),
        (r"moe/w_down$",             (None, M, None, D)),
        (r"moe/shared_gate$",        ()),
        (r"moe/shared/(w_gate|w_up)$", (None, D, M)),
        (r"moe/shared/w_down$",      (None, M, D)),
        # attention (stacked [L, d, h*hd] or shared [d, h*hd])
        (r"layers/attn/(wq|wk|wv)$", (None, D, M)),
        (r"layers/attn/wo$",         (None, M, D)),
        (r"shared/attn/(wq|wk|wv)$", (D, M)),
        (r"shared/attn/wo$",         (M, D)),
        # dense FFN
        (r"layers/ffn/(w_gate|w_up)$", (None, D, M)),
        (r"layers/ffn/w_down$",      (None, M, D)),
        (r"shared/ffn/(w_gate|w_up)$", (D, M)),
        (r"shared/ffn/w_down$",      (M, D)),
        # mamba2
        (r"mamba/in_proj$",          (None, D, None)),
        (r"mamba/out_proj$",         (None, M, D)),
        (r"mamba/(conv_w|conv_b|A_log|dt_bias|D|gate_norm|norm)$", ()),
        # rwkv6
        (r"layers/(wr|wk|wv|wg)$",   (None, D, M)),
        (r"layers/wo$",              (None, M, D)),
        (r"layers/wk_ffn$",          (None, D, M)),
        (r"layers/wv_ffn$",          (None, M, D)),
        (r"layers/wr_ffn$",          (None, D, M)),
        (r"layers/(w_base|w_lora_a|w_lora_b|u|mix|mix_ffn)$", ()),
        # everything else (norms, scales, biases): replicated
        (r".*",                      ()),
    ]


class ShardingDropWarning(UserWarning):
    """A requested sharding was turned into replication."""


_SANITIZE_WARNED: set = set()


def sanitize_spec(spec, shape, mesh, *, dropped: Optional[list] = None
                  ) -> tuple:
    """Drop the sharding of any dim that its mesh axes do not divide: that
    dim replicates. Each distinct (dim, size, axes) drop warns once with a
    :class:`ShardingDropWarning`; ``dropped`` (a list) receives the
    indices of the dims that replicated."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is not None and dim % _axis_size(mesh, ax):
            if dropped is not None:
                dropped.append(i)
            key = (i, dim, axes_of(ax) if not isinstance(ax, str) else ax)
            if key not in _SANITIZE_WARNED:
                _SANITIZE_WARNED.add(key)
                warnings.warn(
                    f"sanitize_spec: dim {i} (size {dim}) is not divisible "
                    f"by mesh axes {ax!r} (size {_axis_size(mesh, ax)}); "
                    "dropping the sharding — this dim will REPLICATE",
                    ShardingDropWarning, stacklevel=2)
            ax = None
        out.append(ax)
    return trim(out)


def _walk(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, as a dict of the same shape."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_specs(params, mesh, *, fsdp: bool = True) -> dict:
    """The spec of every leaf of ``params`` (tensors, meta tensors or
    anything with ``.shape`` and ``.ndim``). ``fsdp=False`` (serving):
    weights shard over the model axis only and replicate over data."""
    D, M = (data_axes(mesh) if fsdp else None), "model"
    rules = [(re.compile(pat), spec) for pat, spec in _param_rules(D, M)]
    m_size = mesh_sizes(mesh)["model"]

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        # MoE experts: EP over model when E divides, else TP on d_ff
        if re.search(r"moe/(w_gate|w_up)$", path):
            spec = ((None, M, D, None) if shape[1] % m_size == 0
                    else (None, None, D, M))
            return sanitize_spec(spec, shape, mesh)
        if re.search(r"moe/w_down$", path):
            spec = ((None, M, None, D) if shape[1] % m_size == 0
                    else (None, None, M, D))
            return sanitize_spec(spec, shape, mesh)
        for pat, spec in rules:
            if pat.search(path):
                if len(spec) > len(shape):
                    return ()
                return sanitize_spec(spec, shape, mesh)
        return ()

    return _walk(params, spec_for)


class NamedSharding(NamedTuple):
    """A spec on a mesh: where a tensor of a given global shape lives."""
    mesh: object
    spec: tuple

    def local_shape(self, shape) -> tuple:
        """This rank's shard shape of a tensor of global ``shape``."""
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        return tuple(d // _axis_size(self.mesh, ax)
                     for d, ax in zip(shape, entries))



def param_shardings(params, mesh, *, fsdp: bool = True) -> dict:
    return _walk(param_specs(params, mesh, fsdp=fsdp),
                 lambda _, s: NamedSharding(mesh, s))


# ------------------------------------------------------------- cache rules --

def resolve_kv_mode(cfg, mesh, kv_mode: str = "auto") -> str:
    """'auto' = heads over model when n_kv_heads divides the model-axis
    width, else the sequence (split-KV)."""
    if kv_mode == "auto":
        return ("head" if cfg.n_kv_heads % mesh_sizes(mesh)["model"] == 0
                else "seq")
    if kv_mode not in ("head", "seq"):
        raise ValueError(f"kv_mode must be head, seq or auto: {kv_mode!r}")
    return kv_mode


def cache_specs(cache, mesh, cfg, *, kv_mode: str = "auto") -> dict:
    """Specs of a cache tree: K/V ``[L, B, Smax, Hkv, hd]`` by ``kv_mode``,
    the SSM / conv / WKV / shift states over model, ``index`` replicated."""
    D = data_axes(mesh)
    kv_mode = resolve_kv_mode(cfg, mesh, kv_mode)

    def spec_for(name, leaf):
        if name in ("k", "v"):
            spec = ((None, D, None, "model", None) if kv_mode == "head"
                    else (None, D, "model", None, None))
        elif name == "ssm":             # [L, B, nh, hd, N]
            spec = (None, D, "model", None, None)
        elif name == "conv":            # [L, B, K-1, conv_dim]
            spec = (None, D, None, "model")
        elif name == "wkv":             # [L, B, H, hd, hd]
            spec = (None, D, None, "model", None)
        elif name.startswith("shift"):  # [L, B, D]
            spec = (None, D, "model")
        else:
            return ()                   # index etc.
        return sanitize_spec(spec, tuple(leaf.shape), mesh)

    return _walk(cache, spec_for)


def cache_shardings(cache, mesh, cfg, *, kv_mode: str = "auto") -> dict:
    return _walk(cache_specs(cache, mesh, cfg, kv_mode=kv_mode),
                 lambda _, s: NamedSharding(mesh, s))


# ------------------------------------------------------------- input rules --

def batch_spec(mesh) -> tuple:
    """Token batches: the batch dim over the compound data axes (the other
    dims replicated, trimmed as ``PartitionSpec`` trims them)."""
    return trim((data_axes(mesh),))


def batch_sharding(mesh, shape) -> NamedSharding:
    """The batch spec sanitized against ``shape`` (batch 1 replicates)."""
    return NamedSharding(mesh, sanitize_spec(batch_spec(mesh),
                                             tuple(shape), mesh))


def hidden_spec(mesh, *, seq_shard: bool = True) -> tuple:
    return trim((data_axes(mesh), "model" if seq_shard else None, None))


# ----------------------------------------------------- shards of a tensor --

def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    contiguous copy). A dim over compound axes is cut outermost first."""
    for dim, entry in enumerate(spec):
        for a in axes_of(entry):
            n = axis_size(mesh, a)
            w = t.shape[dim] // n
            # the outer axes' cut is taken first, so each inner axis cuts
            # the block its outer coordinate left
            t = t.narrow(dim, axis_rank(mesh, a) * w, w)
    return t.contiguous()


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block ``t`` (every rank calls it:
    one all-gather per sharded axis, innermost first). No autograd."""
    import torch.distributed as dist
    for dim, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            group = mesh.get_group(a)
            n = dist.get_world_size(group)
            if n == 1:
                continue
            x = t.movedim(dim, 0).contiguous()
            out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            t = out.movedim(0, dim)
    return t.contiguous()


def shard_tree(tree, specs, mesh) -> dict:
    """:func:`shard_tensor` over a tree of tensors and its specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, specs, mesh)


def gather_tree(tree, specs, mesh) -> dict:
    """:func:`gather_tensor` over a tree of shards and its specs."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    return gather_tensor(tree, specs, mesh)


# --------------------------------------------------- activation constraints --

class _Act(NamedTuple):
    spec: Optional[tuple]
    plan: object


_ACT: contextvars.ContextVar = contextvars.ContextVar("act_spec",
                                                      default=None)


class activation_sharding:
    """Context manager installing the between-blocks hidden-state spec
    and, for a sharded step, its runtime ``plan``
    (``distributed/step_plan.py::StepPlan``), whose collectives the hooks
    below run. With no plan the hooks return their inputs."""

    def __init__(self, spec: Optional[tuple], plan=None):
        self.value = _Act(spec, plan)

    def __enter__(self):
        self.tok = _ACT.set(self.value)
        return self

    def __exit__(self, *exc):
        _ACT.reset(self.tok)
        return False


def current_activation():
    """The installed (spec, plan), or None."""
    return _ACT.get()


def active_plan():
    """The installed sharded step's runtime, or None."""
    act = _ACT.get()
    return None if act is None else act.plan


def hidden_constraint(y: torch.Tensor, block: str = "ffn") -> torch.Tensor:
    """A block's output (``block``: "attn", "ffn", "moe", "mamba",
    "rwkv_tm" or "rwkv_cm") into the
    between-blocks layout: a tensor-parallel block's partial sums summed
    over ``model`` (reduce-scattered along the sequence under
    ``seq_shard``); a block computed whole keeps its own sequence chunk
    under ``seq_shard``."""
    plan = active_plan()
    return y if plan is None else plan.block_output(y, block)


def hidden_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence of a sequence-sharded hidden state (all-gathered
    over ``model`` under ``seq_shard``), as a block's input needs it."""
    plan = active_plan()
    return x if plan is None else plan.seq_gather(x)


def hidden_enter(x: torch.Tensor) -> torch.Tensor:
    """The embedding's output into the between-blocks layout: this rank's
    sequence chunk under ``seq_shard``."""
    plan = active_plan()
    return x if plan is None else plan.seq_chunk(x)


def logits_constraint(y: torch.Tensor) -> torch.Tensor:
    """Serving logits of a vocabulary-sharded head, gathered along V."""
    plan = active_plan()
    return y if plan is None else plan.gather_vocab(y)


def gather_layer(lp: dict, prefix: str = "layers", *,
                 stacked: bool = True) -> dict:
    """One layer's parameters (the subtree under ``prefix``, a layer of a
    stacked tree unless ``stacked`` is False) as its compute needs them:
    each leaf gathered over the axes the step does not keep sharded (the
    FSDP data axes, and ``model`` where the block computes whole)."""
    plan = active_plan()
    return lp if plan is None else plan.gather_layer(lp, prefix, stacked)


def tp_slice(x: torch.Tensor, block: str, dim: int = -1) -> torch.Tensor:
    """This rank's block of a whole ``x`` along ``dim`` where ``block``
    is tensor-parallel (the local columns a row-parallel product reads)."""
    plan = active_plan()
    return x if plan is None else plan.tp_slice(x, block, dim)


def tp_gather(x: torch.Tensor, block: str, dim: int = -1) -> torch.Tensor:
    """The whole of a column-sharded ``x`` along ``dim`` where ``block``
    is tensor-parallel."""
    plan = active_plan()
    return x if plan is None else plan.tp_gather(x, block, dim)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank statistic over the data axes (the MoE
    load-balancing loss, a mean over dispatch groups)."""
    plan = active_plan()
    return x if plan is None else plan.data_mean(x)


# ------------------------------------------------------- split-KV switch --

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
