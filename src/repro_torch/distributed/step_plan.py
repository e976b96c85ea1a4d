"""The runtime of a sharded step on one rank: the reference's GSPMD
partitioning of a train / serve step, as plain local tensors with
explicit collectives (launch/steps.py builds it).

Every leaf of the params (and of the optimizer's moments) is stored as
this rank's block under ``param_specs``. Where the step uses a leaf it is
gathered, with an autograd all-gather whose backward reduce-scatters the
gradient, over every axis the compute does not keep sharded: the FSDP
data axes always, and ``model`` where the block computes whole. A layer's
leaves are gathered inside the layer (``sharding.gather_layer``), so under
remat the gather is recomputed in backward and only one layer's weights
are whole at a time; the rest at the top of the step.

Tensor parallelism over ``model``: attention on this rank's heads
(``cfg_local``; the transformer's and zamba2's shared block), the FFN on
its d_ff columns, the MoE layer on its experts (EP) or on every expert's
d_ff columns, the Mamba2 mixer's ``out_proj`` on its rows (the scan
itself computes whole: ``in_proj`` is replicated over ``model``), RWKV-6's
time mix on its heads and its channel mix on its d_ff columns. Each
block's output is a partial sum that ``sharding.hidden_constraint`` sums
over ``model`` (or reduce-scatters along the sequence under
``seq_shard``, where ``hidden_gather`` all-gathers it again at the next
block's input). An untied head works on its vocabulary columns: its
cross-entropy takes the log-sum-exp across ranks (a max, then one sum),
its serving logits are gathered along V. A block whose heads (or width)
the model axis does not divide computes whole on every rank.

Gradients. Every rank computes the global loss (its token sums
all-reduced over the data axes) and backpropagates ``1 / world`` of it;
every collective's backward is its exact transpose, so each rank's
gradient is its share, and a leaf's full gradient is the sum over the
ranks holding a copy of its block: the gathers' reduce-scatters sum over
the axes a leaf is sharded on, and :meth:`StepPlan.finish_grads`
all-reduces over the axes it is replicated on. :meth:`global_norm` counts
each block once.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from ..launch.mesh import data_axes
from ..training.tree import tree_flatten, tree_unflatten
from .sharding import axes_of, axis_rank, mesh_sizes, trim


# ------------------------------------------------- autograd collectives --

def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x0.shape[0], *x0.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over ``group``, this rank's block along ``dim``. Gloo (which may
    hold CUDA tensors here) sums whole and cuts the block."""
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    w = x0.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = torch.empty((w, *x0.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x0, group=group)
    else:
        dist.all_reduce(x0, group=group)
        r = dist.get_rank(group)
        out = x0[r * w:(r + 1) * w]
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _alone(group) -> bool:
    """A one-rank group: each collective below is the identity there, so
    it returns its input and launches nothing."""
    return dist.get_world_size(group) == 1


def all_gather_dim(x, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order;
    the gradient is reduce-scattered."""
    return x if _alone(group) else _AllGather.apply(x, dim, group)


def reduce_scatter_dim(x, dim: int, group) -> torch.Tensor:
    """The sum over ``group``'s ranks, this rank's block along ``dim``; the
    gradient is all-gathered."""
    return x if _alone(group) else _ReduceScatter.apply(x, dim, group)


def all_reduce_sum(x, group) -> torch.Tensor:
    """The sum over ``group``; the gradient is all-reduced."""
    return x if _alone(group) else _AllReduce.apply(x, group)


# ----------------------------------------------------------------- plan --

# the tensor-parallel blocks by param path
_BLOCK_OF = (
    (re.compile(r"^(layers|shared)/attn/(wq|wk|wv|wo)$"), "attn"),
    (re.compile(r"^(layers|shared)/ffn/(w_gate|w_up|w_down)$"), "ffn"),
    (re.compile(r"^layers/moe/(w_gate|w_up|w_down|shared/"
                r"(w_gate|w_up|w_down))$"), "moe"),
    (re.compile(r"^mamba/out_proj$"), "mamba"),
    (re.compile(r"^layers/(wr|wk|wv|wg|wo)$"), "rwkv_tm"),
    (re.compile(r"^layers/(wk_ffn|wv_ffn|wr_ffn)$"), "rwkv_cm"),
    (re.compile(r"^head$"), "vocab"),
)
# the top-level subtrees each layer gathers for itself (gather_layer)
_LAYER_ROOTS = ("layers", "mamba", "shared")


def _has_model(spec, dim: int) -> bool:
    return dim < len(spec) and "model" in axes_of(spec[dim])


class StepPlan:
    """One rank's runtime of a sharded step over ``mesh``: the stored
    ``specs`` of the params (a tree like the params), what the compute
    keeps sharded, and the collectives of the hooks in
    ``distributed/sharding.py``.

    A block is tensor-parallel where its weights' specs shard the
    ``model`` axis on the dims the block splits (the output of a
    column-parallel product, the input of a row-parallel one) and the
    model axis divides its heads; else its leaves are gathered whole.
    ``kv_mode`` ("head" / "seq" / None for training) and ``kv_spec`` (the
    K cache's spec: is it really head- or sequence-sharded?) describe a
    serving step's cache. ``cfg_local`` is the config the model runs on
    this rank (the local head counts where attention is
    tensor-parallel)."""

    def __init__(self, cfg, mesh, specs: dict, *, seq_shard: bool = False,
                 kv_mode: str | None = None, kv_spec: tuple = ()):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.world = 1
        for n in self.sizes.values():
            self.world *= n
        self.data = data_axes(mesh)
        self.n_data = 1
        for a in self.data:
            self.n_data *= self.sizes[a]
        self.tp = self.sizes["model"]
        self.model_group = mesh.get_group("model")
        self.model_rank = axis_rank(mesh, "model")
        self.groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names}
        self.store = {"/".join(p): s for p, s in tree_flatten(specs)}
        self.seq_shard = bool(seq_shard)
        self.kv_seq = kv_mode == "seq" and _has_model(kv_spec, 2)
        self.tp_blocks = {
            "attn": self._attn_tp(kv_mode, _has_model(kv_spec, 3)),
            "ffn": cfg.moe is None and self._split("ffn", ("w_gate", 1),
                                                   ("w_up", 1),
                                                   ("w_down", 0)),
            "moe": self._moe_mode() if cfg.moe is not None else None,
            "mamba": _has_model(self.store.get("mamba/out_proj", ()), 1),
            "rwkv_tm": (cfg.rwkv is not None
                        and (cfg.d_model // cfg.rwkv.head_dim) % self.tp == 0
                        and all(_has_model(self.store.get(f"layers/{w}", ()),
                                           2) for w in ("wr", "wk", "wv",
                                                        "wg"))
                        and _has_model(self.store.get("layers/wo", ()), 1)),
            "rwkv_cm": (cfg.rwkv is not None
                        and _has_model(self.store.get("layers/wk_ffn", ()), 2)
                        and _has_model(self.store.get("layers/wr_ffn", ()), 2)
                        and _has_model(self.store.get("layers/wv_ffn", ()),
                                       1)),
            "vocab": (not cfg.tie_embeddings
                      and _has_model(self.store.get("head", ()), 1)),
        }
        self.compute = {p: self._compute_spec(p, sp)
                        for p, sp in self.store.items()}
        tp_attn = self.tp_blocks["attn"]
        self.cfg_local = cfg if not tp_attn or self.tp == 1 else cfg.with_(
            n_heads=cfg.n_heads // self.tp,
            n_kv_heads=cfg.n_kv_heads // self.tp, d_head=cfg.head_dim)

    def _root(self, block: str):
        """The prefix of a transformer block's leaves and its stacked-dim
        offset: the stacked ``layers/...`` or zamba2's ``shared/...``."""
        for root, off in (("layers", 1), ("shared", 0)):
            if any(p.startswith(f"{root}/{block}/") for p in self.store):
                return root, off
        return None, 0

    def _split(self, block: str, *dims) -> bool:
        """Every ``(leaf, dim)`` of ``block`` shards ``model`` on ``dim``
        (the unstacked dim)."""
        root, off = self._root(block)
        return root is not None and all(
            _has_model(self.store.get(f"{root}/{block}/{w}", ()), d + off)
            for w, d in dims)

    def _attn_tp(self, kv_mode, kv_heads_sharded: bool) -> bool:
        cfg = self.cfg
        return (cfg.rwkv is None
                and cfg.n_heads % self.tp == 0
                and cfg.n_kv_heads % self.tp == 0
                and (kv_mode is None
                     or (kv_mode == "head" and kv_heads_sharded))
                and self._split("attn", ("wq", 1), ("wk", 1), ("wv", 1),
                                ("wo", 0)))

    def _moe_mode(self):
        """"ep" (experts over model), "ff" (every expert's d_ff over model)
        or None (whole); a shared expert must shard on its d_ff too, else
        the layer computes whole."""
        s = self.store.get
        gate, down = s("layers/moe/w_gate", ()), s("layers/moe/w_down", ())
        if _has_model(gate, 1) and _has_model(s("layers/moe/w_up", ()), 1) \
                and _has_model(down, 1):
            mode = "ep"
        elif _has_model(gate, 3) and _has_model(s("layers/moe/w_up", ()), 3) \
                and _has_model(down, 2):
            mode = "ff"
        else:
            return None
        if self.cfg.moe.d_ff_shared and not (
                _has_model(s("layers/moe/shared/w_gate", ()), 2)
                and _has_model(s("layers/moe/shared/w_up", ()), 2)
                and _has_model(s("layers/moe/shared/w_down", ()), 1)):
            return None
        return mode

    def _block(self, path: str):
        for pat, block in _BLOCK_OF:
            if pat.search(path):
                return block
        return None

    def _compute_spec(self, path: str, spec: tuple) -> tuple:
        """``spec`` with the data axes dropped, and ``model`` unless the
        leaf's block is tensor-parallel."""
        keep_model = bool(self.tp_blocks.get(self._block(path)))
        return trim(("model" if keep_model and "model" in axes_of(e)
                     else None) for e in spec)

    # ---------------------------------------------------------- params --
    def gather_leaf(self, t: torch.Tensor, spec: tuple,
                    compute: tuple) -> torch.Tensor:
        """``t`` (its block under ``spec``) gathered over every axis that
        ``compute`` does not keep, innermost axis first, with autograd."""
        for dim, entry in enumerate(spec):
            keep = axes_of(compute[dim]) if dim < len(compute) else ()
            for a in reversed(axes_of(entry)):
                if a not in keep:
                    t = all_gather_dim(t, dim, self.groups[a])
        return t

    def gather_params(self, params: dict) -> dict:
        """Every leaf of ``params`` as the compute needs it, but the
        layers' (``layers``, ``mamba``, ``shared``), which
        :meth:`gather_layer` gathers inside each layer."""
        out = []
        for path, t in tree_flatten(params):
            name = "/".join(path)
            if path[0] not in _LAYER_ROOTS:
                t = self.gather_leaf(t, self.store[name], self.compute[name])
            out.append((path, t))
        return tree_unflatten(out)

    def gather_layer(self, lp: dict, prefix: str, stacked: bool) -> dict:
        """One layer's leaves under ``prefix`` (a stacked layer: the
        stacked axis indexed away)."""
        cut = 1 if stacked else 0

        def walk(tree, pre):
            if isinstance(tree, dict):
                return {k: walk(v, f"{pre}/{k}") for k, v in tree.items()}
            return self.gather_leaf(tree, self.store[pre][cut:],
                                    self.compute[pre][cut:])
        return walk(lp, prefix)

    def finish_grads(self, grads: dict) -> dict:
        """Sum each leaf's gradient over the axes its block is replicated
        on (in place)."""
        for path, g in tree_flatten(grads):
            spec = self.store["/".join(path)]
            held = {a for e in spec for a in axes_of(e)}
            for a, group in self.groups.items():
                if a not in held and self.sizes[a] > 1:
                    dist.all_reduce(g, group=group)
        return grads

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The global gradient norm, in fp32: each leaf's sum of squares
        over its replicas' count, summed over every rank."""
        sq = []
        for path, g in tree_flatten(grads):
            spec = self.store["/".join(path)]
            held = {a for e in spec for a in axes_of(e)}
            copies = 1
            for a, n in self.sizes.items():
                if a not in held:
                    copies *= n
            sq.append(torch.sum(torch.square(g.float())) / copies)
        total = torch.sum(torch.stack(sq))
        for a, group in self.groups.items():
            if self.sizes[a] > 1:
                dist.all_reduce(total, group=group)
        return torch.sqrt(total)

    # ------------------------------------------------------ activations --
    def block_output(self, y: torch.Tensor, block: str) -> torch.Tensor:
        if self.tp_blocks.get(block):
            if self.seq_shard:
                return reduce_scatter_dim(y, 1, self.model_group)
            return all_reduce_sum(y, self.model_group)
        return self.seq_chunk(y)

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        if not self.seq_shard:
            return x
        return all_gather_dim(x, 1, self.model_group)

    def seq_chunk(self, x: torch.Tensor) -> torch.Tensor:
        if not self.seq_shard:
            return x
        if x.shape[1] % self.tp:
            raise ValueError(f"sequence {x.shape[1]} is not divisible by "
                             f"the model-axis size {self.tp} (seq_shard)")
        w = x.shape[1] // self.tp
        return x[:, self.model_rank * w:(self.model_rank + 1) * w]

    def gather_vocab(self, y: torch.Tensor) -> torch.Tensor:
        return self.tp_gather(y, "vocab", y.ndim - 1)

    def tp_slice(self, x: torch.Tensor, block: str, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` where ``block`` is
        tensor-parallel (a whole input cut to the local columns)."""
        if not self.tp_blocks.get(block):
            return x
        w = x.shape[dim] // self.tp
        return x.narrow(dim, self.model_rank * w, w)

    def tp_gather(self, x: torch.Tensor, block: str, dim: int
                  ) -> torch.Tensor:
        """The ranks' blocks of ``x`` along ``dim`` concatenated where
        ``block`` is tensor-parallel."""
        if not self.tp_blocks.get(block):
            return x
        return all_gather_dim(x, dim % x.ndim, self.model_group)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        for a in self.data:
            x = all_reduce_sum(x, self.groups[a])
        return x / self.n_data

    def token_mean(self, total: torch.Tensor, n_local: int) -> torch.Tensor:
        """The global mean of a per-token sum: ``total`` summed over the
        data axes over ``n_local`` times the data width (a batch
        replicated over data counts once)."""
        for a in self.data:
            total = all_reduce_sum(total, self.groups[a])
        return total / (n_local * self.n_data)

    def vocab_ce(self, logits: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
        """Σ (log-sum-exp − gold logit) of fp32 logits over this rank's
        vocabulary columns: the local log-sum-exps combine across ranks
        (a max, then a sum of their exponentials) and the gold logit comes
        from the rank whose columns hold it (one sum for both)."""
        V = logits.shape[-1]
        lse_l = torch.logsumexp(logits, dim=-1)
        m = lse_l.detach().clone()
        if self.tp > 1:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.model_group)
        t = targets.long() - self.model_rank * V
        mine = (t >= 0) & (t < V)
        gold = torch.gather(logits, -1, t.clamp(0, V - 1)[..., None])[..., 0]
        red = all_reduce_sum(torch.stack([torch.exp(lse_l - m),
                                          torch.where(mine, gold, 0.0)]),
                             self.model_group)
        return torch.sum(m + torch.log(red[0]) - red[1])

    def moe_experts(self, E: int) -> tuple[int, int]:
        """The experts this rank computes: its block under EP, else all."""
        if self.tp_blocks["moe"] != "ep":
            return 0, E
        w = E // self.tp
        return self.model_rank * w, (self.model_rank + 1) * w

    # ----------------------------------------------------------- caches --
    def kv_seq_chunk(self, ck: torch.Tensor) -> int:
        """The first position of this rank's block of a sequence-sharded
        cache layer ``[B, Smax / model, Hkv, D]``."""
        return self.model_rank * ck.shape[1]

    def gather_seq_cache(self, ck: torch.Tensor) -> torch.Tensor:
        return ck if self.tp == 1 else _gather(ck, 1, self.model_group)
