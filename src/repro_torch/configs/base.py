"""Model configuration: model configs, shape specs and the assigned
(arch x shape) grid.

Field for field the same as ``repro.configs.base`` (``ModelConfig``,
``MoEConfig``, ``SSMConfig``, ``RWKVConfig``, ``ShapeSpec``), so a
configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0            # total shared-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # dispatch group size (tokens): capacity is PER GROUP, so the dispatch /
    # combine one-hot tensors stay O(group x E x C_g), not O(T x E x C)
    group_size: int = 1024


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings, used by hybrid archs."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                # SSD chunk length
    attn_every: int = 6             # hybrid: a (shared) attention block every N layers


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64            # rank of the data-dependent decay LoRA
    chunk: int = 256                # chunked-recurrence length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    encoder_only: bool = False      # hubert: bidirectional, no KV cache / decode
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_block_q: int = 512         # blockwise-attention tile sizes
    attn_block_k: int = 1024
    loss_chunk: int = 512           # sequence chunk of the reference's CE loss
    remat: bool = True
    # the reference's rematerialisation policy of training: "nothing" (full
    # recompute) or "dots" (keep matmul outputs)
    remat_policy: str = "nothing"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.rwkv is not None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic; norms excluded, as upstream)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.rwkv is not None:
            # token-mix: r,k,v,g,o projections + decay lora; channel-mix: 2 mats
            per_layer = (5 * d * d + 2 * self.rwkv.decay_lora * d
                         + d * self.d_ff * 2)
            return emb + self.n_layers * per_layer
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        dense_ffn = 3 * d * self.d_ff
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            # in_proj: d -> (2*d_in + 2*n_groups*d_state + n_heads), n_groups=1
            in_proj = d * (2 * d_in + 2 * s.d_state + nh)
            out_proj = d_in * d
            conv = d_in * s.d_conv
            mamba = in_proj + out_proj + conv + nh  # + A,dt biases
            # ONE shared attention + ffn block
            return emb + self.n_layers * mamba + attn + dense_ffn
        per_layer = attn + (0 if self.moe else dense_ffn)
        if self.moe:
            m = self.moe
            per_layer += d * m.n_experts                     # router
            per_layer += m.n_experts * 3 * d * m.d_ff_expert
            if m.d_ff_shared:
                per_layer += 3 * d * m.d_ff_shared + d       # shared + gate
        return emb + self.n_layers * per_layer

    @property
    def n_params_active(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if not self.moe:
            return self.n_params
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.n_params - self.n_layers * inactive


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


# The four assigned input-shape cells (identical for every LM arch).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason if not) of an (arch x shape) cell: ``long_500k``
    needs sub-quadratic attention (SSM / hybrid only), and an encoder-only
    arch has no decode step."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not (cfg.ssm or cfg.rwkv):
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
