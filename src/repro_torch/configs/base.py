"""Model configuration for the dense decoder-only and the Mamba2 hybrid
families.

Field for field the same as ``repro.configs.base.ModelConfig`` for the
dense transformers and the zamba2-style hybrid (no MoE, RWKV or
encoder-only variants yet), so a configuration means the same model in both
packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


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
class ModelConfig:
    name: str
    family: str                     # dense | hybrid
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
    ssm: Optional[SSMConfig] = None
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_block_k: int = 1024        # blockwise-attention kv tile

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic; norms excluded, as upstream)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
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
        return emb + self.n_layers * (attn + dense_ffn)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
