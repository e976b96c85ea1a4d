"""Model configuration for the dense decoder-only family.

Field for field the same as ``repro.configs.base.ModelConfig`` for the
dense transformers (no MoE, SSM, RWKV or encoder-only variants yet), so a
configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense
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
        return emb + self.n_layers * (attn + 3 * d * self.d_ff)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
