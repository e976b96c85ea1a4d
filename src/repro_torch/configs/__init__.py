"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

Every configuration of the reference package, each module exporting
``CONFIG`` (the published shape) and ``SMOKE`` (a reduced model of the same
family for CPU tests). Assigned architectures:
  dbrx-132b qwen2-moe-a2.7b smollm-135m llama3-8b tinyllama-1.1b qwen3-1.7b
  chameleon-34b zamba2-2.7b rwkv6-3b hubert-xlarge
plus the paper's own evaluation model (internlm-1.8b).
"""
from __future__ import annotations

import importlib

from .base import (SHAPES, ModelConfig, MoEConfig, RWKVConfig, ShapeSpec,
                   SSMConfig, cell_is_supported, dtype_of)

_ARCH_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "smollm-135m": "smollm_135m",
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "chameleon-34b": "chameleon_34b",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-3b": "rwkv6_3b",
    "hubert-xlarge": "hubert_xlarge",
    # the paper's own model
    "internlm-1.8b": "internlm_1_8b",
}

ARCHS = tuple(_ARCH_MODULES)
ASSIGNED_ARCHS = ARCHS[:10]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "RWKVConfig", "ShapeSpec",
    "SHAPES", "cell_is_supported", "dtype_of", "get_config",
    "get_smoke_config", "ARCHS", "ASSIGNED_ARCHS",
]
