"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

The dense decoder-only and the Mamba2 hybrid configurations of the
reference package, each exporting ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced model of the same family for CPU tests).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, SSMConfig, dtype_of

_ARCH_MODULES = {
    "smollm-135m": "smollm_135m",
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "internlm-1.8b": "internlm_1_8b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "SSMConfig", "dtype_of", "get_config",
           "get_smoke_config", "ARCHS"]
