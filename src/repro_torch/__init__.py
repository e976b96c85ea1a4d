"""PyTorch/CUDA port of the HeteroInfer reproduction in ``repro``.

Same layout as ``repro`` (configs, core, kernels, models, serving,
training, distributed, launch);
the aligned-path GEMM is a hand-written Hopper kernel
(``csrc/hetero_matmul.cu``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
