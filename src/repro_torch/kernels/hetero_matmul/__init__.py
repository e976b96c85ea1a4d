"""Aligned-path GEMM: CUDA kernel, wrapper and plain version."""
