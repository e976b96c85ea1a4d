"""Mamba2 SSD chunk step: CUDA kernel, wrapper and plain version."""
