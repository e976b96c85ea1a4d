"""Decode attention over a dense cache: CUDA kernel, wrapper and plain
version."""
