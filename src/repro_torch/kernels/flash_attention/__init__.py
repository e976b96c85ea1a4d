"""Prefill attention: CUDA kernel, wrapper and plain version."""
