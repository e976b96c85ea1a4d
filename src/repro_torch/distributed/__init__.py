"""Distributed pieces of the port (``repro.distributed``): the int8
error-feedback compression and its collective, the split-KV decode over a
mesh, and the sharding helpers of tensor-parallel serving."""
