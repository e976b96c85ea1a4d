"""Distributed pieces of the port (``repro.distributed``): the int8
error-feedback compression and its collective, the split-KV decode over a
mesh, the sharding rules and the sharded steps' plan, and the GPipe
pipeline over a ``stage`` axis (``pipeline.py``)."""
