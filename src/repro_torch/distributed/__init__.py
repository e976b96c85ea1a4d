"""Distributed-training pieces of the port (``repro.distributed``): so far
the int8 error-feedback gradient compression."""
