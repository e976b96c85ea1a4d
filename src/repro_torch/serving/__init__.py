"""Serving stack of the port: sampler, paged KV cache, paged batcher."""
