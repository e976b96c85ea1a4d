"""Training of the port: AdamW, data, checkpoints, fault tolerance and the
train loop, as ``repro.training``."""
