"""The system under test: the program's paged batcher behind its
``AsyncServer``, built from a configuration file and a traffic mix.

This is the one module of the harness that imports the program. It takes
from it the server, the batcher's counters and its tracer, and nothing
else. The program runs the configuration as its file states it: the sizes
of the program's configuration are checked against the file, and the norm
epsilon is the file's.
"""
from __future__ import annotations

import asyncio

SERVING = {"engine_mode": "hetero-tensor", "sync": "device", "window": 8,
           "block_size": 32}

# the configuration file's key for each size of the program's configuration
_SIZES = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
          "n_heads": "num_attention_heads",
          "n_kv_heads": "num_key_value_heads", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta"}
_MOE_SIZES = {"n_experts": "num_experts", "top_k": "num_experts_per_tok",
              "d_ff_expert": "moe_intermediate_size",
              "d_ff_shared": "shared_expert_intermediate_size"}


def program_config(c: dict, smoke: bool = False):
    """The program's configuration of ``c["program_arch"]`` with the file's
    norm epsilon, after checking that every size agrees with the file
    (``smoke``: the program's reduced model of that family, for CPU tests,
    checked the same way against a file of its sizes)."""
    from repro_torch.configs import get_config, get_smoke_config
    arch = c["program_arch"]
    cfg = (get_smoke_config if smoke else get_config)(arch)
    cfg = cfg.with_(norm_eps=float(c["rms_norm_eps"]))
    wrong = [f"{k}={getattr(cfg, k)} against {v}={c[v]}"
             for k, v in _SIZES.items() if getattr(cfg, k) != c[v]]
    if c.get("num_experts"):
        a = c["assumed"]
        wrong += [f"moe.{k}={getattr(cfg.moe, k)} against {v}={c[v]}"
                  for k, v in _MOE_SIZES.items() if getattr(cfg.moe, k) != c[v]]
        if cfg.moe.capacity_factor != a["moe_capacity_factor"] or \
                cfg.moe.group_size != a["moe_group_size"]:
            wrong.append("the capacity dispatch differs from `assumed`")
    elif cfg.d_ff != c["intermediate_size"]:
        wrong.append(f"d_ff={cfg.d_ff} against {c['intermediate_size']}")
    if cfg.tie_embeddings != bool(c.get("tie_word_embeddings")):
        wrong.append("tied embeddings differ")
    if wrong:
        raise ValueError(f"the program's {arch} departs from the "
                         f"configuration file: {'; '.join(wrong)}")
    return cfg


class System:
    """``server`` (``AsyncServer``) over ``batcher`` (``PagedBatcher``)
    with one lane per client and a pool that holds every lane at the
    traffic's longest request, so nothing waits for blocks."""

    def __init__(self, c: dict, weights: dict, traffic, *, device,
                 traced: bool, smoke: bool = False):
        from repro_torch.serving.ingress import AsyncServer
        from repro_torch.serving.scheduler import PagedBatcher
        from repro_torch.serving.telemetry import MonotonicClock
        from repro_torch.serving.trace import Tracer
        clock = MonotonicClock()
        self.tracer = Tracer(clock, capacity=1 << 22) if traced else None
        bs = SERVING["block_size"]
        max_blocks = traffic.max_blocks(bs)
        lanes = traffic.clients
        self.batcher = PagedBatcher(
            program_config(c, smoke), weights,
            num_blocks=1 + lanes * max_blocks, block_size=bs,
            max_blocks_per_seq=max_blocks, decode_width=lanes,
            sync=SERVING["sync"], window=SERVING["window"],
            engine_mode=SERVING["engine_mode"], device=device,
            tracer=self.tracer)
        self.server = AsyncServer(self.batcher, clock=clock)

    def chunks(self, prompt_len: int) -> list:
        """The program's own cut of a prompt into prefill chunks."""
        from repro_torch.serving.scheduler import bucket_chunks
        return bucket_chunks(prompt_len, self.batcher.buckets)

    def warm_up(self, prompts, budget: int = 2) -> None:
        """Serve ``prompts`` to completion through the server: each prefill
        chunk length they take and the decode window are captured at
        their first use, so the window never meets one first."""
        for p in prompts:
            self.server.submit(p, budget)
        asyncio.run(self.server.run())

    def events(self) -> list:
        return self.tracer.events if self.tracer is not None else []
