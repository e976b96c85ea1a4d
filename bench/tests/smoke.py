"""Smoke-size configurations and traffic for the CPU tests: each is a
configuration file (``config_path``) with the sizes of the program's
reduced model of the same family (``get_smoke_config``)."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SMOKE_SIZES = {
    "internlm-1.8b": dict(hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          intermediate_size=160, vocab_size=256,
                          rope_theta=10000.0),
    "qwen2-moe-a2.7b": dict(hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=4,
                            intermediate_size=48, moe_intermediate_size=48,
                            shared_expert_intermediate_size=96,
                            num_experts=6, num_experts_per_tok=2,
                            vocab_size=256, rope_theta=10000.0),
}

TRAFFIC = {"kind": "closed_loop", "clients": 4,
           "prompt": {"law": "log_uniform", "min": 40, "max": 300},
           "answer": {"law": "uniform", "min": 4, "max": 12},
           "first_request": "residual"}


def config_path(name: str) -> Path:
    """A configuration file of the benchmark, or, for a model no cell
    serves yet, the tests' own file of it."""
    path = BENCH / "configs" / f"{name}.json"
    return path if path.exists() else Path(__file__).with_name(
        f"{name}.json")


def smoke_config(name: str, **over) -> dict:
    c = json.loads(config_path(name).read_text())
    c.update(SMOKE_SIZES[name])
    c.update(over)
    return c
