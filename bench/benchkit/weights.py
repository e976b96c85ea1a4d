"""The served model's weights, made by the benchmark on the device from the
seed in one draw, in the dtype they are served in.

The dict is laid out as the program's parameter tree (stacked ``[L, ...]``
per-layer tensors, matrices ``[K, N]`` so that ``y = x @ w``), and the
reference reads the same dict. Every tensor is a view of one normal draw
(``torch.randn`` on a device generator seeded with ``seed``), scaled in
place: matrices by ``1 / sqrt(fan_in)``, the embedding by 0.02, the norm
weights as ``1 + 0.1 z``. The mixture of experts' router and shared-expert
gate are kept in float32, as the program keeps them, with values that
bfloat16 holds exactly.
"""
from __future__ import annotations

import math

import torch


def layout(c: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, init, scale) of every tensor, from the configuration
    file's sizes: init is ``"matrix"``, ``"embed"``, ``"norm"`` or
    ``"fp32"`` (a float32 matrix)."""
    L, d = c["num_hidden_layers"], c["hidden_size"]
    H = c["num_attention_heads"]
    Hkv = c.get("num_key_value_heads", H)
    hd = c.get("head_dim") or d // H
    V = c["vocab_size"]
    s = 1.0 / math.sqrt(d)
    out = [(("embed",), (V, d), "embed", 0.02),
           (("final_norm",), (d,), "norm", 0.1)]
    if not c.get("tie_word_embeddings"):
        out.append((("head",), (d, V), "matrix", s))
    out += [
        (("layers", "attn_norm"), (L, d), "norm", 0.1),
        (("layers", "ffn_norm"), (L, d), "norm", 0.1),
        (("layers", "attn", "wq"), (L, d, H * hd), "matrix", s),
        (("layers", "attn", "wk"), (L, d, Hkv * hd), "matrix", s),
        (("layers", "attn", "wv"), (L, d, Hkv * hd), "matrix", s),
        (("layers", "attn", "wo"), (L, H * hd, d), "matrix",
         1.0 / math.sqrt(H * hd)),
    ]
    if c.get("num_experts"):
        E, f = c["num_experts"], c["moe_intermediate_size"]
        out += [
            (("layers", "moe", "router"), (L, d, E), "fp32", s),
            (("layers", "moe", "w_gate"), (L, E, d, f), "matrix", s),
            (("layers", "moe", "w_up"), (L, E, d, f), "matrix", s),
            (("layers", "moe", "w_down"), (L, E, f, d), "matrix",
             1.0 / math.sqrt(f)),
        ]
        fs = c.get("shared_expert_intermediate_size", 0)
        if fs:
            out += [
                (("layers", "moe", "shared", "w_gate"), (L, d, fs), "matrix",
                 s),
                (("layers", "moe", "shared", "w_up"), (L, d, fs), "matrix", s),
                (("layers", "moe", "shared", "w_down"), (L, fs, d), "matrix",
                 1.0 / math.sqrt(fs)),
                (("layers", "moe", "shared_gate"), (L, d, 1), "fp32", s),
            ]
    else:
        f = c["intermediate_size"]
        out += [
            (("layers", "ffn", "w_gate"), (L, d, f), "matrix", s),
            (("layers", "ffn", "w_up"), (L, d, f), "matrix", s),
            (("layers", "ffn", "w_down"), (L, f, d), "matrix",
             1.0 / math.sqrt(f)),
        ]
    return out


def make_weights(c: dict, seed: int, device) -> dict:
    """The weights of configuration ``c`` on ``device``, from ``seed``."""
    dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
             "float32": torch.float32}[c.get("torch_dtype", "bfloat16")]
    entries = layout(c)
    total = sum(math.prod(shape) for _, shape, _, _ in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: dict = {}
    at = 0
    for path, shape, init, scale in entries:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if init == "norm":
            t.mul_(scale).add_(1.0)
        else:
            t.mul_(scale)
        if init == "fp32":
            t = t.float()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree

