"""Operations and compulsory bytes of the served model's work, from its
published sizes alone.

A configuration file gives the model in its source's own keys
(``hidden_size``, ``num_experts`` ...); :class:`Shape` reads them. The
counts are what the mathematics needs, whatever implements it:

* a token's FLOPs are two per active matrix weight it meets, plus causal
  attention at its true position (``4 * heads * head_dim`` per key per
  layer: the score and the weighted sum), plus the LM head where a logit
  row is needed (the last prompt token and every decoded token);
* a decode step reads every weight once (the embedding: only the rows of
  its lanes), each active lane's keys and values at its true length once,
  and writes each active lane's new position once.

Weights and the KV cache are counted in the served dtype's width.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PEAKS = Path(__file__).with_name("peaks.json")


@dataclass(frozen=True)
class Shape:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    d_ff: int
    experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    d_shared: int = 0
    tied: bool = False
    dtype_bytes: int = 2

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        heads = c["num_attention_heads"]
        moe = c.get("num_experts", 0)
        return cls(
            layers=c["num_hidden_layers"], d=c["hidden_size"], heads=heads,
            kv_heads=c.get("num_key_value_heads", heads),
            head_dim=c.get("head_dim") or c["hidden_size"] // heads,
            vocab=c["vocab_size"], d_ff=c["intermediate_size"],
            experts=moe, top_k=c.get("num_experts_per_tok", 0),
            d_expert=c.get("moe_intermediate_size", 0),
            d_shared=c.get("shared_expert_intermediate_size", 0),
            tied=bool(c.get("tie_word_embeddings", False)),
            dtype_bytes={"bfloat16": 2, "float16": 2, "float32": 4}[
                c.get("torch_dtype", "bfloat16")])

    # ------------------------------------------------------------ params --
    @property
    def attn_params(self) -> int:
        q = self.d * self.heads * self.head_dim
        kv = 2 * self.d * self.kv_heads * self.head_dim
        return q + kv + self.heads * self.head_dim * self.d

    @property
    def ffn_params(self) -> int:
        """One layer's FFN weights, every expert counted."""
        if not self.experts:
            return 3 * self.d * self.d_ff
        shared = (3 * self.d * self.d_shared + self.d) if self.d_shared else 0
        return (self.d * self.experts + self.experts * 3 * self.d
                * self.d_expert + shared)

    @property
    def ffn_active(self) -> int:
        """One layer's FFN weights that one token meets: the router, its
        ``top_k`` experts and the shared expert with its gate."""
        if not self.experts:
            return self.ffn_params
        return self.ffn_params - (self.experts - self.top_k) * 3 * self.d \
            * self.d_expert

    @property
    def head_params(self) -> int:
        return self.d * self.vocab

    @property
    def total_params(self) -> int:
        embed = self.vocab * self.d
        head = 0 if self.tied else self.head_params
        return embed + head + self.layers * (self.attn_params
                                             + self.ffn_params)

    @property
    def active_params(self) -> int:
        return self.total_params - self.layers * (self.ffn_params
                                                  - self.ffn_active)

    @property
    def body_active(self) -> int:
        """Matrix weights a token meets below the head (no embedding)."""
        return self.layers * (self.attn_params + self.ffn_active)

    # ------------------------------------------------------------- FLOPs --
    @property
    def attn_flops_per_key(self) -> int:
        return 4 * self.layers * self.heads * self.head_dim

    def token_flops(self, pos: int, logits: bool) -> int:
        """One token at position ``pos`` (it attends ``pos + 1`` keys)."""
        return (2 * self.body_active + self.attn_flops_per_key * (pos + 1)
                + (2 * self.head_params if logits else 0))

    def chunk_flops(self, start: int, n: int, logits_last: bool = True) -> int:
        """A prompt chunk of ``n`` tokens at ``start``: the sum of
        :meth:`token_flops`, with a logit row for its last token only."""
        keys = n * start + n * (n + 1) // 2
        return (2 * self.body_active * n + self.attn_flops_per_key * keys
                + (2 * self.head_params if logits_last else 0))

    # ------------------------------------------------------------- bytes --
    @property
    def kv_bytes_per_pos(self) -> int:
        return self.layers * 2 * self.kv_heads * self.head_dim \
            * self.dtype_bytes

    def weight_bytes_step(self, lanes: int) -> int:
        """Weights one decode step reads: every layer's and the head once,
        the embedding rows of its ``lanes``."""
        head = 0 if self.tied else self.head_params
        return self.dtype_bytes * (self.layers * (self.attn_params
                                                  + self.ffn_params)
                                   + head + lanes * self.d)

    def decode_token_bytes(self, pos: int) -> int:
        """A lane's own traffic in a step that writes position ``pos``: its
        ``pos`` cached positions read once, the new one written once."""
        return self.kv_bytes_per_pos * (pos + 1)


def peaks(kind: str) -> dict:
    """The data-sheet peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``); KeyError for a card not listed."""
    table = json.loads(PEAKS.read_text())
    return table[kind]
