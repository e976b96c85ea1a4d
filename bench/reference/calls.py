"""The calls a served request goes through, worked out from the
configuration alone: its prompt cut into prefill chunks, then one call per
decoded token. Only a mixture of experts needs them, because its capacity
groups are the tokens of one call.

The chunking is the one the configuration file states under ``serving``:
greedily the largest of ``prefill_buckets`` that still fits, then the
ragged rest as one chunk.
"""
from __future__ import annotations


def prompt_chunks(n: int, buckets) -> list:
    out, left = [], n
    for b in sorted(buckets, reverse=True):
        while left >= b:
            out.append(b)
            left -= b
    if left:
        out.append(left)
    return out


def request_calls(prompt_len: int, n_inputs: int, buckets) -> list:
    """(start, length) of each call over a sequence of ``n_inputs`` tokens
    whose first ``prompt_len`` are the prompt: the prompt's chunks, then
    one call per later token."""
    calls, at = [], 0
    for c in prompt_chunks(prompt_len, buckets):
        calls.append((at, c))
        at += c
    calls += [(p, 1) for p in range(prompt_len, n_inputs)]
    return calls
