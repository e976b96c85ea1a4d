#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.attention_gate`` on the card.

    python3 scripts/attention_gate_mutants.py

The gate holds llama3-8b's engine logits (arm 1: hetero-tensor, fast sync,
hetero strategy, prompt 300, seeded random bf16 weights) through the port's
attention kernels against the same run through the plain versions. Here
the plain side is swapped for six wrong attentions, each a fault a kernel
could have (two of them faults of the split-KV decode kernel's combine), and the gate's numbers are printed for each: a gate that a
wrong kernel would pass shows up as a mutant inside its bounds. Prints one
JSON object {case: {"first" | "decode": {cos, rel_err, max_abs}}} and
exits 1 if the kernels fall outside the gate or a mutant inside it.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_split_plan  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials, decode_attention_ref, decode_split_shares,
    split_partials)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402


def _attention(q, k, v, *, kv_head, offset, length=None):
    """fp32-softmax attention of q [B,Sq,Hq,D] over k/v [B,Sk,Hkv,D] with
    query head j reading kv head ``kv_head(j)``, key j visible to query i
    when j <= i + offset (and j < length)."""
    Hq, D, Sq, Sk = q.shape[2], q.shape[3], q.shape[1], k.shape[1]
    idx = torch.tensor([kv_head(j) for j in range(Hq)], device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k[:, :, idx].float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    visible = kpos <= qpos
    if length is not None:
        visible = visible & (kpos < length)
    p = torch.softmax(torch.where(visible, s, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v[:, :, idx].float()).to(q.dtype)


def flash_top_left(q, k, v, causal=True):
    """The Pallas kernel's own mask: query i sees keys 0..i at any Sk."""
    G = q.shape[2] // k.shape[2]
    return _attention(q, k, v, kv_head=lambda j: j // G, offset=0)


def flash_head_map(q, k, v, causal=True):
    """Query head j reads kv head j % Hkv instead of j // G."""
    return _attention(q, k, v, kv_head=lambda j: j % k.shape[2],
                      offset=k.shape[1] - q.shape[1])


def decode_short(q, k_cache, v_cache, length):
    """Valid length ``index`` instead of ``index + 1``: the newest key lost."""
    return decode_attention_ref(q, k_cache, v_cache, length - 1)


def decode_head_map(q, k_cache, v_cache, length):
    """Query head j reads kv head j % Hkv instead of j // G."""
    n = torch.as_tensor(length, device=q.device).reshape(())
    return _attention(q[:, None], k_cache, v_cache,
                      kv_head=lambda j: j % k_cache.shape[2],
                      offset=k_cache.shape[1], length=n)[:, 0]


def _split_kv(q, k_cache, v_cache, length, fault):
    """The split-KV kernel's arithmetic on the plan's split, with ``fault``:
    "drop" loses the last non-empty split's partial, "no_rescale" sums the
    partials without the e^(m_i - M) factors."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n = int(torch.as_tensor(length).reshape(()))
    shares = decode_split_shares(n, decode_split_plan(B, Hkv, S, n_sm))
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(D)
    m, l, acc = split_partials(s, v_cache, shares)
    if fault == "drop":
        last = max(i for i, (a, b) in enumerate(shares) if b > a)
        m[last], l[last], acc[last] = -math.inf, 0.0, 0.0
        o = combine_partials(m, l, acc)
    else:
        o = acc.sum(dim=0) / l.sum(dim=0)[..., None]
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_drop_last_split(q, k_cache, v_cache, length):
    """The last split's partial lost in the combine."""
    return _split_kv(q, k_cache, v_cache, length, "drop")


def decode_combine_no_rescale(q, k_cache, v_cache, length):
    """The combine sums acc_i / l_i without rescaling to the common max."""
    return _split_kv(q, k_cache, v_cache, length, "no_rescale")


MUTANTS = {
    "flash: top-left causal mask": (flash_top_left, decode_attention_ref),
    "flash: query head j -> kv head j % Hkv": (flash_head_map,
                                               decode_attention_ref),
    "decode: length index, not index + 1": (attention_ref, decode_short),
    "decode: query head j -> kv head j % Hkv": (attention_ref,
                                                decode_head_map),
    "decode: last split dropped": (attention_ref, decode_drop_last_split),
    "decode: combine without the e^(m_i - M) rescale": (
        attention_ref, decode_combine_no_rescale),
}


def passes(result: dict) -> bool:
    return all(r["cos"] >= chip_smoke.ATTENTION_GATE_COS
               and r["rel_err"] <= chip_smoke.ATTENTION_GATE_REL
               for r in result.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_gate_mutants: CUDA is not available",
              file=sys.stderr)
        return 2
    chip_smoke.phase_card_and_build()
    cfg, params = chip_smoke.full_model()
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 300))
    out = {"kernels": chip_smoke.attention_gate(cfg, params, prompt)}
    for name, plain in MUTANTS.items():
        chip_smoke.log(f"[mutant] {name}")
        out[name] = chip_smoke.attention_gate(cfg, params, prompt, plain,
                                              check=False)
    print(json.dumps(out))
    caught = [not passes(out[name]) for name in MUTANTS]
    return 0 if passes(out["kernels"]) and all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
