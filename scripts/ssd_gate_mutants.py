#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.ssd_gate`` on the card.

    python3 scripts/ssd_gate_mutants.py

The gate holds zamba2-2.7b's engine (arm 1: hetero-tensor, fast sync,
hetero strategy, prompt 600, seeded random bf16 weights) through the SSD
chunk kernel against the same run through its plain version: the
first-token logits, the first decode step's logits and the first mamba
layer's SSD output at every prompt position. Here the plain side is swapped
for four wrong chunk steps, each a fault a kernel could have, and the
gate's numbers are printed for each: a gate that a wrong kernel would pass
shows up as a mutant inside its bounds. Prints one JSON object {case:
{"first" | "decode" | "scan": {cos, rel_err, max_abs}}} and exits 1 if the
kernel falls outside the gate or a mutant inside it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref  # noqa: E402


def _chunk(xb, B_, C_, seg, S_prev, *, inter=True, strict=False,
           decay_state=True):
    """``ssd_chunk_ref`` with one of its terms switchable: the inter-chunk
    read-out ``C . S_prev^T`` (``inter``), the diagonal of the causal mask
    (``strict`` drops it: j < i), the ``exp(seg_L)`` decay of S_prev in
    S_new (``decay_state``)."""
    L = xb.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril(
        -1 if strict else 0)
    CB = torch.einsum("bin,bjn->bij", C_, B_)
    dec = torch.exp(seg[:, :, None, :] - seg[:, None, :, :])
    att = CB[..., None] * torch.where(tri[None, :, :, None], dec, 0.0)
    y = torch.einsum("bijh,bjhp->bihp", att, xb)
    if inter:
        y = y + torch.einsum("bin,bhpn->bihp", C_, S_prev) * \
            torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    w_in = torch.exp(tot[:, None, :] - seg)
    carried = torch.exp(tot)[:, :, None, None] * S_prev if decay_state \
        else S_prev
    return y, carried + torch.einsum("bjhp,bjn,bjh->bhpn", xb, B_, w_in)


MUTANTS = {
    "inter-chunk term C.S_prev^T dropped":
        lambda *a: _chunk(*a, inter=False),
    "strict causal mask j < i":
        lambda *a: _chunk(*a, strict=True),
    "S_new without the exp(seg_L) decay of S_prev":
        lambda *a: _chunk(*a, decay_state=False),
    "state not carried between chunks":
        lambda *a: ssd_chunk_ref(*a[:4], torch.zeros_like(a[4])),
}


def passes(result: dict) -> bool:
    return all(r["cos"] >= chip_smoke.ATTENTION_GATE_COS
               and r["rel_err"] <= chip_smoke.ATTENTION_GATE_REL
               for r in result.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_gate_mutants: CUDA is not available", file=sys.stderr)
        return 2
    chip_smoke.phase_card_and_build()
    cfg, params = chip_smoke.hybrid_model()
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 600))
    out = {"kernel": chip_smoke.ssd_gate(cfg, params, prompt)}
    for name, plain in MUTANTS.items():
        chip_smoke.log(f"[mutant] {name}")
        out[name] = chip_smoke.ssd_gate(cfg, params, prompt, plain,
                                        check=False)
    print(json.dumps(out))
    caught = [not passes(out[name]) for name in MUTANTS]
    return 0 if passes(out["kernel"]) and all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
