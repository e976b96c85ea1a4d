#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.ssd_gate`` on the card.

    python3 scripts/ssd_gate_mutants.py

The gate holds zamba2-2.7b's engine (arm 1: hetero-tensor, fast sync,
hetero strategy, prompt 600, seeded random bf16 weights) through the SSD
chunk kernel against the same run through its plain version: the
first-token logits, the first decode step's logits and the first mamba
layer's SSD output at every prompt position and its state after the
prefill. Here the plain side is swapped for wrong chunk steps, each a fault
a kernel could have, and the gate's numbers are printed for each: a gate
that a wrong kernel would pass shows up as a mutant inside its bounds. Four
are faults of any design; three are faults of the kernel's own (split fp32
on the tensor cores, C.B^T once per batch): the lo terms dropped (one pass
of TF32), C.B^T read from the row tile above, and the diagonal tile's mask
one key too wide. Prints one JSON object {case: {"first" | "decode" |
"scan" | "state": {cos, rel_err, max_abs}}} and exits 1 if the kernel falls
outside the gate or a mutant inside it.
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
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    split_mm, ssd_chunk_ref, ssd_chunk_split_ref)


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


def _split_chunk(xb, B_, C_, seg, S_prev, *, cb_shift=0, mask_offset=0):
    """``ssd_chunk_split_ref`` with a fault of its tiling: rows i >= 64 read
    C.B^T of row i - ``cb_shift`` (the row tile above, for 64), or the mask
    keeps keys j <= i + ``mask_offset``."""
    L = xb.shape[1]
    tri = torch.ones((L, L), dtype=torch.bool, device=xb.device).tril(
        mask_offset)
    CB = split_mm("bin,bjn->bij", C_, B_)
    if cb_shift and L > cb_shift:
        CB = torch.cat([CB[:, :cb_shift], CB[:, :-cb_shift]], dim=1)
    dec = torch.exp(seg[:, :, None, :] - seg[:, None, :, :])
    att = torch.where(tri[None, :, :, None], CB[..., None] * dec, 0.0)
    y = split_mm("bijh,bjhp->bihp", att, xb) + \
        split_mm("bin,bhpn->bihp", C_, S_prev) * torch.exp(seg)[..., None]
    tot = seg[:, -1, :]
    xw = xb * torch.exp(tot[:, None, :] - seg)[..., None]
    return y, (torch.exp(tot)[:, :, None, None] * S_prev
               + split_mm("bjhp,bjn->bhpn", xw, B_))


MUTANTS = {
    "inter-chunk term C.S_prev^T dropped":
        lambda *a: _chunk(*a, inter=False),
    "strict causal mask j < i":
        lambda *a: _chunk(*a, strict=True),
    "S_new without the exp(seg_L) decay of S_prev":
        lambda *a: _chunk(*a, decay_state=False),
    "state not carried between chunks":
        lambda *a: ssd_chunk_ref(*a[:4], torch.zeros_like(a[4])),
    "split fp32 without its lo terms (one pass of TF32)":
        lambda *a: ssd_chunk_split_ref(*a, lo=False),
    "C.B^T read from the row tile above":
        lambda *a: _split_chunk(*a, cb_shift=64),
    "diagonal mask one key too wide (j <= i + 1)":
        lambda *a: _split_chunk(*a, mask_offset=1),
}


def passes(result: dict) -> bool:
    return all(r["cos"] >= chip_smoke.gate_bounds(name)[0]
               and r["rel_err"] <= chip_smoke.gate_bounds(name)[1]
               for name, r in result.items())


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
