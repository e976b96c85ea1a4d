"""Fast synchronization (paper §4.3) on the card.

The paper's problem: a host-driver sync between kernels (clFinish, ~400 us)
dwarfs decode kernels. The fix is to keep a whole loop of steps on the
device and read back to the host once at its end:

  * ``fence`` — the port's ONE ``torch.cuda.synchronize`` site; grepping
    for ``fence(`` lists every planned sync point.
  * ``paged_decode_window`` — a WINDOW of batched paged decode steps issued
    back to back with no host read inside it, so the scheduler pays one
    host round-trip per window instead of per token. Finished lanes are
    masked, as the reference's ``_masked_step`` does: a lane whose budget
    ran out or that hit EOS gets the null block table and length 0, so its
    writes sink into the pool's null block. This slice issues the window
    eagerly, step by step; capturing it as a CUDA graph is later work.
"""
from __future__ import annotations

import torch

from ..serving.sampler import SamplerConfig, sample


def fence(*values):
    """Block until the device has finished the work queued so far, and
    return ``values`` unchanged (the single value un-tupled)."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in values):
        torch.cuda.synchronize()
    return values[0] if len(values) == 1 else values


def paged_decode_window(model, params, last_token, pool, block_tables,
                        lengths, remaining, n_steps: int, *,
                        sampler: SamplerConfig | None = None, eos_id=None,
                        generator=None):
    """``n_steps`` masked batched decode steps with no host read.

    last_token: [W, 1] each lane's latest token; block_tables: [W, NBmax]
    (pre-grown on the host to cover the window's writes); lengths: [W] write
    positions; remaining: [W] steps each lane may still emit (0 = inactive).
    Greedy when ``sampler`` is None or temperature 0, else draws from
    ``generator``. Returns (tokens [W, n_steps], valid [W, n_steps] bool,
    pool, final lengths [W], final remaining [W]), all on the device.
    """
    token = last_token
    toks, valids = [], []
    for _ in range(n_steps):
        active = remaining > 0
        eff_tables = torch.where(active[:, None], block_tables, 0)
        eff_lengths = torch.where(active, lengths, 0)
        logits, pool = model.paged_decode_step(params, token, pool,
                                               block_tables=eff_tables,
                                               lengths=eff_lengths)
        if sampler is None or sampler.temperature <= 0.0:
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
        else:
            nxt = sample(logits[:, -1, :], generator, sampler)
        nxt = torch.where(active, nxt, token[:, 0])
        new_remaining = torch.where(active, remaining - 1, 0)
        if eos_id is not None:
            new_remaining = torch.where(active & (nxt == eos_id), 0,
                                        new_remaining)
        lengths = lengths + active.long()
        remaining = new_remaining
        token = nxt[:, None]
        toks.append(nxt)
        valids.append(active)
    return (torch.stack(toks, dim=1), torch.stack(valids, dim=1), pool,
            lengths, remaining)
