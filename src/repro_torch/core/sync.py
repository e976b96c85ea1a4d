"""Fast synchronization (paper §4.3) on the card.

The paper's problem: a host-driver sync between kernels (clFinish, ~400 us)
dwarfs decode kernels. The fix is to keep a whole loop of steps on the
device and read back to the host once at its end:

  * ``fence`` — the port's ONE ``torch.cuda.synchronize`` site; grepping
    for ``fence(`` lists every planned sync point.
  * ``generate_on_device`` — the single-request engine's fast sync: its
    decode steps issued back to back, the position and the tokens kept on
    the device, one read at the end (by the caller).
  * ``generate_host_loop`` — the baseline: every step waits for the device
    and carries its token to the host and back (the clFinish analogue, the
    per-token cost the paper measures).
  * ``measure_dispatch_overhead`` — the median cost of one trivial launch
    plus a sync on this device, the solver's T_sync in host mode.
  * ``paged_decode_window`` — a WINDOW of batched paged decode steps issued
    back to back with no host read inside it, so the scheduler pays one
    host round-trip per window instead of per token. Finished lanes are
    masked, as the reference's ``_masked_step`` does: a lane whose budget
    ran out or that hit EOS gets the null block table and length 0, so its
    writes sink into the pool's null block.

Both device loops are issued eagerly, step by step; capturing them as CUDA
graphs is later work.
"""
from __future__ import annotations

import time

import torch

from ..device import resolve_device
from ..serving.sampler import SamplerConfig, sample


def fence(*values):
    """Block until the device has finished the work queued so far, and
    return ``values`` unchanged (the single value un-tupled)."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in values):
        torch.cuda.synchronize()
    return values[0] if len(values) == 1 else values


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]


def generate_on_device(model, params, first_token, cache, n_steps: int):
    """Fast sync: ``n_steps`` greedy decode steps with no host read inside
    the loop. first_token: [B, 1]; ``cache["index"]`` a device scalar.
    Returns (tokens [B, n_steps], cache), both on the device."""
    token, toks = first_token, []
    for _ in range(n_steps):
        logits, cache = model.decode_step(params, token, cache)
        token = _greedy(logits)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1), cache


def generate_host_loop(model, params, first_token, cache, n_steps: int):
    """Baseline: the host drives each token step, waits for it (``fence``)
    and brings its token to the host and back to the device. Returns
    (tokens [B, n_steps], cache)."""
    token, toks = first_token, []
    for _ in range(n_steps):
        logits, cache = model.decode_step(params, token, cache)
        token = fence(_greedy(logits)).cpu().to(first_token.device)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1), cache


def measure_dispatch_overhead(n: int = 50, device="cuda") -> float:
    """Median microseconds of one trivial launch plus ``fence`` on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    x = torch.zeros((8,), dtype=torch.float32, device=resolve_device(device))
    fence(x + 1)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()  # repolint: disable=determinism -- measures real per-dispatch wall overhead (the solver's T_sync input); a virtual clock would measure nothing
        fence(x + 1)
        ts.append(time.perf_counter() - t0)  # repolint: disable=determinism -- second half of the same real-wall-time measurement
    ts.sort()
    return ts[len(ts) // 2] * 1e6


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
