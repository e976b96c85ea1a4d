"""Whether the timed path's answers are right: served tokens against the
plain reference.

After the window, a sample drawn from the seed of the requests that
finished in it (the longest always among them) is run through the
reference once each, teacher-forced on its prompt and served tokens. The
number compared is ``logit_gap``: the widest margin, over every served
token of the sample, by which the token's reference logit lies below the
reference's best at that position. Greedy serving in the configuration's
precision keeps it near zero; a wrong token or a lower precision widens it.

The control (``control=True``) is the reference in float8 put in the
program's place: at each position of the same sequences, the token float8
ranks first, read off the float32 logits the same way
(``control_gap``).
"""
from __future__ import annotations

import numpy as np

from reference.calls import request_calls
from reference.model import forward_logits, widest_gap


def choose(window, seed: int, min_tokens: int = 320,
           max_requests: int = 16) -> list:
    """The longest finished request (prompt plus answer), then others in an
    order drawn from ``seed``, until the sample holds ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    done = [r for r in window.served if window.inside(r.finish)
            and r.tokens]
    if not done:
        return []
    done.sort(key=lambda r: (-(r.prompt_len + len(r.tokens)), r.index))
    rest = done[1:]
    order = np.random.default_rng([int(seed), 4]).permutation(len(rest))
    picked = [done[0]]
    for k in order:
        if sum(len(r.tokens) for r in picked) >= min_tokens or \
                len(picked) >= max_requests:
            break
        picked.append(rest[k])
    return picked


def compare(config: dict, weights: dict, traffic, picked, *, device,
            control: bool = False) -> dict:
    """``{"logit_gap": ..., "served_tokens": ...}`` over the sample, with
    ``control_gap`` when ``control``."""
    import torch
    buckets = config["serving"]["prefill_buckets"]
    gap = ctl_gap = 0.0
    for r in picked:
        prompt = traffic.prompt(r.index)
        seq = np.concatenate([prompt, np.asarray(r.tokens[:-1], np.int32)])
        tokens = torch.from_numpy(seq.astype(np.int64)).to(device)
        served = torch.tensor(r.tokens, dtype=torch.long, device=device)
        calls = request_calls(len(prompt), len(seq), buckets)
        ref = forward_logits(config, weights, tokens, first=len(prompt) - 1,
                             calls=calls)
        gap = max(gap, widest_gap(ref, served))
        if control:
            low = forward_logits(config, weights, tokens,
                                 first=len(prompt) - 1, calls=calls,
                                 precision="fp8")
            ctl_gap = max(ctl_gap, widest_gap(ref, low.argmax(-1)))
            del low
        del ref
    out = {"logit_gap": gap,
           "served_tokens": sum(len(r.tokens) for r in picked)}
    if control:
        out["control_gap"] = ctl_gap
    return out
