"""The one generator of traffic: a closed loop of ``clients``, each sending
its next request when its last one has streamed its final token.

A mix file gives the number of clients and the laws of the prompt and
answer lengths::

    {"kind": "closed_loop", "clients": 32,
     "prompt": {"law": "log_uniform", "min": 1024, "max": 4096},
     "answer": {"law": "uniform", "min": 32, "max": 128},
     "first_request": "residual"}

Requests are numbered in the order the clients take them. Lengths are
drawn from the seed in blocks of ``clients`` requests, stratified: the
unit interval is cut into ``clients`` equal strata, and each block draws
one quantile uniformly inside each stratum, for prompts and answers
apart, in an order drawn from the seed. Each length follows its law
exactly, every seed draws other lengths, and a block's mean varies far
less than that of independent draws. Token ids are uniform over the
vocabulary, drawn from the seed and the request's number. With ``first_request: residual`` each
client's first request keeps a budget drawn uniformly from 1 to its
answer length, so the lanes start staggered.

With ``"schedule_seed": <n>`` the lengths and the first requests'
budgets are drawn from ``n`` in place of the run's seed: every seed then
serves the same sequence of lengths, and the seed draws only the token
ids (and the weights). In a closed loop the order of the lengths decides
which long prompts share a tick, and with it the tails; a mix whose
tails move with that order fixes its schedule so.
"""
from __future__ import annotations

import math

import numpy as np

LAWS = ("uniform", "log_uniform")


def quantile(law: dict, q: float) -> int:
    """The length at quantile ``q`` in [0, 1) of ``law``: ``uniform`` over
    the integers min..max, or ``log_uniform`` (log-length uniform)."""
    lo, hi = int(law["min"]), int(law["max"])
    if law["law"] == "uniform":
        return min(hi, lo + int(q * (hi - lo + 1)))
    if law["law"] == "log_uniform":
        return min(hi, max(lo, round(lo * (hi / lo) ** q)))
    raise ValueError(f"unknown length law {law['law']!r}; known: {LAWS}")


class ClosedLoop:
    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix.get("kind") != "closed_loop":
            raise ValueError(f"unknown traffic kind {mix.get('kind')!r}")
        self.mix = mix
        self.seed = int(seed)
        self.schedule = int(mix.get("schedule_seed", seed))
        self.vocab = int(vocab)
        self.clients = int(mix["clients"])
        self._blocks: dict = {}

    def _block(self, b: int):
        """Block ``b``'s prompt and answer quantiles: one drawn inside each
        of ``clients`` equal strata, in a seeded order."""
        if b not in self._blocks:
            rng = np.random.default_rng([self.schedule, 0, b])
            n = self.clients
            self._blocks[b] = tuple((rng.permutation(n) + rng.random(n)) / n
                                    for _ in range(2))
        return self._blocks[b]

    def lengths(self, i: int) -> tuple[int, int]:
        """(prompt length, answer budget) of request ``i``."""
        b, slot = divmod(i, self.clients)
        q_prompt, q_answer = self._block(b)
        prompt = quantile(self.mix["prompt"], q_prompt[slot])
        answer = quantile(self.mix["answer"], q_answer[slot])
        if i < self.clients and self.mix.get("first_request") == "residual":
            answer = 1 + int(np.random.default_rng(
                [self.schedule, 1, i]).integers(answer))
        return prompt, answer

    def prompt(self, i: int) -> np.ndarray:
        """Request ``i``'s token ids, int32."""
        n = self.lengths(i)[0]
        return np.random.default_rng([self.seed, 2, i]).integers(
            0, self.vocab, n, dtype=np.int64).astype(np.int32)

    def request(self, i: int) -> tuple[np.ndarray, int]:
        return self.prompt(i), self.lengths(i)[1]

    @property
    def longest(self) -> int:
        """The most positions one request can take: longest prompt plus
        longest answer."""
        return int(self.mix["prompt"]["max"]) + int(self.mix["answer"]["max"])

    def max_blocks(self, block_size: int) -> int:
        return math.ceil(self.longest / block_size)

    def warmup_prompts(self, n_requests: int, chunks, seed_salt: int = 3):
        """One prompt of each prefill chunk length that the first
        ``n_requests`` requests take, as ``chunks(length)`` (the program's
        own chunking) cuts them; a prompt of a chunk's length is that one
        chunk. Token ids drawn from the seed."""
        needed = set()
        for i in range(n_requests):
            needed.update(chunks(self.lengths(i)[0]))
        lengths = sorted(needed)
        wrong = [n for n in lengths if chunks(n) != [n]]
        if wrong:
            raise ValueError(f"prompts of lengths {wrong} are cut in more "
                             "than one chunk")
        rng = np.random.default_rng([self.seed, seed_salt])
        return [rng.integers(0, self.vocab, n, dtype=np.int64).astype(
            np.int32) for n in lengths]
