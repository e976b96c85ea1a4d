"""Token data pipeline: deterministic, checkpointable, host-prefetched —
the reference's ``repro.training.data``, in numpy as there, so a batch is
byte-identical to the reference's for a seed and step.

``SyntheticLM`` generates structure-bearing token streams (Zipfian unigrams +
a short Markov mixer) so training loss actually decreases; ``PackedFile``
memory-maps a .bin of uint16/uint32 tokens and serves packed sequences.
Both expose ``state()``/``restore()`` so a restarted job resumes mid-epoch
(fault-tolerance contract), and a one-deep host prefetch thread overlaps
batch construction with the device step. Batches are numpy ``int32``
arrays; the train step moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, batch: int, *,
                 seed: int = 0, alpha: float = 1.1):
        self.vocab, self.seq, self.batch = vocab_size, seq_len, batch
        self.seed, self.alpha = seed, alpha
        self.step = 0
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.probs = (ranks ** -alpha) / np.sum(ranks ** -alpha)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: dict):
        self.step, self.seed = st["step"], st["seed"]

    def next(self) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + self.step)
        self.step += 1
        toks = rng.choice(self.vocab, p=self.probs,
                          size=(self.batch, self.seq + 1)).astype(np.int32)
        # Markov-ish structure: every even position repeats prior token + 1
        toks[:, 2::2] = (toks[:, 1:-1:2] + 1) % self.vocab
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


class PackedFile:
    """Serves contiguous packed [batch, seq+1] windows from a token .bin."""

    def __init__(self, path: str | Path, vocab_size: int, seq_len: int,
                 batch: int, *, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.seq, self.batch = vocab_size, seq_len, batch
        self.step = 0
        self.per_step = batch * (seq_len + 1)

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, st: dict):
        self.step = st["step"]

    def next(self) -> dict:
        n = len(self.tokens) - self.per_step
        off = (self.step * self.per_step) % max(n, 1)
        self.step += 1
        window = np.asarray(self.tokens[off: off + self.per_step],
                            dtype=np.int32).reshape(self.batch, self.seq + 1)
        window %= self.vocab
        return {"inputs": window[:, :-1], "targets": window[:, 1:]}


class Prefetcher:
    """One-deep background prefetch: overlaps host batch prep with device step."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                self.q.put(self.source.next(), timeout=0.5)
            except queue.Full:
                continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
