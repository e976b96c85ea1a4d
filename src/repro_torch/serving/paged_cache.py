"""Paged (block-table) KV cache: vLLM-style paging for the serving stack.

  * pool tensors ``k``/``v``: ``[L, num_blocks, block_size, Hkv, D]`` on the
    device, updated in place by the paged model steps (an int8 pool,
    ``kv_quant='int8'``, adds bf16 ``k_scale``/``v_scale`` ``[L, NB, BS]``);
  * a host-side free-list :class:`BlockAllocator` hands blocks to requests;
  * each request owns a **block table** (``[max_blocks_per_seq]`` int32 of
    pool block ids) mapping logical token position ``t`` to physical slot
    ``table[t // block_size] * block_size + t % block_size``.

Block id 0 is reserved as the **null block**: unused table entries point at
it, so gathers are always in bounds (garbage there is masked positionally
by the causal mask) and inactive decode lanes sink their writes into it.

Allocator invariants (enforced — misuse raises, never corrupts):
  * block 0 is never handed out and never freed;
  * every other block is either FREE (on the free list) or OWNED;
  * ``free + owned == num_blocks - 1`` at all times;
  * freeing the null block, an unowned or an already-free block raises
    :class:`BlockAccountingError`.

Growth is two-phase: ``open_sequence`` reserves a request's whole budget,
``grow_to`` draws on the reservation, so decode-time growth never fails.
Prefix caching and ``truncate_to`` (speculative rollback) are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import transformer


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAccountingError(RuntimeError):
    """Raised on allocator misuse (double free, freeing the null block)."""


class BlockAllocator:
    """Free-list allocator over pool blocks ``1..num_blocks-1`` (0 = null)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._owned: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"requested {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._owned.update(out)
        return out

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == 0:
                raise BlockAccountingError("null block must never be freed")
            if b not in self._owned:
                state = "free" if b in self._free else "unknown"
                raise BlockAccountingError(
                    f"double free of block {b} (state: {state})")
            self._owned.remove(b)
            self._free.append(b)

    def check(self) -> None:
        if (len(self._free) + len(self._owned) != self.num_blocks - 1
                or 0 in self._owned or 0 in self._free
                or self._owned & set(self._free)):
            raise BlockAccountingError(
                f"allocator invariant broken: {len(self._free)} free, "
                f"{len(self._owned)} owned of {self.num_blocks - 1}")


@dataclass
class SequenceBlocks:
    """One request's view of the pool: its block table and write cursor."""
    table: np.ndarray                  # [max_blocks_per_seq] int32, 0-padded
    blocks: list = field(default_factory=list)   # allocated pool block ids
    length: int = 0                    # tokens written so far
    reserved: int = 0                  # blocks admission promised (incl. held)

    def append_block(self, block_id: int) -> None:
        self.table[len(self.blocks)] = block_id
        self.blocks.append(block_id)


class PagedKVCache:
    """Shared KV pool (``self.pool``, on ``device``: the card unless
    ``"cpu"`` is asked for) + allocator + per-request block tables."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int = 32,
                 max_blocks_per_seq: int | None = None,
                 dtype=torch.bfloat16, kv_quant: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = (max_blocks_per_seq
                                   if max_blocks_per_seq is not None
                                   else num_blocks - 1)
        self.pool = transformer.init_paged_cache(
            cfg, num_blocks=num_blocks, block_size=block_size, dtype=dtype,
            kv_quant=kv_quant, device=device)
        self.allocator = BlockAllocator(num_blocks)
        self._reserved_unheld = 0      # promised at admission, not yet alloc'd

    # ------------------------------------------------------------- sizing --
    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 1) / self.block_size)

    @property
    def n_free_unreserved(self) -> int:
        """Blocks available to NEW admissions: free minus outstanding IOUs."""
        return self.allocator.n_free - self._reserved_unheld

    def can_admit(self, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens)
        return (need <= self.max_blocks_per_seq
                and need <= self.n_free_unreserved)

    # ---------------------------------------------------------- lifecycle --
    def open_sequence(self, prompt_tokens: int,
                      total_tokens: int) -> SequenceBlocks:
        """Admit a request: allocate prompt blocks now, reserve the rest so
        decode-time growth can never fail mid-flight."""
        need = self.blocks_for(total_tokens)
        now = self.blocks_for(prompt_tokens)
        if need > self.n_free_unreserved or need > self.max_blocks_per_seq:
            raise OutOfBlocks(f"need {need} blocks, "
                              f"{self.n_free_unreserved} unreserved")
        seq = SequenceBlocks(
            table=np.zeros((self.max_blocks_per_seq,), np.int32),
            reserved=need)
        for b in self.allocator.alloc(now):
            seq.append_block(b)
        self._reserved_unheld += need - now
        return seq

    def grow_to(self, seq: SequenceBlocks, n_tokens: int) -> int:
        """Ensure ``seq`` owns blocks covering writes of its first
        ``n_tokens`` tokens (a whole decode window at once), drawing on the
        admission-time reservation. Returns the number of blocks added."""
        need = self.blocks_for(n_tokens)
        grown = 0
        while len(seq.blocks) < need:
            if len(seq.blocks) >= seq.reserved:
                raise BlockAccountingError("grew past reservation")
            seq.append_block(self.allocator.alloc(1)[0])
            self._reserved_unheld -= 1
            grown += 1
        return grown

    def maybe_grow(self, seq: SequenceBlocks) -> bool:
        """Before a decode step writing position ``seq.length``: allocate the
        next block if the write crosses a block boundary."""
        return self.grow_to(seq, seq.length + 1) > 0

    def close_sequence(self, seq: SequenceBlocks) -> None:
        """Return the sequence's blocks and its unheld reservation."""
        self.allocator.free(seq.blocks)
        self._reserved_unheld -= seq.reserved - len(seq.blocks)
        seq.blocks = []
        seq.reserved = 0
        seq.table[:] = 0
        self.allocator.check()

    def assert_drained(self) -> None:
        """Leak check after the scheduler drains: every block is back on the
        free list and no admission reservation is outstanding."""
        self.allocator.check()
        held = self.num_blocks - 1 - self.allocator.n_free
        if held:
            raise BlockAccountingError(f"{held} pool blocks leaked after drain")
        if self._reserved_unheld:
            raise BlockAccountingError(
                f"{self._reserved_unheld} reserved-unheld blocks leaked")

    # ------------------------------------------------------------- stats --
    def pool_bytes(self) -> int:
        """Device bytes held by the pool tensors, an int8 pool's scale
        planes included."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())
