"""Paged (block-table) KV cache: vLLM-style paging for the serving stack.

  * pool tensors ``k``/``v``: ``[L, num_blocks, block_size, Hkv, D]`` on the
    device, updated in place by the paged model steps (an int8 pool,
    ``kv_quant='int8'``, adds bf16 ``k_scale``/``v_scale`` ``[L, NB, BS]``);
  * a host-side refcounted free-list :class:`BlockAllocator` hands blocks
    to requests;
  * each request owns a **block table** (``[max_blocks_per_seq]`` int32 of
    pool block ids) mapping logical token position ``t`` to physical slot
    ``table[t // block_size] * block_size + t % block_size``.

Block id 0 is reserved as the **null block**: unused table entries point at
it, so gathers are always in bounds (garbage there is masked positionally
by the causal mask) and inactive decode lanes sink their writes into it.

Allocator invariants (enforced — misuse raises, never corrupts):
  * block 0 is never handed out and never freed;
  * every other block is FREE (on the free list), OWNED (refcount >= 1,
    held by one or more sequences) or CACHED (refcount 0, kept by the
    prefix cache, reclaimable);
  * ``free + owned + cached == num_blocks - 1`` at all times;
  * freeing the null block, an unowned or an already-free block raises
    :class:`BlockAccountingError`.

Growth is two-phase: ``open_sequence`` reserves a request's whole budget,
``grow_to`` draws on the reservation, so decode-time growth never fails.
``truncate_to`` rolls a sequence back to an accepted prefix (speculative
decoding), returning whole blocks past it to the free list but keeping
them in its reservation.

Automatic prefix caching (``prefix_cache=True``): every FULL block of a
closed sequence is indexed by a SHA-256 digest chained over its token ids
(``h_i = SHA256(h_{i-1} || tokens of block i)``: position- and
prefix-dependent, and a faithful stand-in for the tokens, since a hit hands
another request's KV over with no further comparison); ``close_sequence``
RETIRES those blocks (refcount 0 parks them in an LRU, contents intact);
``open_sequence`` shares every consecutively matching block (refcount + 1,
or reactivated from the LRU), so prefill runs only the uncached suffix.
Cached blocks are immutable: a hit covering the whole prompt copies its
last block into a private one (copy on write) before the one-token logits
re-run writes there. Allocation pressure evicts refcount-0 cached blocks in
LRU order; ``OutOfBlocks`` comes only when the free list AND the cache are
exhausted. The bookkeeping is the reference's, call for call.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import transformer
from .trace import NULL_TRACER


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAccountingError(RuntimeError):
    """Raised on allocator misuse (double free, freeing the null block,
    touching a block in the wrong state)."""


class BlockAllocator:
    """Refcounted free-list allocator over pool blocks ``1..num_blocks-1``
    (0 = null). ``alloc`` hands out blocks at refcount 1; ``incref`` shares
    one with another sequence; ``free`` / ``retire`` drop a reference, and a
    block whose refcount reaches 0 goes to the free list (``free``) or to
    the CACHED set (``retire``). ``reactivate`` takes a CACHED block back
    to OWNED on a hit; ``evict`` frees it under allocation pressure."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}      # OWNED: block -> refcount >= 1
        self._cached: set[int] = set()      # CACHED: refcount 0, retained
        self.total_allocs = 0               # fresh blocks handed out, ever

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"requested {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.total_allocs += n
        return out

    def incref(self, block: int) -> None:
        """Share an OWNED block with one more sequence."""
        if block not in self._ref:
            raise BlockAccountingError(f"incref of unowned block {block}")
        self._ref[block] += 1

    def _drop_ref(self, block: int) -> bool:
        """Drop one reference; True iff the refcount reached 0."""
        if block == 0:
            raise BlockAccountingError("null block must never be freed")
        if block not in self._ref:
            state = ("free" if block in self._free else
                     "cached" if block in self._cached else "unknown")
            raise BlockAccountingError(
                f"double free of block {block} (state: {state})")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            return True
        return False

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block; blocks at refcount 0 go back to
        the free list."""
        for b in blocks:
            if self._drop_ref(b):
                self._free.append(b)

    def retire(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; blocks at refcount 0 become
        CACHED. Returns those (still-shared blocks stay OWNED)."""
        newly_cached = []
        for b in blocks:
            if self._drop_ref(b):
                self._cached.add(b)
                newly_cached.append(b)
        return newly_cached

    def reactivate(self, block: int) -> None:
        """CACHED -> OWNED at refcount 1 (a hit on an evictable block)."""
        if block not in self._cached:
            raise BlockAccountingError(f"reactivate of non-cached {block}")
        self._cached.remove(block)
        self._ref[block] = 1

    def evict(self, blocks: list[int]) -> None:
        """CACHED -> FREE (allocation-pressure reclaim)."""
        for b in blocks:
            if b not in self._cached:
                raise BlockAccountingError(f"evict of non-cached block {b}")
            self._cached.remove(b)
            self._free.append(b)

    def check(self) -> None:
        free = set(self._free)
        if (len(self._free) + len(self._ref) + len(self._cached)
                != self.num_blocks - 1
                or 0 in self._ref or 0 in free or 0 in self._cached
                or self._cached & free
                or (self._cached | free) & self._ref.keys()
                or any(r < 1 for r in self._ref.values())):
            raise BlockAccountingError(
                f"allocator invariant broken: {len(self._free)} free, "
                f"{len(self._ref)} owned, {len(self._cached)} cached of "
                f"{self.num_blocks - 1}")


@dataclass
class SequenceBlocks:
    """One request's view of the pool: its block table and write cursor."""
    table: np.ndarray                  # [max_blocks_per_seq] int32, 0-padded
    blocks: list = field(default_factory=list)   # allocated pool block ids
    length: int = 0                    # tokens written so far
    reserved: int = 0                  # blocks admission promised (incl. held)
    cached_tokens: int = 0             # prefix tokens served from the cache
    n_shared: int = 0                  # leading blocks shared with the cache

    def append_block(self, block_id: int) -> None:
        self.table[len(self.blocks)] = block_id
        self.blocks.append(block_id)


def _cow_copy(pool: dict, src: int, dst: int) -> None:
    """Copy pool block ``src`` into ``dst`` in place across all layers and
    every pool leaf (K/V pages, and an int8 pool's scale planes: each leaf
    keeps blocks on axis 1)."""
    for t in pool.values():
        t[:, dst] = t[:, src]


class PagedKVCache:
    """Shared KV pool (``self.pool``, on ``device``: the card unless
    ``"cpu"`` is asked for) + allocator + per-request block tables.

    With ``prefix_cache=True``: pass the prompt's token ids to
    ``open_sequence``, and the sequence may start with ``cached_tokens``
    positions resident (prefill only the suffix); pass the written token
    stream to ``close_sequence``, and its full blocks retire into the
    cache for later requests."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int = 32,
                 max_blocks_per_seq: int | None = None,
                 dtype=torch.bfloat16, kv_quant: str | None = None,
                 prefix_cache: bool = False, device="cuda", tracer=None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
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
        self.prefix_cache = prefix_cache
        # chain-hash index over closed full blocks, and the LRU of its
        # refcount-0 part (the eviction order)
        self._block_of_hash: dict = {}
        self._hash_of_block: dict = {}
        self._lru: OrderedDict = OrderedDict()
        self.prefix_hits = 0           # admissions that reused >= 1 block
        self.prefix_tokens_reused = 0  # prompt tokens served from the cache
        self.evictions = 0             # cached blocks reclaimed for space
        self.cow_copies = 0            # copy-on-write block duplications

    # ------------------------------------------------------------- sizing --
    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 1) / self.block_size)

    @property
    def n_free_unreserved(self) -> int:
        """Blocks available to NEW admissions: free plus evictable cached,
        minus outstanding IOUs (a cached block is capacity: pressure
        reclaims it)."""
        return (self.allocator.n_free + self.allocator.n_cached
                - self._reserved_unheld)

    def can_admit(self, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens)
        return (need <= self.max_blocks_per_seq
                and need <= self.n_free_unreserved)

    # ------------------------------------------------------ prefix cache --
    def _chain_hashes(self, token_ids, n_full: int) -> list:
        """Chained SHA-256 digests of the first ``n_full`` full blocks of
        ``token_ids``: a hit at block i certifies the whole prefix
        ``[0, (i+1) * block_size)``."""
        bs = self.block_size
        h, out = b"%d" % self.block_size, []
        for i in range(n_full):
            block = np.asarray(token_ids[i * bs:(i + 1) * bs], np.int64)
            h = hashlib.sha256(h + block.tobytes()).digest()
            out.append(h)
        return out

    def _acquire_cached(self, block: int) -> None:
        """Take a reference on a registered block: out of the LRU if nobody
        holds it, else shared with its live owner."""
        if block in self._lru:
            del self._lru[block]
            self.allocator.reactivate(block)
        else:
            self.allocator.incref(block)

    def _release(self, blocks: list[int]) -> None:
        """Drop one reference per block: registered blocks retire (at
        refcount 0 to the LRU's tail), the others free."""
        registered = [b for b in blocks if b in self._hash_of_block]
        plain = [b for b in blocks if b not in self._hash_of_block]
        if plain:
            self.allocator.free(plain)
        for b in self.allocator.retire(registered):
            self._lru[b] = None                  # most recently retired last
        self.tracer.gauge("cached_blocks", self.allocator.n_cached)

    def _reclaim(self, n: int) -> None:
        """Evict up to ``n`` refcount-0 cached blocks, least recently used
        first, unregistering their hashes."""
        while n > 0 and self._lru:
            b, _ = self._lru.popitem(last=False)
            del self._block_of_hash[self._hash_of_block.pop(b)]
            self.allocator.evict([b])
            self.evictions += 1
            self.tracer.count("evictions")
            self.tracer.instant("prefix_evict", track="cache", cat="cache",
                                args={"block": b})
            n -= 1
        self.tracer.gauge("cached_blocks", self.allocator.n_cached)

    def _alloc(self, n: int) -> list[int]:
        """``n`` fresh blocks, evicting cached ones under pressure."""
        if n > self.allocator.n_free:
            self._reclaim(n - self.allocator.n_free)
        return self.allocator.alloc(n)

    def _match_prefix(self, seq: SequenceBlocks, token_ids,
                      prompt_tokens: int) -> None:
        """Share every consecutively matching cached block into ``seq``;
        set ``seq.cached_tokens`` and ``seq.n_shared``. A match of the WHOLE
        prompt copies its last block on write, so the one-token logits
        re-run never writes a shared block (``cached_tokens`` is then
        ``prompt - 1``)."""
        bs = self.block_size
        hits = []
        for h in self._chain_hashes(token_ids, prompt_tokens // bs):
            b = self._block_of_hash.get(h)
            if b is None:
                break
            hits.append(b)
        if not hits:
            return
        cow = len(hits) * bs == prompt_tokens
        for b in (hits[:-1] if cow else hits):
            self._acquire_cached(b)
            seq.append_block(b)
        seq.n_shared = len(seq.blocks)
        if cow:
            src = hits[-1]
            self._acquire_cached(src)            # pin against eviction
            dst = self._alloc(1)[0]
            _cow_copy(self.pool, src, dst)
            self._release([src])                 # drop the pin
            seq.append_block(dst)
            self.cow_copies += 1
            self.tracer.count("cow_copies")
            self.tracer.instant("prefix_cow", track="cache", cat="cache",
                                args={"src": src, "dst": dst})
            seq.cached_tokens = prompt_tokens - 1
        else:
            seq.cached_tokens = len(hits) * bs
        self.prefix_hits += 1
        self.prefix_tokens_reused += seq.cached_tokens
        self.tracer.count("prefix_hits")
        self.tracer.count("prefix_tokens_reused", seq.cached_tokens)
        self.tracer.instant("prefix_hit", track="cache", cat="cache",
                            args={"blocks": len(hits),
                                  "tokens": seq.cached_tokens})
        self.tracer.gauge("cached_blocks", self.allocator.n_cached)

    # ---------------------------------------------------------- lifecycle --
    def open_sequence(self, prompt_tokens: int, total_tokens: int,
                      token_ids=None) -> SequenceBlocks:
        """Admit a request: allocate prompt blocks now, reserve the rest so
        decode-time growth can never fail mid-flight. With the prefix cache
        on and ``token_ids`` given, matching full blocks are shared instead
        of allocated (``seq.cached_tokens`` positions resident)."""
        need = self.blocks_for(total_tokens)
        now = self.blocks_for(prompt_tokens)
        if need > self.n_free_unreserved or need > self.max_blocks_per_seq:
            raise OutOfBlocks(f"need {need} blocks, "
                              f"{self.n_free_unreserved} unreserved")
        seq = SequenceBlocks(
            table=np.zeros((self.max_blocks_per_seq,), np.int32),
            reserved=need)
        if self.prefix_cache and token_ids is not None and prompt_tokens > 0:
            if len(token_ids) != prompt_tokens:
                raise ValueError(f"{len(token_ids)} token ids for a "
                                 f"{prompt_tokens}-token prompt")
            self._match_prefix(seq, token_ids, prompt_tokens)
        for b in self._alloc(now - len(seq.blocks)):
            seq.append_block(b)
        self._reserved_unheld += need - len(seq.blocks)
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
            seq.append_block(self._alloc(1)[0])
            self._reserved_unheld -= 1
            grown += 1
        return grown

    def maybe_grow(self, seq: SequenceBlocks) -> bool:
        """Before a decode step writing position ``seq.length``: allocate the
        next block if the write crosses a block boundary."""
        return self.grow_to(seq, seq.length + 1) > 0

    def truncate_to(self, seq: SequenceBlocks, n_tokens: int) -> int:
        """Token-level rollback (speculative decoding): keep the blocks
        covering the first ``n_tokens`` tokens and free every whole block
        past them; they stay in the sequence's reservation, so a later
        ``grow_to`` can always cover them again. A partly filled tail block
        is kept. Rolling back into the shared cached prefix raises. Returns
        the number of blocks freed."""
        if n_tokens < seq.cached_tokens:
            raise ValueError(
                f"truncate_to({n_tokens}) would roll back into the shared "
                f"cached prefix ({seq.cached_tokens} tokens)")
        keep = 0 if n_tokens <= 0 else self.blocks_for(n_tokens)
        freed = seq.blocks[keep:]
        if freed:
            self.allocator.free(freed)
            del seq.blocks[keep:]
            seq.table[keep: keep + len(freed)] = 0
            self._reserved_unheld += len(freed)
        seq.length = min(seq.length, n_tokens)
        return len(freed)

    def close_sequence(self, seq: SequenceBlocks, token_ids=None) -> None:
        """Return the sequence's references and its unheld reservation.
        With the prefix cache on and the WRITTEN token stream given (prompt
        and generated tokens, ``seq.length`` of them: KV position p holds
        the stream's p-th token), full blocks register under their chain
        hash and retire into the cache; the partial tail and blocks whose
        hash another block already serves free as usual."""
        if self.prefix_cache and token_ids is not None:
            n_full = min(seq.length, len(token_ids)) // self.block_size
            n_full = min(n_full, len(seq.blocks))
            for i, h in enumerate(self._chain_hashes(token_ids, n_full)):
                b = seq.blocks[i]
                if b in self._hash_of_block or h in self._block_of_hash:
                    continue              # a shared hit, or duplicate content
                self._block_of_hash[h] = b
                self._hash_of_block[b] = h
        self._release(seq.blocks)
        self._reserved_unheld -= seq.reserved - len(seq.blocks)
        seq.blocks = []
        seq.reserved = 0
        seq.n_shared = 0
        seq.table[:] = 0
        self.allocator.check()

    def assert_drained(self) -> None:
        """Leak check after the scheduler drains: every block is free or
        parked refcount-0 in the prefix cache (reclaimable: retention is not
        a leak), and no admission reservation is outstanding."""
        self.allocator.check()
        held = (self.num_blocks - 1 - self.allocator.n_free
                - self.allocator.n_cached)
        if held:
            raise BlockAccountingError(f"{held} pool blocks leaked after drain")
        if self.allocator.n_cached != len(self._lru):
            raise BlockAccountingError(
                "cached blocks out of sync with the eviction LRU")
        if self._reserved_unheld:
            raise BlockAccountingError(
                f"{self._reserved_unheld} reserved-unheld blocks leaked")

    # ------------------------------------------------------------- stats --
    def memory_tokens(self) -> int:
        """Total token capacity of the pool (for equal-memory comparisons);
        the null block is real memory, so it counts."""
        return self.num_blocks * self.block_size

    def pool_bytes(self) -> int:
        """Device bytes held by the pool tensors, an int8 pool's scale
        planes included."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())

    def utilization(self) -> float:
        """Share of the usable blocks (all but the null block) that live
        sequences hold; free and cached blocks are not held."""
        held = (self.num_blocks - 1 - self.allocator.n_free
                - self.allocator.n_cached)
        return held / max(self.num_blocks - 1, 1)

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (merged into ``PagedBatcher.stats``)."""
        return {
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "cached_blocks": self.allocator.n_cached,
        }
