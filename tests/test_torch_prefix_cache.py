"""The port's prefix cache against the reference's: the pool's bookkeeping
(block ids, tables, refcounts, the free list, the LRU, ``truncate_to``'s
results, ``prefix_stats()``) exactly equal under seeded sequences of
open / grow / truncate / close calls; the copy on write over every pool
leaf; and ``PagedBatcher(prefix_cache=True)`` giving the reference's greedy
tokens and ``stats()`` over two waves of prompts sharing a prefix, in both
sync modes (with int8 + int8 KV and W4A16 weights:
tests/test_torch_quant_serving.py)."""
import jax
import numpy as np
import pytest
import torch

from repro.serving import paged_cache as ref_paged_cache
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving import paged_cache
from repro_torch.serving.paged_cache import (BlockAccountingError,
                                             BlockAllocator, OutOfBlocks,
                                             PagedKVCache)
from repro_torch.serving.scheduler import PagedBatcher, Request

NEW_TOKENS = 6
POOL = dict(num_blocks=1 + 4 * 5, block_size=32, max_blocks_per_seq=5,
            decode_width=2)
SYNCS = {"host": dict(sync="host"), "device-w4": dict(sync="device",
                                                      window=4)}


def _waves():
    """Two waves sharing a 64-token prefix; wave 2 repeats a wave-1 prompt
    of exactly two blocks (a whole-prompt hit: copy on write) and adds new
    suffixes (partial hits)."""
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, 256, 64)
    tail = [rng.integers(0, 256, n) for n in (30, 7, 45, 12)]
    wave1 = [prefix, np.concatenate([prefix, tail[0]]),
             np.concatenate([prefix, tail[1]])]
    wave2 = [prefix, np.concatenate([prefix, tail[2]]),
             np.concatenate([prefix, tail[3]])]
    return [[p.astype(np.int32) for p in w] for w in (wave1, wave2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_params(smoke_model):
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def ref_waves(smoke_model):
    """The reference's prefix-cache batcher (sync device, window 4) over
    both waves: (tokens of each wave, stats after each wave)."""
    cfg, _, params = smoke_model
    cb = RefPagedBatcher(cfg, params, prefix_cache=True, **POOL,
                         **SYNCS["device-w4"])
    outs, stats = [], []
    for w, wave in enumerate(_waves()):
        reqs = [RefRequest(rid=10 * w + i, prompt=p,
                           max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(wave)]
        cb.run(reqs)
        cb.kv.assert_drained()
        outs.append([r.output for r in reqs])
        stats.append(cb.stats())
    return outs, stats


def _run_waves(cb):
    outs, stats = [], []
    for w, wave in enumerate(_waves()):
        reqs = [Request(rid=10 * w + i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(wave)]
        cb.run(reqs)
        cb.kv.assert_drained()
        assert all(r.done and len(r.output) == NEW_TOKENS for r in reqs)
        outs.append([r.output for r in reqs])
        stats.append(cb.stats())
    return outs, stats


# ------------------------------------------------------------- bookkeeping --

def _state(kv, seqs):
    a = kv.allocator
    return {"free": list(a._free), "ref": dict(a._ref),
            "cached": sorted(a._cached), "lru": list(kv._lru),
            "hashes": {b: h for b, h in kv._hash_of_block.items()},
            "unreserved": kv.n_free_unreserved,
            "total_allocs": a.total_allocs, "stats": kv.prefix_stats(),
            "seqs": [(list(s.blocks), s.table.tolist(), s.length, s.reserved,
                      s.cached_tokens, s.n_shared) for s in seqs]}


@pytest.mark.parametrize("seed", range(4))
def test_bookkeeping_equals_reference(port_params, seed):
    """A seeded sequence of ~120 calls on a 23-block pool of 4-token blocks
    (prompts from three shared prefixes, so hits, whole-prompt copies on
    write and evictions all occur): after every call the port's pool state
    equals the reference's, and so do truncate_to's results and the
    exceptions raised."""
    cfg, _ = port_params
    kw = dict(num_blocks=24, block_size=4, max_blocks_per_seq=12,
              prefix_cache=True)
    ref = ref_paged_cache.PagedKVCache(cfg, **kw)
    kv = PagedKVCache(cfg, dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 50, n) for n in (8, 12, 5)]
    live = []             # (ref seq, port seq, stream, prompt len, total)
    for _ in range(120):
        op = rng.choice(["open", "grow", "truncate", "close"],
                        p=[0.35, 0.25, 0.15, 0.25])
        if op == "open" or not live:
            prompt = np.concatenate([prefixes[rng.integers(3)],
                                     rng.integers(0, 50, rng.integers(0, 9))])
            if rng.random() < 0.2:           # a whole-block prompt
                prompt = prefixes[1][:8]
            total = len(prompt) + int(rng.integers(1, 12))
            got = []
            for cache in (ref, kv):
                try:
                    got.append(cache.open_sequence(len(prompt), total,
                                                   token_ids=prompt))
                except (OutOfBlocks, ref_paged_cache.OutOfBlocks) as e:
                    got.append(type(e).__name__)
            assert [g if isinstance(g, str) else "seq" for g in got][0] == \
                [g if isinstance(g, str) else "seq" for g in got][1]
            if not isinstance(got[0], str):
                for s in got:
                    s.length = len(prompt)
                live.append([got[0], got[1], list(prompt), len(prompt),
                             total])
        else:
            i = int(rng.integers(len(live)))
            rs, ps, stream, plen, total = live[i]
            if op == "grow":
                n = min(total, rs.length + int(rng.integers(1, 7)))
                assert ref.grow_to(rs, n) == kv.grow_to(ps, n)
                stream += list(rng.integers(0, 50, n - rs.length))
                rs.length = ps.length = n
            elif op == "truncate":
                n = int(rng.integers(plen, rs.length + 1))
                assert ref.truncate_to(rs, n) == kv.truncate_to(ps, n)
                del stream[n:]
            else:
                ids = np.asarray(stream[:rs.length], np.int64)
                ref.close_sequence(rs, token_ids=ids)
                kv.close_sequence(ps, token_ids=ids)
                live.pop(i)
        assert _state(kv, [x[1] for x in live]) == \
            _state(ref, [x[0] for x in live])
    for rs, ps, stream, _, _ in live:
        ids = np.asarray(stream[:rs.length], np.int64)
        ref.close_sequence(rs, token_ids=ids)
        kv.close_sequence(ps, token_ids=ids)
    ref.assert_drained()
    kv.assert_drained()
    assert _state(kv, []) == _state(ref, [])
    stats = kv.prefix_stats()
    assert stats["prefix_hits"] > 0 and stats["cached_blocks"] > 0


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_cow_copy_copies_every_pool_leaf(port_params, kv_quant):
    """The copy on write moves one block's pages across every layer, an
    int8 pool's scale planes included, and touches no other block."""
    cfg, _ = port_params
    kv = PagedKVCache(cfg, num_blocks=6, block_size=4, kv_quant=kv_quant,
                      dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in kv.pool.values():
        t.copy_((torch.randn(t.shape, generator=g) * 50).to(t.dtype))
    before = {k: t.clone() for k, t in kv.pool.items()}
    paged_cache._cow_copy(kv.pool, 2, 5)
    assert set(kv.pool) == ({"k", "v"} if kv_quant is None else
                            {"k", "v", "k_scale", "v_scale"})
    for name, t in kv.pool.items():
        assert torch.equal(t[:, 5], before[name][:, 2])
        keep = [b for b in range(6) if b != 5]
        assert torch.equal(t[:, keep], before[name][:, keep])


def test_allocator_states_and_misuse():
    a = BlockAllocator(5)
    b1, b2 = a.alloc(2)
    a.incref(b1)
    assert a.refcount(b1) == 2
    assert a.retire([b1]) == []             # still shared: stays owned
    assert a.retire([b1]) == [b1] and a.n_cached == 1
    with pytest.raises(BlockAccountingError):
        a.free([b1])                        # cached, not owned
    with pytest.raises(BlockAccountingError):
        a.incref(b1)
    a.reactivate(b1)
    assert a.refcount(b1) == 1
    with pytest.raises(BlockAccountingError):
        a.reactivate(b1)
    with pytest.raises(BlockAccountingError):
        a.evict([b2])
    a.retire([b1])
    a.evict([b1])
    a.free([b2])
    a.check()
    assert a.n_free == 4 and a.n_cached == 0 and a.total_allocs == 2


def test_truncate_into_the_shared_prefix_raises(port_params):
    cfg, _ = port_params
    kv = PagedKVCache(cfg, num_blocks=9, block_size=4, prefix_cache=True,
                      dtype=torch.float32, device="cpu")
    ids = np.arange(10)
    seq = kv.open_sequence(10, 14, token_ids=ids)
    seq.length = 10
    kv.close_sequence(seq, token_ids=ids)
    again = kv.open_sequence(10, 14, token_ids=ids)
    assert again.cached_tokens == 8 and again.n_shared == 2
    with pytest.raises(ValueError):
        kv.truncate_to(again, 7)
    again.length = 10
    kv.close_sequence(again, token_ids=ids)
    kv.assert_drained()


# ----------------------------------------------------------------- batcher --

@pytest.mark.parametrize("sync", list(SYNCS))
def test_prefix_batcher_matches_reference(port_params, ref_waves, sync):
    """Two waves through the port's prefix-cache batcher (hetero-tensor):
    the reference's tokens, equal to the cold batcher's, and its stats()
    after each wave; wave 2 hits (one whole-prompt copy on write)."""
    ref_outs, ref_stats = ref_waves
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, prefix_cache=True,
                      engine_mode="hetero-tensor", device="cpu", **POOL,
                      **SYNCS[sync])
    outs, stats = _run_waves(cb)
    assert outs == ref_outs
    cold, cold_stats = _run_waves(PagedBatcher(cfg, params, device="cpu",
                                               **POOL, **SYNCS[sync]))
    assert cold == outs
    for s, r in zip(stats, ref_stats):
        assert set(s) <= set(r)
        if sync == "device-w4":
            assert s == {k: r[k] for k in s}
        else:
            for key in ("prefix_hits", "prefix_tokens_reused", "evictions",
                        "cow_copies", "cached_blocks", "prefill_dispatches"):
                assert s[key] == r[key], key
    assert stats[1]["prefix_hits"] > stats[0]["prefix_hits"]
    assert stats[1]["cow_copies"] == 1
    assert stats[1]["prefill_dispatches"] < 2 * stats[0]["prefill_dispatches"]
    assert cold_stats[1]["prefix_hits"] == 0
