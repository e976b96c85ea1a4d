"""The port's serving path against the reference's: PagedBatcher with the
solver-planned engine (sync host, and sync device with window 4) gives the
reference's greedy tokens on the same seeded prompts and weights; plus the
paged cache's allocator invariants and the sampler's support sets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import paged_cache as ref_paged_cache
from repro.serving.sampler import SamplerConfig as RefSamplerConfig
from repro.serving.sampler import filter_logits as ref_filter_logits
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import bucket_chunks as ref_bucket_chunks
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving.paged_cache import (BlockAccountingError,
                                             BlockAllocator, OutOfBlocks,
                                             PagedKVCache)
from repro_torch.serving.sampler import SamplerConfig, filter_logits, sample
from repro_torch.serving.scheduler import PagedBatcher, Request, bucket_chunks

PROMPT_LENS = (5, 70, 130)
NEW_TOKENS = 6
POOL = dict(num_blocks=1 + 3 * 5, block_size=32, max_blocks_per_seq=5,
            decode_width=4)
ARMS = {"host": dict(sync="host"), "device-w4": dict(sync="device", window=4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def port_params(smoke_model):
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


def _run_ref(smoke_model, engine_mode, arm):
    cfg, _, params = smoke_model
    cb = RefPagedBatcher(cfg, params, engine_mode=engine_mode, **POOL,
                         **ARMS[arm])
    reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    cb.run(reqs)
    return [r.output for r in reqs], cb.stats()


def _run_port(port_params, engine_mode, arm):
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, engine_mode=engine_mode, device="cpu",
                      **POOL, **ARMS[arm])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    cb.run(reqs)
    cb.kv.assert_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], cb.stats()


@pytest.mark.parametrize("arm", list(ARMS))
def test_hetero_tensor_tokens_match_reference(smoke_model, port_params, arm):
    ref_out, ref_stats = _run_ref(smoke_model, "hetero-tensor", arm)
    out, stats = _run_port(port_params, "hetero-tensor", arm)
    assert out == ref_out
    assert all(len(o) == NEW_TOKENS for o in out)
    for key in ("peak_active", "decode_dispatches", "decode_steps",
                "prefill_dispatches", "total_dispatches"):
        assert stats[key] == ref_stats[key], key


@pytest.mark.parametrize("engine_mode", [None, "xla", "mxu"])
def test_engine_modes_token_identical(port_params, engine_mode):
    """The port's own invariant across engine modes and sync arms."""
    base, _ = _run_port(port_params, "hetero-tensor", "host")
    for arm in ARMS:
        out, _ = _run_port(port_params, engine_mode, arm)
        assert out == base, (engine_mode, arm)


def test_eos_stops_a_lane_early(port_params):
    base, _ = _run_port(port_params, None, "device-w4")
    eos = base[1][2]                    # request 1's third token
    cfg, params = port_params
    for arm in ARMS:
        cb = PagedBatcher(cfg, params, eos_id=eos, device="cpu", **POOL,
                          **ARMS[arm])
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
        cb.run(reqs)
        cb.kv.assert_drained()
        out = reqs[1].output
        assert out == base[1][:base[1].index(eos) + 1], arm


@pytest.mark.parametrize("arm", list(ARMS))
def test_temperature_sampling_is_seeded(port_params, arm):
    """Temperature sampling through the batcher draws from its seeded
    generator: the same seed gives the same stream, every token in range."""
    cfg, params = port_params
    sampler = SamplerConfig(temperature=1.0, top_k=8)
    outs = []
    for _ in range(2):
        cb = PagedBatcher(cfg, params, sampler=sampler, seed=5, device="cpu",
                          **POOL, **ARMS[arm])
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts())]
        cb.run(reqs)
        cb.kv.assert_drained()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size
                                             for t in o) for o in outs[0])


@pytest.mark.parametrize("S", [1, 63, 64, 200, 449])
def test_bucket_chunks_match_reference(S):
    assert bucket_chunks(S, (64, 128, 256)) == \
        ref_bucket_chunks(S, (64, 128, 256))


def test_allocator_null_block_and_double_free():
    a = BlockAllocator(4)
    blocks = a.alloc(3)
    assert 0 not in blocks and sorted(blocks) == [1, 2, 3]
    with pytest.raises(OutOfBlocks):
        a.alloc(1)
    with pytest.raises(BlockAccountingError):
        a.free([0])
    a.free([blocks[0]])
    with pytest.raises(BlockAccountingError):
        a.free([blocks[0]])
    a.check()
    # the reference hands blocks out in the same order
    r = ref_paged_cache.BlockAllocator(4)
    assert r.alloc(3) == blocks


def test_paged_cache_reserves_and_drains(port_params):
    cfg, _ = port_params
    kv = PagedKVCache(cfg, num_blocks=9, block_size=32, dtype=torch.float32,
                      device="cpu")
    seq = kv.open_sequence(prompt_tokens=40, total_tokens=100)
    assert len(seq.blocks) == 2 and seq.reserved == 4
    assert kv.n_free_unreserved == 8 - 4
    assert not kv.can_admit(32 * 5)
    assert kv.grow_to(seq, 97) == 2
    with pytest.raises(BlockAccountingError):
        kv.grow_to(seq, 200)          # past the admission reservation
    kv.close_sequence(seq)
    kv.assert_drained()
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert kv.pool_bytes() == 2 * L * 9 * 32 * Hkv * D * 4


def test_submit_rejects_empty_and_duplicate(port_params):
    cfg, params = port_params
    cb = PagedBatcher(cfg, params, device="cpu", **POOL)
    with pytest.raises(ValueError):
        cb.submit(Request(rid=0, prompt=np.zeros(0, np.int32)))
    cb.submit(Request(rid=1, prompt=np.ones(3, np.int32)))
    with pytest.raises(ValueError):
        cb.submit(Request(rid=1, prompt=np.ones(3, np.int32)))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (3, 0.5)])
def test_filter_logits_support_matches_reference(top_k, top_p):
    logits = np.random.default_rng(12).standard_normal((3, 50)).astype(
        np.float32)
    ref = np.asarray(ref_filter_logits(
        jnp.asarray(logits), RefSamplerConfig(temperature=0.7, top_k=top_k,
                                              top_p=top_p)))
    out = filter_logits(torch.from_numpy(logits),
                        SamplerConfig(temperature=0.7, top_k=top_k,
                                      top_p=top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))


def test_sample_greedy_and_seeded():
    logits = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (4, 30)).astype(np.float32))
    assert torch.equal(sample(logits, None, SamplerConfig()),
                       logits.argmax(-1))
    cfg = SamplerConfig(temperature=1.0, top_k=4)
    a = sample(logits, torch.Generator().manual_seed(3), cfg)
    b = sample(logits, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(a, b)
    top4 = logits.topk(4, dim=-1).indices
    assert all(int(a[i]) in top4[i].tolist() for i in range(4))
