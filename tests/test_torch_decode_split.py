"""The split-KV decode-attention kernel's arithmetic and launch plan, on the
CPU.

``csrc/decode_attention.cu`` splits the valid prefix of the cache into
``n_split`` equal shares, one block each, and combines the blocks' fp32
softmax partials in split order. ``decode_attention_split_ref`` is the plain
version of that arithmetic (the card holds the kernel to it and to the
oracle, chip_smoke.py). Here it is held to the JAX package: the Pallas
kernel ``decode_attention_pallas`` in interpret mode and the oracle
``decode_attention_ref``, over ``CONFORMANCE_CASES`` (M the cache's valid
rows, K the head dim) x dtypes x 1, 2 or 4 query heads per kv head, at
splits 1, 2, 3, 7 and the plan's, lengths 0, 1, ragged and the whole cache
(so some splits get an empty share). Its combine is held to the reference's
``combine_split_softmax`` on the same scores, and ``decode_split_plan`` to
its properties: a grid fixed by host-known sizes, never by the length.
Inputs are made with numpy from a seed.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL, rel_err
from repro.distributed.split_kv import combine_split_softmax
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_attention_ref
from repro_torch.configs import dtype_of
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_split_plan,
                                                      max_decode_split)
from repro_torch.kernels.decode_attention.ref import (
    combine_partials, decode_attention_ref, decode_attention_split_ref,
    decode_split_shares, split_partials)

HKV = 2
BLOCK_K = 64
SPLITS = (1, 2, 3, 7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _references(q, k, v, length):
    """(Pallas kernel in interpret mode, oracle) at a traced length; the
    cache is padded to the kernel's block with rows past any length."""
    pad = (-k.shape[1]) % BLOCK_K
    kp, vp = (jnp.pad(a, [(0, 0), (0, pad), (0, 0), (0, 0)]) for a in (k, v))
    return (decode_attention_pallas(q, kp, vp, length, block_k=BLOCK_K,
                                    interpret=True),
            jax_decode_attention_ref(q, k, v, length))


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(dtype_of(dtype)) for a in arrays])


def _err(port, ref) -> float:
    return rel_err(port.float().numpy(), np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("G", (1, 2, 4))
@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=lambda c: c.name)
def test_split_ref_matches_pallas_and_oracle(case, dtype, G):
    """A cache of M + 11 rows (no block multiple) valid up to 0 rows, 1, a
    ragged count and every row, at each split: equal to the Pallas kernel
    everywhere, and to the oracle wherever a key is valid (at length 0 the
    oracle averages the masked rows, the kernels give 0)."""
    i = [c.name for c in CONFORMANCE_CASES].index(case.name)
    Smax, D = case.M + 11, min(case.K, 128)
    (jq, jk, jv), (q, k, v) = _inputs(400 + 10 * i + G, dtype,
                                      (2, HKV * G, D), (2, Smax, HKV, D),
                                      (2, Smax, HKV, D))
    splits = sorted(set(SPLITS) | {decode_split_plan(2, HKV, Smax)})
    empty_shares = 0
    for length in (0, 1, Smax // 2 + 3, Smax):
        pallas, oracle = _references(jq, jk, jv, jnp.int32(length))
        for n_split in splits:
            port = decode_attention_split_ref(q, k, v, length, n_split)
            assert port.dtype == q.dtype and port.shape == q.shape
            empty_shares += sum(b <= a for a, b in
                                decode_split_shares(length, n_split))
            err = _err(port, pallas)
            assert err < DTYPE_TOL[dtype], (length, n_split, "pallas", err)
            if length:
                err = _err(port, oracle)
                assert err < DTYPE_TOL[dtype], (length, n_split, "oracle", err)
            else:
                assert not port.float().abs().max()
    assert empty_shares > 0


@pytest.mark.parametrize("seed", range(4))
def test_combine_matches_reference_split_softmax(seed):
    """The kernel's combine of per-split partials equals the reference's
    single-shard ``combine_split_softmax`` on the same masked scores, in
    fp32 within 1e-6."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, S, D = 2, 2, 4, 77, 16
    s = rng.standard_normal((B, Hkv, G, S)).astype(np.float32) * 3
    length = (1, 30, 76, 77)[seed]
    s[..., length:] = -1e30                       # masked as the model masks
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(combine_split_softmax(jnp.asarray(s), jnp.asarray(v)))
    for n_split in (1, 2, 3, 7, 13):
        got = combine_partials(*split_partials(
            torch.from_numpy(s), torch.from_numpy(v),
            decode_split_shares(S, n_split)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_combine_weights_empty_partials_out():
    """Empty partials (m = -inf, l = 0) weigh nothing; all empty gives 0."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(1, 1, 2, 9, generator=g)
    v = torch.randn(1, 9, 1, 4, generator=g)
    full = combine_partials(*split_partials(s, v, [(0, 9)]))
    padded = combine_partials(*split_partials(s, v, [(0, 5), (5, 9), (9, 9),
                                                     (9, 9)]))
    torch.testing.assert_close(padded, full, rtol=0, atol=1e-6)
    none = combine_partials(*split_partials(s, v, [(0, 0), (0, 0)]))
    assert torch.equal(none, torch.zeros_like(none))


# ------------------------------------------------------------- the plan --

def test_plan_never_takes_the_length():
    assert list(inspect.signature(decode_split_plan).parameters) == [
        "B", "Hkv", "Smax", "n_sm"]
    assert decode_split_plan(1, 8, 324) == decode_split_plan(1, 8, 324, 132)


def test_plan_at_the_path_shapes():
    """llama3-8b (8 kv heads, a 324-row cache) and zamba2-2.7b (32 kv
    heads, 616 rows) at B = 1 on 132 SMs."""
    assert decode_split_plan(1, 8, 324, 132) == 10
    assert decode_split_plan(1, 32, 616, 132) == 9


def _check_plan(B, Hkv, Smax, n_sm):
    n = decode_split_plan(B, Hkv, Smax, n_sm)
    assert n == decode_split_plan(B, Hkv, Smax, n_sm)          # fixed grid
    assert 1 <= n <= max_decode_split(Smax) <= ops.MAX_SPLITS
    blocks, want = B * Hkv * n, ops.WAVES * n_sm
    # fills the card WAVES times with the fewest splits, or takes the most
    # splits the cache allows
    assert blocks >= want or n == max_decode_split(Smax)
    assert n == 1 or B * Hkv * (n - 1) < want
    for length in sorted({0, 1, Smax // 3, Smax - 1, Smax}):
        shares = decode_split_shares(length, n)
        assert len(shares) == n
        assert shares[0][0] == 0 and shares[-1][1] == length
        assert all(a == b_prev for (_, b_prev), (a, _) in
                   zip(shares, shares[1:]))                 # contiguous
        sizes = [b - a for a, b in shares]
        assert all(s >= 0 for s in sizes)
        # every non-empty share holds at least one key, and the empty ones
        # are the last
        nonempty = [s for s in sizes if s > 0]
        assert sizes[:len(nonempty)] == nonempty
        if length == Smax and n > 1:
            assert min(nonempty) >= 1 and max(sizes) >= ops.MIN_SPLIT_KEYS


@pytest.mark.parametrize("seed", range(3))
def test_plan_properties_sweep(seed):
    rng = np.random.default_rng(seed)
    for _ in range(120):
        B = int(rng.integers(1, 9))
        Hkv = int(rng.choice([1, 2, 4, 8, 32]))
        Smax = int(rng.integers(1, 5000))
        n_sm = int(rng.choice([132, 114, 78, 16]))
        _check_plan(B, Hkv, Smax, n_sm)


# ----------------------------------------------------- the wrapper on CPU --

def test_wrapper_on_cpu_takes_the_oracle_and_counts_nothing():
    (_, _, _), (q, k, v) = _inputs(9, "float32", (1, 8, 32), (1, 40, 2, 32),
                                   (1, 40, 2, 32))
    before = decode_attention.launches
    for n_split in (None, 1, max_decode_split(40)):
        out = decode_attention(q, k, v, torch.tensor(33), n_split=n_split)
        assert torch.equal(out, decode_attention_ref(q, k, v, 33))
    assert decode_attention.launches == before


@pytest.mark.parametrize("n_split", [0, -1, 2])
def test_wrapper_refuses_splits_outside_the_plan(n_split):
    q, k = torch.zeros((1, 4, 16)), torch.zeros((1, 40, 2, 16))
    assert max_decode_split(40) == 1
    with pytest.raises(ValueError, match="n_split"):
        decode_attention(q, k, k, 3, n_split=n_split)


def test_split_ref_takes_a_tensor_length():
    (_, _, _), (q, k, v) = _inputs(11, "float32", (1, 4, 8), (1, 20, 2, 8),
                                   (1, 20, 2, 8))
    a = decode_attention_split_ref(q, k, v, torch.tensor([13], dtype=torch.int32),
                                   3)
    b = decode_attention_split_ref(q, k, v, 13, 3)
    assert torch.equal(a, b)
    assert math.isfinite(float(a.abs().max()))
