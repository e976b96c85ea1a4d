"""The port's attention kernels' plain versions against the reference's.

``attention_ref`` / ``decode_attention_ref`` (the plain versions that the
CUDA kernels are held to on the card, and that the wrappers run on CPU
tensors) are compared with the JAX package's Pallas kernels, in interpret
mode as ``tests/test_kernel_conformance.py`` runs them, where those take
the shape (Sq == Sk, a block-multiple cache), and with the JAX package's
oracles at the shapes only the engine gives (a chunk over a longer prefix,
Sq < Sk; a cache of any length). Inputs are made with numpy from a seed;
the cases follow ``CONFORMANCE_CASES`` (M the sequence, K the head dim) in
fp32, bf16 and fp16 under ``DTYPE_TOL``, with 1, 2 or 4 query heads per kv
head: each case meets each of the three once across the three dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL, rel_err
from repro.kernels.decode_attention.ops import \
    decode_attention as pallas_decode_attention
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_attention_ref
from repro.kernels.flash_attention.ops import \
    flash_attention as pallas_flash_attention
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro_torch.configs import dtype_of
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

ALIGN = 128
HKV = 2
GROUPS = (1, 2, 4)
CASE_IDS = [c.name for c in CONFORMANCE_CASES]
# the oracles compiled once per shape, not once per op (the flash oracle's
# causal and bidirectional answers in one compiled call)
jax_attention_refs = jax.jit(lambda q, k, v: {
    c: jax_attention_ref(q, k, v, causal=c) for c in (True, False)})
jax_decode_attention_ref = jax.jit(jax_decode_attention_ref)


def _case(case, dtype) -> tuple[int, int]:
    """(seed offset, query heads per kv head) of a case in a dtype."""
    i = CASE_IDS.index(case.name)
    return i, GROUPS[(i + CONFORMANCE_DTYPES.index(dtype)) % len(GROUPS)]


def _inputs(seed, dtype, *shapes):
    """The same values for both frameworks: numpy fp32 draws, each cast to
    ``dtype`` by its framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    th = [torch.from_numpy(a).to(dtype_of(dtype)) for a in arrays]
    return jx, th


def _err(port, ref) -> float:
    return rel_err(port.float().numpy(), np.asarray(ref).astype(np.float32))


def _pad_seq(a, mult):
    r = (-a.shape[1]) % mult
    return a if r == 0 else jnp.pad(a, [(0, 0), (0, r), (0, 0), (0, 0)])


# ------------------------------------------------ against the Pallas kernels --

@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=CASE_IDS)
def test_plain_flash_matches_pallas_kernel(case, dtype):
    """Sq == Sk, where the Pallas kernel's top-left causal mask is the
    bottom-right one. A ragged S is padded to the kernel's 64 block as the
    conformance harness pads it (causal only: padded keys are then
    invisible); an aligned S also runs bidirectional."""
    i, G = _case(case, dtype)
    S, D = case.M, min(case.K, ALIGN)
    (jq, jk, jv), (q, k, v) = _inputs(i, dtype, (1, S, HKV * G, D),
                                      (1, S, HKV, D), (1, S, HKV, D))
    for causal in (True, False) if S % 64 == 0 else (True,):
        want = pallas_flash_attention(
            *(_pad_seq(a, 64) for a in (jq, jk, jv)), causal=causal,
            block_q=64, block_k=64)[:, :S]
        err = _err(attention_ref(q, k, v, causal=causal), want)
        assert err < DTYPE_TOL[dtype], (case.name, G, causal, err)


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=CASE_IDS)
def test_plain_decode_matches_pallas_kernel(case, dtype):
    """A block-multiple cache (256 rows, block 128) valid up to M rows."""
    i, G = _case(case, dtype)
    Smax, length, D = 256, min(case.M, 256), min(case.K, ALIGN)
    (jq, jk, jv), (q, k, v) = _inputs(100 + i, dtype, (2, HKV * G, D),
                                      (2, Smax, HKV, D), (2, Smax, HKV, D))
    want = pallas_decode_attention(jq, jk, jv, length, block_k=128)
    err = _err(decode_attention_ref(q, k, v, length), want)
    assert err < DTYPE_TOL[dtype], (case.name, G, err)


# ---------------------------------------------- against the JAX oracles ------

@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=CASE_IDS)
def test_plain_flash_matches_oracle_chunk_over_prefix(case, dtype):
    """Sq < Sk: a chunk of M queries at cache position 37 over its prefix
    of M + 37 keys (the engine's chunk after the first), causal and not."""
    i, G = _case(case, dtype)
    Sq, D = case.M, min(case.K, ALIGN)
    Sk = Sq + 37
    (jq, jk, jv), (q, k, v) = _inputs(200 + i, dtype, (2, Sq, HKV * G, D),
                                      (2, Sk, HKV, D), (2, Sk, HKV, D))
    wants = jax_attention_refs(jq, jk, jv)
    for causal in (True, False):
        err = _err(attention_ref(q, k, v, causal=causal), wants[causal])
        assert err < DTYPE_TOL[dtype], (causal, err)


@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=CASE_IDS)
def test_plain_decode_matches_oracle_ragged_cache(case, dtype):
    """A cache of M + 11 rows (no block multiple), valid up to 1 row, a
    ragged count and every row."""
    i, G = _case(case, dtype)
    Smax, D = case.M + 11, min(case.K, ALIGN)
    (jq, jk, jv), (q, k, v) = _inputs(300 + i, dtype, (2, HKV * G, D),
                                      (2, Smax, HKV, D), (2, Smax, HKV, D))
    for length in (1, Smax // 2 + 3, Smax):
        err = _err(decode_attention_ref(q, k, v, torch.tensor(length)),
                   jax_decode_attention_ref(jq, jk, jv, jnp.int32(length)))
        assert err < DTYPE_TOL[dtype], (length, err)


# ------------------------------------------------------ wrappers on the CPU --

def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    (_, _, _), (q, k, v) = _inputs(7, "float32", (1, 44, 8, 16),
                                   (1, 300, 2, 16), (1, 300, 2, 16))
    before = (flash_attention.launches, decode_attention.launches)
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       attention_ref(q, k, v, causal=False))
    length = torch.tensor(301, dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, 0], k, v, length),
                       decode_attention_ref(q[:, 0], k, v, length))
    assert torch.equal(decode_attention(q[:, 0], k, v, 7),
                       decode_attention_ref(q[:, 0], k, v, 7))
    assert (flash_attention.launches, decode_attention.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, k)                 # causal over fewer keys
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16)))
    with pytest.raises(TypeError, match="unsupported dtypes"):
        flash_attention(q, k.half(), k.half(), causal=False)
    with pytest.raises(ValueError, match="expected q"):
        decode_attention(q, k, k, 1)
