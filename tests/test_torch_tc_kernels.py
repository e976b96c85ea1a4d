"""The tensor-core kernels' numerics, on the CPU, against the JAX package.

The bf16 / fp16 GEMM (``csrc/hetero_matmul.cu``) may split K: each split's
product is an fp32 partial, and a second pass sums the partials in split
order, then casts. ``matmul_split_ref`` is that arithmetic in plain PyTorch;
here it is held to the reference ``matmul_pallas`` in interpret mode (as
``tests/test_torch_hetero_matmul.py`` runs it) at splits 1, 2 and 4 over the
conformance grid. The bf16 / fp16 flash kernel (``csrc/flash_attention.cu``)
rounds the probabilities P to the input type before the P V product on the
tensor cores, where the reference keeps P in fp32;
``attention_rounded_p_ref`` is that arithmetic, held to the JAX package's
``attention_ref`` at the smoke model's and the path's head dims (16, 80,
128). Inputs come from numpy with a seed; tolerances are DTYPE_TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (CONFORMANCE_CASES, CONFORMANCE_DTYPES, DTYPE_TOL,
                      pad_to, rel_err)
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro.kernels.hetero_matmul.kernel import matmul_pallas
from repro_torch.configs import dtype_of
from repro_torch.core.partition import _pad_to
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_rounded_p_ref)
from repro_torch.kernels.hetero_matmul.ref import matmul_ref, matmul_split_ref

ALIGN = 128
jax_attention_refs = jax.jit(lambda q, k, v: {
    c: jax_attention_ref(q, k, v, causal=c) for c in (True, False)})


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(dtype_of(dtype)) for a in arrays])


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("case", CONFORMANCE_CASES, ids=lambda c: c.name)
def test_split_k_plain_matches_pallas(case, dtype, split):
    """fp32 partials over ``split`` slices of the padded K, summed in split
    order and cast, vs ``matmul_pallas(..., interpret=True)``."""
    (jx, jw), (tx, tw) = _inputs(11, dtype, (case.M, case.K),
                                 (case.K, case.N))
    jxp = pad_to(pad_to(jx, ALIGN, 0), ALIGN, 1)
    jwp = pad_to(pad_to(jw, ALIGN, 0), ALIGN, 1)
    ref = np.asarray(matmul_pallas(jxp, jwp, interpret=True), np.float32)
    txp = _pad_to(_pad_to(tx, ALIGN, 0), ALIGN, 1)
    twp = _pad_to(_pad_to(tw, ALIGN, 0), ALIGN, 1)
    y = matmul_split_ref(txp, twp, split)
    assert y.dtype == dtype_of(dtype)
    assert rel_err(y.float().numpy(), ref) <= DTYPE_TOL[dtype]


def test_split_k_plain_sums_in_split_order():
    """Split 1 is the unsplit plain version; a larger split is the ordered
    sum of the slices' fp32 products, bit for bit; a split that does not
    divide K raises."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(128, 512, generator=g).bfloat16()
    w = torch.randn(512, 256, generator=g).bfloat16()
    assert torch.equal(matmul_split_ref(x, w, 1), matmul_ref(x, w))
    parts = [x[:, i:i + 128].float() @ w[i:i + 128].float()
             for i in range(0, 512, 128)]
    acc = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(matmul_split_ref(x, w, 4), acc.bfloat16())
    with pytest.raises(ValueError):
        matmul_split_ref(x, w, 3)


# head dims: the smoke model's 16, zamba2's 80, llama3's 128
@pytest.mark.parametrize("D", [16, 80, 128])
@pytest.mark.parametrize("dtype", CONFORMANCE_DTYPES)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("Sq,Sk", [(77, 77), (44, 109)])
def test_flash_rounded_p_plain_matches_reference(D, dtype, G, Sq, Sk):
    """P rounded to the input type before P V, against the JAX package's
    fp32-P ``attention_ref``, causal and not, within DTYPE_TOL."""
    hkv = 2
    (jq, jk, jv), (q, k, v) = _inputs(7 + D + G, dtype, (1, Sq, hkv * G, D),
                                      (1, Sk, hkv, D), (1, Sk, hkv, D))
    refs = jax_attention_refs(jq, jk, jv)
    for causal in (True, False):
        if not causal and Sq != Sk:
            continue
        out = attention_rounded_p_ref(q, k, v, causal=causal)
        ref = np.asarray(refs[causal], np.float32)
        assert out.dtype == dtype_of(dtype)
        assert rel_err(out.float().numpy(), ref) <= DTYPE_TOL[dtype]


def test_rounded_p_is_attention_ref_in_fp32():
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((2, 33, 4, 80), (2, 50, 2, 80), (2, 50, 2, 80)))
    torch.testing.assert_close(attention_rounded_p_ref(q, k, v),
                               attention_ref(q, k, v), rtol=0, atol=2e-6)
