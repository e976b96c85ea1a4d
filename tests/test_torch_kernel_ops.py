"""The port's kernels as ``repro_torch`` operators (kernels/library.py,
kernels/work.py): for each of the eight, its fake implementation gives
the output's shape and dtype that the plain version gives on CPU tensors
(the kernel's own on the card), on fake CUDA tensors and without a
launch; ``FlopCounterMode`` counts a call by ``kernels/work.py``, which
matches a count by hand at one shape; the CPU operator returns what the
wrapper's plain version computes (a contiguous copy of it)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref, lse_ref)
from repro_torch.kernels.hetero_matmul.ops import (mxu_matmul, mxu_q4_matmul,
                                                   mxu_quant_matmul,
                                                   quantize_weight,
                                                   quantize_weight_int4)
from repro_torch.kernels.hetero_matmul.ref import (matmul_ref, q4_matmul_ref,
                                                   quant_matmul_ref)
from repro_torch.kernels.ssm_scan.ops import ssd_chunk, ssd_chunk_bwd
from repro_torch.kernels.ssm_scan.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

M, K, N = 128, 256, 384
B, SQ, SK, HQ, HKV, D = 1, 32, 64, 4, 2, 16
BB, L, NH, HD, NS = 1, 64, 4, 16, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name: str, device: str, g=None):
    """The operands of one call of ``name`` (random where ``g`` is given,
    else empty: under a FakeTensorMode)."""
    def t(shape, dtype=torch.float32):
        if g is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=g).to(dtype)
    if name == "mxu_matmul":
        return t((M, K), torch.bfloat16), t((K, N), torch.bfloat16)
    if name in ("mxu_quant_matmul", "mxu_q4_matmul"):
        x = t((M, K), torch.bfloat16)
        if g is None:
            rows = K if name == "mxu_quant_matmul" else K // 2
            return x, t((rows, N), torch.int8), t((N,))
        quant = (quantize_weight if name == "mxu_quant_matmul"
                 else quantize_weight_int4)
        return (x, *quant(t((K, N))))
    q, k, v = t((B, SQ, HQ, D)), t((B, SK, HKV, D)), t((B, SK, HKV, D))
    if name == "flash_attention":
        return q, k, v
    if name == "flash_attention_bwd":
        o = t((B, SQ, HQ, D)) if g is None else attention_ref(q, k, v)
        lse = t((B, HQ, SQ)) if g is None else lse_ref(q, k)
        return q, k, v, o, lse, t((B, SQ, HQ, D))
    if name == "decode_attention":
        length = (torch.empty((1,), dtype=torch.int32, device=device)
                  if g is None else torch.tensor([37], dtype=torch.int32))
        return t((2, 8, 128)), t((2, SK, 2, 128)), t((2, SK, 2, 128)), length
    xb, bc, seg = t((BB, L, NH, HD)), t((BB, L, NS)), t((BB, L, NH))
    if g is not None:
        seg = -seg.abs().cumsum(1) * 0.1
    s_prev = t((BB, NH, HD, NS))
    if name == "ssd_chunk":
        return xb, bc, t((BB, L, NS)), seg, s_prev
    return xb, bc, t((BB, L, NS)), seg, s_prev, t((BB, L, NH, HD)), \
        t((BB, NH, HD, NS))


WRAPPERS = {
    "mxu_matmul": (mxu_matmul, lambda x, w: matmul_ref(x, w)),
    "mxu_quant_matmul": (mxu_quant_matmul, quant_matmul_ref),
    "mxu_q4_matmul": (mxu_q4_matmul, q4_matmul_ref),
    "flash_attention": (flash_attention,
                        lambda q, k, v: attention_ref(q, k, v)),
    "flash_attention_bwd": (flash_attention_bwd,
                            lambda *a: attention_bwd_ref(*a)),
    "decode_attention": (decode_attention, decode_attention_ref),
    "ssd_chunk": (ssd_chunk, ssd_chunk_ref),
    "ssd_chunk_bwd": (ssd_chunk_bwd, ssd_chunk_bwd_ref),
}

_PAIRS = SQ * (SK - SQ + 1) + SQ * (SQ - 1) // 2      # 32 x 33 + 496
_SSD_PAIRS = L * (L + 1) // 2
# FLOPs by hand at the shapes above
HAND_FLOPS = {
    "mxu_matmul": 2 * 128 * 256 * 384,
    "mxu_quant_matmul": 2 * 128 * 256 * 384,
    "mxu_q4_matmul": 2 * 128 * 256 * 384,
    "flash_attention": 4 * 1 * 4 * 16 * 1552,          # QK^T and PV
    "flash_attention_bwd": 10 * 1 * 4 * 16 * 1552,
    "decode_attention": 4 * 2 * 8 * 128 * 64,           # the cache's rows
    # C.B^T; a head's masked product, decay and two state products
    "ssd_chunk": 2 * 16 * 2080 + 4 * (2 * 16 * 2080 + 2080
                                      + 4 * 16 * 16 * 64),
    "ssd_chunk_bwd": 2 * 16 * 2080 + 4 * (4 * 32 * 2080 + 5 * 2080
                                          + 10 * 64 * 16 * 16),
}


def _list(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_fake_implementation_matches_the_plain_outputs(name):
    wrapper, plain = WRAPPERS[name]
    g = torch.Generator().manual_seed(3)
    args = _inputs(name, "cpu", g)
    got, want = _list(wrapper(*args)), _list(plain(*args))
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.is_contiguous()
    before = wrapper.launches
    with FakeTensorMode():
        fake = _list(wrapper(*_inputs(name, "cuda")))
    assert [(t.shape, t.dtype, t.device.type) for t in fake] == \
        [(t.shape, t.dtype, "cuda") for t in want]
    assert wrapper.launches == before


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_work_flops_match_a_hand_count(name):
    assert _PAIRS == 1552 and _SSD_PAIRS == 2080
    wrapper, _ = WRAPPERS[name]
    args = _inputs(name, "cpu", torch.Generator().manual_seed(4))
    with FlopCounterMode(display=False) as fc:
        wrapper(*args)
    assert fc.get_total_flops() == HAND_FLOPS[name]


def test_work_bounds():
    """``bound`` takes the larger of the bytes' and the operations' time:
    the w_gate GEMM of PERF.md's table by its bytes."""
    flops, nbytes = work.gemm(256, 4096, 7168, 2)
    b = work.bound(flops, nbytes, "bfloat16")
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert round(b["bound_ms"], 5) == 0.01925           # PERF.md: 0.0193
    assert work.causal_pairs(SQ, SK, False) == SQ * SK
    assert work.causal_pairs(300, 300, True) == sum(
        min(i + 1, 300) for i in range(300))
