"""The work of each kernel: its FLOPs and its compulsory HBM bytes.

One definition serves three readers: the kernel ops' FLOP formulas
(``torch.utils.flop_counter.register_flop_formula``, so a
``FlopCounterMode`` or ``roofline/count.py`` sees a kernel call as its
work), the byte count of ``roofline/count.py`` (a kernel op moves its
compulsory bytes, not its operands' and outputs' as an eager op does), and
the ``bound_ms`` / ``bound_by`` of each kernel row that ``chip_smoke.py``
prints. Compulsory bytes are each input read once and each output written
once; the FLOPs are the useful ones: a causal attention counts its visible
(query, key) pairs, the SSD chunk its stages over the causal pairs (C·Bᵀ
once per batch). Each function returns ``(flops, bytes)``.

The bound is the larger of the bytes over the card's memory rate and the
FLOPs over its peak rate for the operands' type (NVIDIA H100 SXM5
datasheet, dense, at 700 W).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "tf32": 495e12}


def bound(flops: float, nbytes: float, dtype: str) -> dict:
    """``bound_ms`` (the least time of the work on the card) and
    ``bound_by`` ("bytes" or "operations", whichever sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gemm(M: int, K: int, N: int, el: int) -> tuple[int, int]:
    """``[M, K] @ [K, N]`` in a type of ``el`` bytes."""
    return 2 * M * K * N, (M * K + K * N + M * N) * el


def quant_gemm(M: int, K: int, N: int, el: int, w_bytes_per_el: float
               ) -> tuple[int, float]:
    """The weight-only quantized product: codes of ``w_bytes_per_el`` (1
    int8, 0.5 packed int4) and an fp32 scale a column."""
    return 2 * M * K * N, (M * K + M * N) * el + K * N * w_bytes_per_el \
        + N * 4


def causal_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """Visible (query, key) pairs; causal aligned bottom-right (query ``i``
    sees keys ``j <= i + Sk - Sq``)."""
    if not causal:
        return Sq * Sk
    return Sq * (Sk - Sq + 1) + Sq * (Sq - 1) // 2


def flash(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, el: int,
          causal: bool, lse: bool = False) -> tuple[int, int]:
    """The forward: two products over the visible pairs; q read and o
    written, k and v read, and the rows' fp32 log-sum-exp written when the
    backward needs it."""
    flops = 4 * B * Hq * D * causal_pairs(Sq, Sk, causal)
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) * el
    return flops, nbytes + (4 * B * Hq * Sq if lse else 0)


def flash_at(B: int, Sq: int, Smax: int, Hq: int, Hkv: int, D: int, el: int,
             start: int | None = None) -> tuple[int, int]:
    """The device-start entry: a causal chunk of ``Sq`` queries at
    ``start`` over a cache of ``Smax`` rows, which reads keys
    ``[0, start + Sq)`` only. The start lives on the card, where a trace
    cannot read it: without one it is counted at its upper bound, the
    chunk at the cache's end (``start = Smax - Sq``, every row read); a
    timed call passes its own."""
    start = Smax - Sq if start is None else start
    return flash(B, Sq, start + Sq, Hq, Hkv, D, el, True)


def flash_bwd(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, el: int,
              causal: bool) -> tuple[int, int]:
    """The backward: five products over the visible pairs; q, k, v, o, dO
    and the log-sum-exp read once, dq, dk, dv written once."""
    nq, nk = B * Sq * Hq * D, B * Sk * Hkv * D
    return (10 * B * Hq * D * causal_pairs(Sq, Sk, causal),
            el * (4 * nq + 4 * nk) + 4 * B * Hq * Sq)


def decode(B: int, Hq: int, Hkv: int, D: int, n_keys: int, el: int
           ) -> tuple[int, int]:
    """One query token a sequence over ``n_keys`` cache rows: the kernel
    ops count the cache's rows (its length lives on the device); a timed
    call passes its length."""
    return (4 * B * Hq * D * n_keys,
            (2 * B * Hq * D + 2 * B * n_keys * Hkv * D) * el)


def ssd_chunk(Bb: int, L: int, nh: int, hd: int, N: int) -> tuple[int, int]:
    """One SSD chunk step in fp32: xb, B_, C_, seg, S_prev read, y and S_new
    written; C·Bᵀ once per batch over the causal pairs, then a head's
    masked product, its decay and the state's two products."""
    pairs = L * (L + 1) // 2
    nbytes = 4 * (2 * Bb * L * nh * hd + 2 * Bb * L * N + Bb * L * nh
                  + 2 * Bb * nh * hd * N)
    flops = 2 * Bb * N * pairs + Bb * nh * (2 * hd * pairs + pairs
                                            + 4 * hd * N * L)
    return flops, nbytes


def ssd_chunk_bwd(Bb: int, L: int, nh: int, hd: int, N: int
                  ) -> tuple[int, int]:
    """The chunk step's gradient in fp32: xb, B_, C_, seg, S_prev, dy and
    dS_new read, dxb, dB_, dC_, dseg and dS_prev written; C·Bᵀ once per
    batch, then a head's dM, Mᵀ dy, dA B and dAᵀ C over the causal pairs,
    five operations a pair for the decay and its products, and the five
    state products."""
    pairs = L * (L + 1) // 2
    n_x, n_bc, n_s = Bb * L * nh * hd, Bb * L * N, Bb * nh * hd * N
    nbytes = 4 * (3 * n_x + 4 * n_bc + 2 * Bb * L * nh + 3 * n_s)
    flops = 2 * Bb * N * pairs + Bb * nh * (
        4 * (hd + N) * pairs + 5 * pairs + 10 * L * hd * N)
    return flops, nbytes
