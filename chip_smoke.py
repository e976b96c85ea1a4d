#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them or outside a checkout of the repository. Phases, each raising
on failure:

  1. card and build: the card's name and power limit (nvidia-smi), then
     every CUDA source of the port built with nvcc for sm_90a, each
     kernel's registers, stack and spills from ``-Xptxas -v`` (a spill in a
     tensor-core kernel, the SSD chunk's included, or a split-KV decode
     kernel fails);
  2. each kernel against its plain PyTorch version on the card, over the
     conformance shapes and the serving path's own shapes, in fp32, bf16
     and fp16, within the reference's DTYPE_TOL: the fp GEMM in both
     stationary orders with strided operands, direct and in the exchanged
     order, the bf16 / fp16 tensor-core kernel at split 1, the plan's split
     and the largest its plan allows; the int8 and W4A16 GEMMs on
     codes from the port's quantizers, direct and as a column slice of a
     wider code tensor, through HeteroCtx's padding, and the bf16 / fp16
     tensor-core kernel of each (int8 codes, packed int4 codes) at split
     1, the plan's and the largest, also against its own order (scale
     after the K sum); the flash- and
     decode-attention kernels over the conformance grid (1/2/4 query heads
     per kv head, causal and not, Sq == Sk and Sq < Sk, block-multiple and
     ragged caches, lengths 0 / 1 / ragged / all, decode at split 1, the
     plan's and the largest, D = 16, odd and 128) and the
     engine's shapes at llama3-8b and at zamba2-2.7b's shared block (D = 80,
     32 / 32 heads); the SSD chunk kernel over the conformance grid (L the
     case's M, inputs rounded through fp32 / bf16 / fp16), the smoke model's
     hd = N = 16 and the zamba2 path shapes (L = 256, 88, 1), S_prev zero
     and not, within the reference's 1e-4 of the plain version and of its
     own split-fp32 arithmetic, and ``ssd_scan`` over two chunks; kernel,
     plain and library timings with CUDA events, and the kernel's and the
     library's device time from torch.profiler (decode also at split 1 and
     the largest; the quantized GEMMs beside torch.matmul's bf16 product
     at the same shape; the SSD chunk beside both of its bounds: fp32 on
     the CUDA cores, and split fp32 on the TF32 tensor cores);
  3. token identity on the card: the fp32 llama3 smoke model served by
     PagedBatcher under every engine mode and both sync arms, its decode
     windows and ticks replaying captured CUDA graphs, and with eager
     decode loops (hetero-tensor, both syncs), and by the port on the CPU,
     gives the same greedy tokens, with fp weights and with int8 / W4A16
     weights crossed with a bf16 / int8 KV pool; each captured arm holds one
     graph, replayed once per decode dispatch, each window or tick after the
     first reading the host once (CUDA's sync debug mode); each kernel
     launches exactly where the plan sends work to it; two sampled runs from
     one seed agree. Then the same model through InferenceEngine, 4 prefill
     strategies x 4 engine modes x fast and host sync (captured) and the
     hetero-tensor arms with eager loops, two prompts of one length each
     (the second reusing the cache and the graph), against the engine on
     the CPU, each kernel launching as often as the chunks and the plan
     predict, the eager arms as often as the captured; then the fp32 zamba2
     smoke model the same way (the hybrid's pipe held to the CPU's pipe: its
     zero-padded tail moves the recurrent state, as in the reference);
  4. the slices at full width, their decode loops captured (the main
     path): llama3-8b (32 layers, bf16, seeded random weights) served
     through PagedBatcher(engine_mode="hetero-tensor", sync="device",
     window=8) against the engine_mode=None arm on the same weights and
     prompts, three times: fp weights, int8 weights with an int8 KV pool,
     W4A16 weights with the bf16 pool (each batcher: a first run that
     captures, a timed run, the hetero-tensor one a profiled run); then the
     single-request engine on the same weights (prompt 300, 16 new tokens,
     hetero strategy) in three arms: hetero-tensor with fast sync (its
     replayed decode loop run with CUDA's sync debug mode set to error),
     xla with fast sync, and hetero-tensor with host sync; then the first
     arm through the attention kernels against the same arm through their
     plain versions, on the first-token and first decode step logits
     (``attention_gate``; ``scripts/attention_gate_mutants.py`` shows that
     wrong attentions fail it); then ``phase_graph_decode``: each paged
     pair's hetero-tensor arm and the engine's first arm against an eager
     arm in this call (tok/s, decode and prefill time, profiled busy share,
     the graphs' count, capture time and pool bytes, launches per kernel;
     tokens and launches must be equal); then, the llama3 weights and
     graphs freed, zamba2-2.7b (54 mamba layers, d_model 2560, bf16, seeded
     random weights) through the engine (prompt 600: chunks 512 and 88, 162
     SSD launches a generate) with hetero-tensor and xla fast sync, then
     ``ssd_gate`` (the SSD kernel against its plain version on the same
     logits, and on the first mamba layer's scan output and state within
     the chunk's 1e-4; ``scripts/ssd_gate_mutants.py`` shows that wrong SSD
     steps, one pass of TF32 among them, fail it), ``attention_gate`` on
     this model, and its engine's ``phase_graph_decode`` pair.

Among them run the phases of the solver's cost model and its two streams:

  A. (after phase 2) ``phase_characterize``: launch + fence cost, one
     cross-stream event wait on the card, HBM copy rate of one and of two
     concurrent streams, torch.matmul's and the aligned path's device time
     at the llama3-8b sites (M = 256) against the stage model, a fenced
     M = 1 product beyond its bytes; each printed beside ``H100``'s
     committed constant;
  D. (after phase 3, smoke) ``phase_two_streams_smoke``: a plan that
     splits every site (``split_plan``) on the fp32 smoke models gives the
     same greedy tokens on two streams, on one (``_one_stream``) and on
     the CPU, the engine's decode loop captured with splits inside;
  B. (before phase 4) ``phase_profile``: ``profile_measured`` at full
     width, uncapped, for llama3-8b (fp, int8, W4A16) and zamba2-2.7b:
     wall time, decisions per strategy, where the plan differs from V5E's;
  C. (in phase 4) each paged pair and each engine also runs a
     hetero-tensor arm on the plan of its measured table, held to the
     same first-token cosine;
  D. (after phase 4's graph pairs) ``phase_two_streams``: llama3-8b on
     ``split_plan`` on two streams and on one: first-token, eager and
     captured decode logits bitwise equal, captured tokens equal; prefill
     time, captured decode step time, and from profiler traces the share
     of the aligned halves' device time that overlaps the flexible halves.

  E. (after D, before the llama3 weights leave the card)
     ``phase_serving_arms``: mixed batching, speculative decoding and the
     prefix cache. On the fp32 llama3 smoke model, hetero-tensor, on the
     card and on the CPU: mixed (sync device, window 3, and sync host),
     spec (k = 3, self-drafted and with an independent fp32 smollm smoke
     draft, both syncs), prefix (two waves sharing a 64-token prefix, fp
     and int8 pools), int8 + int8 KV and W4A16 with mixed and prefix; each
     gives the non-arm batcher's tokens of its format on its device, and
     the card's tokens equal the CPU's. Then llama3-8b at full width
     (bf16, V5E plan, sync device, window 8, width 8, block 32): a mixed
     arm on phase 4's prompts (fused steps, fewer standalone prefill
     dispatches than phase 4's fp arm, GEMM 2.1 launched in the
     chunk-carrying windows), a spec arm (self-draft, k = 4: verify
     dispatches below the fp arm's decode steps, flash attention launched
     by the draft prefill; acceptance and token agreement printed) and a
     prefix arm (two waves of four requests sharing a 256-token prefix
     against a plain batcher on the same waves: a warm hit, every block
     back); every arm's first-token logits at cosine >= 0.99 of its plain
     arm's. Each arm's tok/s, prefill and decode time, stats, graphs,
     capture seconds, pool bytes and launches are logged (``[arms]``).

  F. (after E, before the llama3 weights leave the card)
     ``phase_front_end``: the serving front end. F0, on the fp32 llama3
     smoke model on the card and the CPU: the dense ContinuousBatcher, and
     AsyncServer (open loop on a FakeClock, a priority mix on an 11-block
     pool) over PagedBatcher with host sync and the prefix cache and with
     device sync, each through a preemption and its resume, give the
     port's sequential reference's tokens, a traced run the untraced run's
     (its counters reconciled), and the card the CPU's. F1: llama3-8b at
     full width through AsyncServer over PagedBatcher (hetero-tensor, sync
     device, window 8, width 8, prefix cache) on a MonotonicClock with a
     live Tracer: 8 requests drawn as serve.py draws them (lengths 8..300,
     priority mix 0.5, 16 new tokens) arriving Poisson at 4 req/s on a
     pool of 12 blocks of 32 (gates: every stream complete, no leaked
     block, counters reconciled with stats(), the saved Chrome
     trace valid under scripts/check_trace.py with every fused_window span
     (the fenced replay) inside its window's span, a drift row for every plan
     site, GEMM 2.1 launched; TTFT / TPOT / queue delay, goodput, the
     drift table and the tokens against a closed-loop run are logged);
     then the same requests on a FakeClock (0.1 s a tick, low priorities
     arriving at 0 s, high at 0.05 s), whose schedule preempts on every
     device (gates: a preemption, every stream complete, no leaked block).
     F2: the dense ContinuousBatcher (4 slots) on phase 4's prompts, closed
     loop through AsyncServer: first-token cosine >= 0.999 against phase
     4's engine-less fp arm, kernels 2.4 and 2.5 launched. (``[front-end]``
     lines.)

  G. (after the zamba2 phases, those weights freed) ``phase_families``:
     the MoE, RWKV6 and encoder-only families. G0, on the fp32 smoke
     models, card against CPU: qwen2-moe, dbrx and chameleon through
     PagedBatcher (hetero-tensor, sync device and host); qwen2-moe, dbrx
     and rwkv6 through InferenceEngine (4 strategies x fast / host,
     captured and eager, as phase 3); hubert's encode of seeded frames
     within fp32 DTYPE_TOL. G1: qwen2-moe-a2.7b at full width (24 layers,
     d_model 2048, 60 experts top-4 and 4 shared; bf16, 28.6 GB): paged
     hetero-tensor against engine_mode=None on phase 4's prompts
     (first-token cosine >= 0.99, GEMM 2.1 launched), the engine
     (prompt 300; hetero-tensor and xla fast; 2.4 and 2.5 launched as
     predicted), ``attention_gate`` and captured against eager decode.
     G2: rwkv6-3b at full width (32 layers, d_model 2560), engine only,
     prompt 600: a second generate on the reused cache gives the first's
     tokens, captured equal to eager. G3: hubert-xlarge at full width (48
     layers, 16 heads of 80): encode of 1 x 1500 seeded frames through
     the bidirectional flash kernel against the same run with its plain
     version (cosine >= 0.999). Phase 2 carries the flash row at hubert's
     shape (1500 x 1500, not causal). (``[families]`` lines.) dbrx-132b
     and chameleon-34b do not fit one card at full width: their smoke
     runs in G0 stand for them.

  H. (after G, its weights freed) ``phase_training``: training through
     the flash kernel's backward (``csrc/flash_attention_bwd.cu``). H0 the
     backward kernel against ``attention_bwd_ref`` on the card in fp32,
     bf16 and fp16 over the attention conformance grid, hubert's smoke
     shape with D = 80 (bidirectional) and qwen3-1.7b's path shape [2,
     4096, 16 / 8, 128] causal in fp32 and bf16 (fp32 held to the plain
     version carried in fp64), the forward's log-sum-exp against
     ``lse_ref``, two launches bitwise equal, the bf16 path shape timed
     against the plain version and SDPA's backward. H1 the five fp32 smoke
     transformers' loss and gradients on the card against the CPU (flash
     forward twice a layer, backward once) and a ``train()`` crashed at
     step 7 with save_every=5 ending at the uninterrupted losses. H2
     qwen3-1.7b at full width (bf16, fp32 AdamW moments, per-layer remat,
     seq 4096 x batch 2): step 1's loss and gradients through the kernels
     against plain attention under autograd (loss 1e-3 relative, cosine
     >= 0.999 a leaf), then 1 warm-up and 4 timed steps (step time,
     tokens/s, model-FLOP share, peak memory, the kernels' launches) and a
     profiled step (busy share). (``[train]`` lines.)

The line before the last is the kernels JSON line (each kernel launched
on a phase E arm also carries ``serving_arms_launches``, on phase F's
F1 / F2 ``front_end_launches``, and on phase G's G1 / G3
``families_launches``; the flash entry carries hubert's row as
``encoder_row`` and its launches in H2's timed steps as
``training_launches``; the seventh row is the backward, not a TPU kernel,
its launches H2's); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the reference's conformance grid and tolerances (tests/conftest.py)
CONFORMANCE_CASES = (
    ("aligned", 128, 128, 128),
    ("rect", 256, 384, 128),
    ("ragged_m", 77, 128, 128),
    ("odd_k", 128, 97, 128),
    ("ragged_both", 53, 96, 256),
    ("quant_edges", 64, 95, 192),
)
# shapes the serving path gives the kernel at llama3-8b: wq's MXU block at
# a 128-token chunk, w_gate's at a 256-token chunk (plan: weight strategy),
# wk's at the engine's 44-token chunk (padded to 128: one 128 x 128 tile),
# w_down's at a 256-token chunk; and zamba2-2.7b's in_proj block at its
# 512-token chunk, which HeteroCtx launches in the exchanged order
PATH_CASES = (
    ("path_wq_m128", 128, 4096, 2048),
    ("path_wgate_m256", 256, 4096, 7168),
    ("path_wk_m44", 128, 4096, 128),
    ("path_wdown_m256", 256, 14336, 2048),
    ("path_inproj_m512", 512, 2560, 6528),
)
# the same sites' aligned blocks under the quantized plans (int8 and w4a16
# alike), each a column slice of the full [4096, n_full] code tensor
QUANT_PATH_CASES = (
    ("path_wq_m128", 128, 4096, 2560, 4096),
    ("path_wgate_m256", 256, 4096, 8960, 14336),
)
WEIGHT_FORMATS = ("int8", "w4a16")
DTYPE_TOL = {"float32": 2e-6, "bfloat16": 2e-2, "float16": 4e-3}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "tf32": 495e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    wide = torch_float(a, b)
    a32, b32 = a.to(wide), b.to(wide)
    return float((a32 - b32).abs().max() / (b32.abs().max() + 1e-9))


def torch_float(*ts):
    """fp64 where an operand is fp64, else fp32."""
    import torch
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()`` per call: the kernels' own time, summed by
    torch.profiler over ``iters`` calls, without the gaps in which the card
    waits for the host (which ``cuda_time_ms`` includes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1 --

# kernels whose -Xptxas -v report must show no spill: the tensor-core
# kernels (gemm_tc, qgemm_tc in int8 and int4, flash_tc, the SSD chunk's
# ssd_cb_tc and ssd_chunk_tc, the flash backward's two) and split-KV decode
# attention
SPILL_FREE = ("gemm_tc", "flash_tc", "decode_split", "decode_combine",
              "ssd_cb_tc", "ssd_chunk_tc", "flash_bwd_dkdv_tc",
              "flash_bwd_dq_tc")


def phase_card_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {len(reports)} source(s) built in "
        f"{time.perf_counter() - t0:.1f}s ({', '.join(build.SOURCES)})")
    spilled = []
    for name, out in reports.items():
        for fn, regs, spill, stack in _ptxas_report(out):
            log(f"[build] {name}: {fn[:72]}: {regs} registers, stack "
                f"{stack} bytes, spill stores/loads {spill[0]}/{spill[1]} "
                "bytes")
            if any(spill) and any(k in fn for k in SPILL_FREE):
                spilled.append(fn)
    if spilled:
        raise AssertionError(f"tensor-core kernels spill: {spilled}")
    return card


def _ptxas_report(out: str):
    """(entry function, registers, (spill store, spill load bytes), stack
    frame bytes) of each kernel in nvcc's ``-Xptxas -v`` output."""
    import re
    fn, spill, stack = None, (0, 0), 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            yield fn, int(m.group(1)), spill, stack
            fn, spill, stack = None, (0, 0), 0


# ------------------------------------------------------------------ phase 2 --

def _pad(t, mult=128):
    import torch.nn.functional as F
    r0, r1 = (-t.shape[0]) % mult, (-t.shape[1]) % mult
    return F.pad(t, (0, r1, 0, r0)) if (r0 or r1) else t


def phase_kernels() -> dict:
    """Every case x dtype x stationary order, plain and strided operands,
    direct and exchanged; the bf16 / fp16 tensor-core kernel (output
    order) at split 1, the plan's split and the largest the plan allows."""
    import torch
    from repro_torch.configs import dtype_of
    from repro_torch.core.characteristics import mxu_matmul_time_us
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import matmul_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {}
    n_checks = 0

    def plans(a, b, dname, st):
        """None (the plan inside the wrapper) for the FMA bodies; for the
        tensor-core kernel the forced plans at split 1, the plan's and the
        largest split, each at the plan's tile width."""
        if st != "output" or dname == "float32":
            return [None]
        (M, K), N = a.shape, b.shape[1]
        bm, bn, split = ops.gemm_plan(M, N, K, n_sm)
        return [(bm, bn, s) for s in sorted({1, split,
                                             ops.gemm_splits(K)[-1]})]

    for name, M, K, N in CONFORMANCE_CASES + PATH_CASES:
        x32 = torch.randn((M, K), generator=g, device="cuda")
        # a column slice of a wider weight, as the weight strategy passes it
        w32 = torch.randn((K, 2 * N), generator=g, device="cuda")
        for dname, tol in DTYPE_TOL.items():
            dt = dtype_of(dname)
            x, w = x32.to(dt), w32.to(dt)[:, :N]
            ref = matmul_ref(x, w)
            xp, wp = _pad(x), _pad(w)
            for st in ("output", "weight"):
                for form, a, b in (("direct", xp, wp),
                                   ("exchanged", wp.T, xp.T)):
                    for plan in plans(a, b, dname, st):
                        y = ops.mxu_matmul(a, b, stationary=st, plan=plan)
                        y = (y if form == "direct" else y.T)[:M, :N]
                        torch.cuda.synchronize()
                        e = rel_err(y, ref)
                        n_checks += 1
                        key = (dname, st)
                        worst[key] = max(worst.get(key, 0.0), e)
                        if not e <= tol:
                            raise AssertionError(
                                f"hetero_matmul {name} {dname} {st} {form} "
                                f"plan {plan}: rel_err {e:.3g} > {tol}")
    for (dname, st), e in sorted(worst.items()):
        log(f"[kernels] hetero_matmul {dname:8s} {st:6s}: worst rel_err "
            f"{e:.3g} <= {DTYPE_TOL[dname]}")
    log(f"[kernels] {n_checks} checks passed")

    # timing at the path's shapes, bf16, in the operand order the path
    # launches (HeteroCtx._mxu's order exchange), cold-ish weights (> L2)
    timings = []
    for name, M, K, N in PATH_CASES:
        x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
        w = torch.randn((K, N), generator=g, device="cuda").bfloat16()
        exch = mxu_matmul_time_us(N, K, M) < mxu_matmul_time_us(M, K, N)
        a, b = (w.T, x.T) if exch else (x, w)
        ref = matmul_ref(x, w)
        y = ops.mxu_matmul(a, b)
        y = y.T if exch else y
        torch.cuda.synchronize()
        _, bn, split = ops.gemm_plan(a.shape[0], b.shape[1], K, n_sm)
        row = {
            "case": name, "M": M, "K": K, "N": N, "dtype": "bfloat16",
            "exchanged": exch, "plan_bn": bn, "plan_split": split,
            "blocks": a.shape[0] // 128 * (b.shape[1] // bn) * split,
            "max_abs_err": float((y.float() - ref.float()).abs().max()),
            "ms": cuda_time_ms(lambda: ops.mxu_matmul(a, b)),
            "device_ms": device_ms(lambda: ops.mxu_matmul(a, b)),
            "weight_stationary_ms": cuda_time_ms(
                lambda: ops.mxu_matmul(a, b, stationary="weight")),
            "plain_ms": cuda_time_ms(lambda: matmul_ref(x, w)),
            "library_ms": cuda_time_ms(lambda: torch.matmul(x, w)),
            "library_device_ms": device_ms(lambda: torch.matmul(x, w)),
        }
        nbytes = (M * K + K * N + M * N) * 2
        flops = 2 * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timings.append(row)
        log(f"[kernels] time {json.dumps(row)}")
    return {"timings": timings, "worst": worst}


def _quant_tools(fmt: str):
    """(wrapper, quantizer, plain version) of one weight format."""
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import (q4_matmul_ref,
                                                       quant_matmul_ref)
    if fmt == "int8":
        return ops.mxu_quant_matmul, ops.quantize_weight, quant_matmul_ref
    return ops.mxu_q4_matmul, ops.quantize_weight_int4, q4_matmul_ref


def _library_int8(x, wq, scale):
    """``torch._weight_int8pack_mm`` (codes [N, K], scales in x's type) as
    a yardstick, prepared outside the timed call; None, with the reason
    logged, where the card's PyTorch has no CUDA kernel for it."""
    import torch
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is None:
        log("[kernels] library: torch._weight_int8pack_mm is absent")
        return None
    w_nk = wq.T.contiguous()
    s_x = scale.to(x.dtype)
    try:
        y = op(x, w_nk, s_x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernels] library: torch._weight_int8pack_mm does not run on "
            f"CUDA here: {str(e).splitlines()[0][:160]}")
        return None
    return y, lambda: op(x, w_nk, s_x)


def _quant_tc_grid(g, cases, fmt: str) -> int:
    """The tensor-core kernel of weight format ``fmt`` (int8, or w4a16's
    packed int4 codes; bf16 / fp16 x) at split 1, the plan's and the largest
    ``gemm_splits`` allows, on the plan's tile width, with codes direct and
    as a column slice of a twice-wider code tensor, at the cases' padded
    shapes: against the plain version within DTYPE_TOL, and against its own
    order (``quant_matmul_colscale_ref`` on the unpacked codes). Returns the
    number of checks."""
    import torch
    from repro_torch.configs import dtype_of
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import (
        quant_matmul_colscale_ref, unpack_int4)

    wrapper, quantize, plain = _quant_tools(fmt)
    codes = (lambda wq: wq) if fmt == "int8" else unpack_int4
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    up = lambda v: -(-v // 128) * 128                          # noqa: E731
    worst, n_checks = {}, 0
    for name, M, K, N in cases:
        M, K, N = up(M), up(K), up(N)
        x32 = torch.randn((M, K), generator=g, device="cuda")
        w32 = torch.randn((K, 2 * N), generator=g, device="cuda")
        wide_q, wide_s = quantize(w32)
        forms = {"direct": quantize(w32[:, :N]),
                 "sliced": (wide_q[:, :N], wide_s[:N])}
        _, bn, split = ops.gemm_plan(M, N, K, n_sm)
        for dname in ("bfloat16", "float16"):
            x = x32.to(dtype_of(dname))
            for form, (wq, s) in forms.items():
                ref = plain(x, wq, s)
                for sp in sorted({1, split, ops.gemm_splits(K)[-1]}):
                    before = wrapper.launches
                    y = wrapper(x, wq, s, plan=(128, bn, sp))
                    own = quant_matmul_colscale_ref(x, codes(wq), s, split=sp)
                    torch.cuda.synchronize()
                    if wrapper.launches != before + 1:
                        raise AssertionError(f"{fmt} tc {name}: not launched")
                    e, e_own = rel_err(y, ref), rel_err(y, own)
                    n_checks += 1
                    key = (dname, "plain")
                    worst[key] = max(worst.get(key, 0.0), e)
                    worst[(dname, "own")] = max(worst.get((dname, "own"),
                                                          0.0), e_own)
                    if not (e <= DTYPE_TOL[dname]
                            and e_own <= DTYPE_TOL[dname]):
                        raise AssertionError(
                            f"quant_matmul {fmt} tc {name} ({M},{K},{N}) "
                            f"{dname} {form} plan (128, {bn}, {sp}): rel_err "
                            f"{e:.3g} vs plain, {e_own:.3g} vs its order > "
                            f"{DTYPE_TOL[dname]}")
    for (dname, against), e in sorted(worst.items()):
        log(f"[kernels] quant_matmul {fmt} tensor cores {dname:8s} vs "
            f"{against:5s}: worst rel_err {e:.3g} <= {DTYPE_TOL[dname]}")
    log(f"[kernels] {n_checks} {fmt} tensor-core checks passed (splits 1, "
        "the plan's, the largest; direct and sliced codes)")
    return n_checks


def phase_quant_kernels() -> dict:
    """The int8 and W4A16 GEMMs against their plain versions: every case x
    dtype, codes from the port's quantizers of the unpadded weight, direct
    and as a column slice of a twice-wider code tensor, through
    HeteroCtx._mxu (the production padding: odd K, ragged M and N)."""
    import torch
    from repro_torch.configs import dtype_of
    from repro_torch.core.partition import HeteroCtx, QuantWeight
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import matmul_ref

    g = torch.Generator(device="cuda").manual_seed(1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ctx = HeteroCtx(mode="mxu")
    worst, n_checks = {}, 0
    cases = CONFORMANCE_CASES + tuple(c[:4] for c in QUANT_PATH_CASES)
    for fmt in WEIGHT_FORMATS:
        wrapper, quantize, _ = _quant_tools(fmt)
        for name, M, K, N in cases:
            x32 = torch.randn((M, K), generator=g, device="cuda")
            w32 = torch.randn((K, 2 * N), generator=g, device="cuda")
            wide = QuantWeight(*quantize(w32), fmt, K)
            forms = {"direct": QuantWeight(*quantize(w32[:, :N]), fmt, K),
                     "sliced": wide.slice_n(0, N)}
            for dname, tol in DTYPE_TOL.items():
                x = x32.to(dtype_of(dname))
                for form, qw in forms.items():
                    before = wrapper.launches
                    y = ctx._mxu(x, qw)
                    ref = matmul_ref(x, qw.dequant(torch.float32))
                    torch.cuda.synchronize()
                    if wrapper.launches != before + 1:
                        raise AssertionError(f"{fmt} {name}: the kernel was "
                                             "not launched")
                    e = rel_err(y, ref)
                    n_checks += 1
                    worst[(fmt, dname)] = max(worst.get((fmt, dname), 0.0), e)
                    if not e <= tol:
                        raise AssertionError(
                            f"quant_matmul {fmt} {name} {dname} {form}: "
                            f"rel_err {e:.3g} > {tol}")
    for (fmt, dname), e in sorted(worst.items()):
        log(f"[kernels] quant_matmul {fmt:5s} {dname:8s}: worst rel_err "
            f"{e:.3g} <= {DTYPE_TOL[dname]}")
    log(f"[kernels] {n_checks} quantized checks passed")
    n_checks += sum(_quant_tc_grid(g, cases, fmt) for fmt in WEIGHT_FORMATS)

    # timing at the path's shapes, bf16, on the column slice the weight
    # strategy passes (the codes of the full weight live in one tensor)
    timings = {fmt: [] for fmt in WEIGHT_FORMATS}
    for fmt in WEIGHT_FORMATS:
        wrapper, quantize, plain = _quant_tools(fmt)
        for name, M, K, N, n_full in QUANT_PATH_CASES:
            x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
            wq_full, s_full = quantize(torch.randn(
                (K, n_full), generator=g, device="cuda"))
            wq, s = wq_full[:, :N], s_full[:N]
            y = wrapper(x, wq, s)
            ref = plain(x, wq, s)
            w_bf16 = QuantWeight(wq, s, fmt, K).dequant(torch.bfloat16)
            torch.cuda.synchronize()
            row = {
                "case": name, "M": M, "K": K, "N": N, "dtype": "bfloat16",
                "format": fmt, "codes_from": [K, n_full],
                "max_abs_err": float((y.float() - ref.float()).abs().max()),
                "rel_err": rel_err(y, ref),
                "ms": cuda_time_ms(lambda: wrapper(x, wq, s)),
                "device_ms": device_ms(lambda: wrapper(x, wq, s)),
                "plain_ms": cuda_time_ms(lambda: plain(x, wq, s)),
                "library_ms": None,
                # context: cuBLAS's bf16 product at the same shape
                "matmul_bf16_device_ms": device_ms(
                    lambda: torch.matmul(x, w_bf16)),
            }
            _, row["plan_bn"], row["plan_split"] = ops.gemm_plan(M, N, K,
                                                                 n_sm)
            if fmt == "int8":
                lib = _library_int8(x, wq, s)
                if lib is not None:
                    row["library_ms"] = cuda_time_ms(lib[1])
                    row["library_rel_err_vs_plain"] = rel_err(lib[0], ref)
                    row["library_note"] = ("torch._weight_int8pack_mm: codes "
                                           "[N,K], scales in bf16")
            else:
                row["library_note"] = (
                    "none: torch._weight_int4pack_mm takes grouped scales "
                    "with zero points in its own packing, another function")
            w_bytes = K * N * (1.0 if fmt == "int8" else 0.5)
            nbytes = (M * K + M * N) * 2 + w_bytes + N * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * M * K * N / PEAK_FLOPS["bfloat16"] * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            timings[fmt].append(row)
            log(f"[kernels] time {json.dumps(row)}")
    return {"timings": timings, "worst": worst}


def _attention_timing(kind: str, q, k, v, length=None, causal=True) -> dict:
    """Kernel, plain and library (SDPA) times of one attention call at a
    path shape, with its bound. ``kind`` is "flash" (causal, bottom-right,
    or bidirectional with ``causal=False``) or "decode" (the first
    ``length`` rows of the cache)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_split_plan,
                                                          max_decode_split)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = k.shape[2]
    if kind == "flash":
        Sq, Sk = q.shape[1], k.shape[1]
        run = lambda: flash_attention(q, k, v, causal=causal)    # noqa: E731
        plain = lambda: attention_ref(q, k, v, causal=causal)    # noqa: E731
        pairs = (sum(min(i + Sk - Sq + 1, Sk) for i in range(Sq)) if causal
                 else Sq * Sk)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
                ) if causal else None
        n_keys, shape = Sk, [B, Sq, Sk, Hq, Hkv, D]
    else:
        Smax = k.shape[1]
        n = torch.full((1,), length, dtype=torch.int32, device=q.device)
        run = lambda: decode_attention(q, k, v, n)               # noqa: E731
        plain = lambda: decode_attention_ref(q, k, v, n)         # noqa: E731
        pairs = length
        qt = q[:, :, None, :].contiguous()
        kt, vt = (t[:, :length].transpose(1, 2).contiguous() for t in (k, v))
        mask = None
        n_keys, shape = length, [B, Smax, length, Hq, Hkv, D]
    out, ref = run(), plain()
    torch.cuda.synchronize()
    row = {"kind": kind, "shape": shape, "dtype": str(q.dtype).split(".")[-1],
           "causal": causal if kind == "flash" else None,
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "rel_err": rel_err(out, ref),
           "ms": cuda_time_ms(run), "plain_ms": cuda_time_ms(plain)}
    try:
        lib = lambda: F.scaled_dot_product_attention(            # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib()
        row["library_note"] = ("scaled_dot_product_attention(enable_gqa="
                               "True" + (", explicit bottom-right mask)"
                                         if mask is not None else ")"))
        # (no mask: bidirectional flash, or decode over its valid rows)
    except TypeError:       # a PyTorch without enable_gqa: kv heads repeated
        kt, vt = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(            # noqa: E731
            qt, kt, vt, attn_mask=mask)
        row["library_note"] = "scaled_dot_product_attention, kv repeated"
    row["library_ms"] = cuda_time_ms(lib)
    row["device_ms"] = device_ms(run)
    row["library_device_ms"] = device_ms(lib)
    if kind == "decode":
        # the split-KV grid: the plan's split (timed above), 1 and the
        # largest, each held to the plain version
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        row["n_split"] = decode_split_plan(B, Hkv, Smax, n_sm)
        for label, n_split in (("split_1", 1),
                               ("split_max", max_decode_split(Smax))):
            split_run = lambda: decode_attention(                # noqa: E731
                q, k, v, n, n_split=n_split)
            row[f"{label}_rel_err"] = rel_err(split_run(), ref)
            row[f"{label}_device_ms"] = device_ms(split_run)
            row[f"{label}"] = n_split
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * B * n_keys * Hkv * D) * el
    flops = 4 * B * Hq * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[row["dtype"]] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def phase_attention_kernels() -> dict:
    """The flash- and decode-attention kernels against their plain versions
    on the card: the conformance grid (M the sequence, K the head dim, plus
    the smoke model's D = 16) x 1/2/4 query heads per kv head x dtype; flash
    causal and not, at Sq == Sk and over a longer prefix (Sq < Sk); decode
    over a block-multiple and a ragged cache, valid up to 1 row, a ragged
    count and every row; then the engine's own shapes at llama3-8b and at
    zamba2-2.7b's shared block and, bidirectional, at hubert-xlarge's
    encoder (the last row), timed against the plain version and SDPA."""
    import torch
    from repro_torch.configs import dtype_of
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_split_plan,
                                                          max_decode_split)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device="cuda").manual_seed(2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, n_checks = {}, 0

    def check(name, kernel, out, ref, dname, before):
        nonlocal n_checks
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        e = rel_err(out, ref)
        n_checks += 1
        key = (kernel.__name__, dname)
        worst[key] = max(worst.get(key, 0.0), e)
        if not e <= DTYPE_TOL[dname]:
            raise AssertionError(f"{name} {dname}: rel_err {e:.3g} > "
                                 f"{DTYPE_TOL[dname]}")

    def randn(*shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    cases = CONFORMANCE_CASES + (("smoke_d16", 77, 16, 0),)
    for name, M, K, _ in cases:
        D, Hkv = min(K, 128), 2
        for G in (1, 2, 4):
            for dname in DTYPE_TOL:
                dt = dtype_of(dname)
                for Sk in (M, M + 37):
                    q = randn(2, M, Hkv * G, D, dt=dt)
                    k, v = randn(2, Sk, Hkv, D, dt=dt), randn(2, Sk, Hkv, D,
                                                             dt=dt)
                    for causal in (True, False):
                        before = flash_attention.launches
                        out = flash_attention(q, k, v, causal=causal)
                        check(f"flash {name} G={G} Sk={Sk} causal={causal}",
                              flash_attention, out,
                              attention_ref(q, k, v, causal=causal), dname,
                              before)
                for Smax in (256, M + 11):
                    q = randn(2, Hkv * G, D, dt=dt)
                    k, v = randn(2, Smax, Hkv, D, dt=dt), randn(
                        2, Smax, Hkv, D, dt=dt)
                    plan = decode_split_plan(2, Hkv, Smax, n_sm)
                    for length in (0, 1, Smax // 2 + 3, Smax):
                        n = torch.full((1,), length, dtype=torch.int32,
                                       device="cuda")
                        # at length 0 the oracle averages the masked rows;
                        # the kernel gives 0, as the Pallas kernel does
                        ref = (decode_attention_ref(q, k, v, n) if length
                               else decode_attention_split_ref(q, k, v, n, 1))
                        for n_split in sorted({1, plan,
                                               max_decode_split(Smax)}):
                            before = decode_attention.launches
                            out = decode_attention(q, k, v, n,
                                                   n_split=n_split)
                            check(f"decode {name} G={G} Smax={Smax} "
                                  f"len={length} split={n_split}",
                                  decode_attention, out, ref, dname, before)
    for (kname, dname), e in sorted(worst.items()):
        log(f"[attention] {kname:16s} {dname:8s}: worst rel_err {e:.3g} <= "
            f"{DTYPE_TOL[dname]}")
    log(f"[attention] {n_checks} checks passed")

    # the engine's shapes at llama3-8b (B = 1, prompt 300, 16 new tokens,
    # hetero strategy: chunk 256 over 256 keys, chunk 44 over 300; decode
    # over the 324-row cache at lengths 301..315), bf16
    cfg_heads, D, bf16 = (32, 8), 128, torch.bfloat16
    Hq, Hkv = cfg_heads
    timings = []
    for Sq, Sk in ((256, 256), (44, 300)):
        q = randn(1, Sq, Hq, D, dt=bf16)
        k, v = randn(1, Sk, Hkv, D, dt=bf16), randn(1, Sk, Hkv, D, dt=bf16)
        timings.append(_attention_timing("flash", q, k, v))
    q = randn(1, Hq, D, dt=bf16)
    k, v = randn(1, 324, Hkv, D, dt=bf16), randn(1, 324, Hkv, D, dt=bf16)
    for length in (301, 315):
        timings.append(_attention_timing("decode", q, k, v, length))
    # the same at zamba2-2.7b's shared block (32 / 32 heads, D = 80; prompt
    # 600: chunk 512 over 512 keys, chunk 88 over 600; decode over the
    # 616-row cache at lengths 601..615)
    Hq, Hkv, D = 32, 32, 80
    for Sq, Sk in ((512, 512), (88, 600)):
        q = randn(1, Sq, Hq, D, dt=bf16)
        k, v = randn(1, Sk, Hkv, D, dt=bf16), randn(1, Sk, Hkv, D, dt=bf16)
        timings.append(_attention_timing("flash", q, k, v))
    q = randn(1, Hq, D, dt=bf16)
    k, v = randn(1, 616, Hkv, D, dt=bf16), randn(1, 616, Hkv, D, dt=bf16)
    for length in (601, 615):
        timings.append(_attention_timing("decode", q, k, v, length))
    # hubert-xlarge's encoder (phase G3): 16 / 16 heads, D = 80,
    # bidirectional over 1500 frames (30 s of audio at 50 Hz)
    q, k, v = (randn(1, 1500, 16, 80, dt=bf16) for _ in range(3))
    timings.append(_attention_timing("flash", q, k, v, causal=False))
    for row in timings:
        errs = [row[k] for k in ("rel_err", "split_1_rel_err",
                                 "split_max_rel_err") if k in row]
        if not max(errs) <= DTYPE_TOL["bfloat16"]:
            raise AssertionError(f"[attention] path shape {row['shape']}: "
                                 f"rel_err {row['rel_err']:.3g}")
        log(f"[attention] time {json.dumps(row)}")
    return {"timings": timings, "worst": worst}


SSD_TOL = 1e-4     # the reference's bound for the SSD chunk, every dtype row


def _ssd_inputs(g, Bb, L, nh, hd, N, dname="float32", state=True,
                conv_dim=None):
    """Seeded SSD chunk operands on the card, rounded through ``dname`` and
    held in fp32 as tests/test_kernel_conformance.py makes them; with
    ``conv_dim``, B_ and C_ are column slices of a wider [B, L, conv_dim]
    tensor, the layout the model's split hands the kernel."""
    import torch
    from repro_torch.configs import dtype_of

    def r(*shape, scale=1.0):
        t = torch.randn(shape, generator=g, device="cuda") * scale
        return t.to(dtype_of(dname)).float()

    xb = r(Bb, L, nh, hd, scale=0.5)
    if conv_dim is None:
        B_, C_ = r(Bb, L, N, scale=0.5), r(Bb, L, N, scale=0.5)
    else:
        wide = r(Bb, L, conv_dim, scale=0.5)
        B_, C_ = wide[..., conv_dim - 2 * N:conv_dim - N], wide[..., -N:]
    seg = -torch.cumsum(r(Bb, L, nh).abs() * 0.1, dim=1)
    S_prev = r(Bb, nh, hd, N, scale=0.3) if state else \
        torch.zeros((Bb, nh, hd, N), device="cuda")
    return xb, B_, C_, seg, S_prev


def _ssd_bound(Bb, L, nh, hd, N) -> dict:
    """The least time of one chunk step on the card: its bytes (each
    operand read once, y and S_new written once) over the memory rate
    against its fp32 operations over the causal pairs (C.B^T once per
    batch) over the CUDA-core fp32 rate (``bound_ms``, ``bound_by``); and
    beside it the same operations as the kernel runs them, three TF32
    products each (split fp32), over the TF32 tensor-core rate
    (``bound_split_tf32_ms``, ``bound_split_tf32_by``)."""
    pairs = L * (L + 1) // 2
    nbytes = 4 * (2 * Bb * L * nh * hd + 2 * Bb * L * N + Bb * L * nh
                  + 2 * Bb * nh * hd * N)
    flops = 2 * Bb * N * pairs + Bb * nh * (2 * hd * pairs + pairs
                                            + 4 * hd * N * L)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_split = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_split_tf32_ms": max(t_bytes, t_split),
            "bound_split_tf32_by": "bytes" if t_bytes >= t_split
            else "operations"}


def phase_ssd_kernel() -> dict:
    """The SSD chunk kernel against its plain version on the card: the
    conformance grid (L = each case's M, nh = 2, hd = N = 64, inputs rounded
    through fp32 / bf16 / fp16), the smoke model's hd = N = 16 (L 32, 13
    and 1), hd = 18 with N = 30, and the zamba2-2.7b path shapes (L = 256,
    88 and 1, nh = 80, hd = N = 64, B_ and C_ strided as the model passes
    them), each with S_prev zero and not, against the plain version and
    against the kernel's own arithmetic (``ssd_chunk_split_ref``: split
    fp32, C.B^T once per batch); then kernel (events and device) and plain
    times at the path shapes, and ssd_scan over S = 512 (two calls, the
    state carried on the card) against the plain chunk scan."""
    import torch
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import (ssd_chunk_ref,
                                                  ssd_chunk_split_ref)

    g = torch.Generator(device="cuda").manual_seed(5)
    worst, n_checks = {}, 0
    # (group, case, B, L, nh, hd, N, dtype the inputs round through, the
    # width of the tensor B_ and C_ are sliced out of)
    cases = [(dname, name, 2, M, 2, 64, 64, dname, None)
             for name, M, _, _ in CONFORMANCE_CASES for dname in DTYPE_TOL]
    cases += [("smoke", f"L{L}", 1, L, 8, 16, 16, "float32", None)
              for L in (32, 13, 1)]
    cases += [("path", f"L{L}", 1, L, 80, 64, 64, "bfloat16", 5248)
              for L in (256, 88, 1)]
    # hd and N not multiples of 4 (the kernel's 4-byte copies, DMAX 32)
    cases += [("odd", "hd18_N30", 2, 77, 3, 18, 30, "float32", None)]
    for key, name, Bb, L, nh, hd, N, dname, conv_dim in cases:
        for state in (False, True):
            args = _ssd_inputs(g, Bb, L, nh, hd, N, dname, state, conv_dim)
            before = ops.ssd_chunk.launches
            y, s_new = ops.ssd_chunk(*args)
            y_ref, s_ref = ssd_chunk_ref(*args)
            y_own, s_own = ssd_chunk_split_ref(*args)
            torch.cuda.synchronize()
            if ops.ssd_chunk.launches != before + 1:
                raise AssertionError(f"ssd_chunk {key} {name}: not launched")
            e = max(rel_err(y, y_ref), rel_err(s_new, s_ref))
            e_own = max(rel_err(y, y_own), rel_err(s_new, s_own))
            n_checks += 1
            worst[key] = max(worst.get(key, 0.0), e)
            worst[f"{key} own"] = max(worst.get(f"{key} own", 0.0), e_own)
            if not (torch.isfinite(y).all() and torch.isfinite(s_new).all()
                    and e <= SSD_TOL and e_own <= SSD_TOL):
                raise AssertionError(f"ssd_chunk {key} {name} S_prev "
                                     f"{'random' if state else 'zero'}: "
                                     f"rel_err {e:.3g} vs plain, {e_own:.3g} "
                                     f"vs its arithmetic > {SSD_TOL}")
    for key, e in sorted(worst.items()):
        log(f"[ssd] ssd_chunk {key:13s}: worst rel_err {e:.3g} <= {SSD_TOL}")
    log(f"[ssd] {n_checks} checks passed")

    timings = []
    for L in (256, 88):
        args = _ssd_inputs(g, 1, L, 80, 64, 64, "bfloat16", True, 5248)
        y, s_new = ops.ssd_chunk(*args)
        y_ref, s_ref = ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        row = {"kind": "ssd_chunk", "shape": [1, L, 80, 64, 64],
               "dtype": "float32",
               "max_abs_err": max(float((y - y_ref).abs().max()),
                                  float((s_new - s_ref).abs().max())),
               "rel_err": max(rel_err(y, y_ref), rel_err(s_new, s_ref)),
               "ms": cuda_time_ms(lambda: ops.ssd_chunk(*args)),
               "device_ms": device_ms(lambda: ops.ssd_chunk(*args)),
               "plain_ms": cuda_time_ms(lambda: ssd_chunk_ref(*args)),
               **_ssd_bound(1, L, 80, 64, 64), "library_ms": None,
               "library_note": "none: no single PyTorch call computes an SSD "
                               "chunk step"}
        timings.append(row)
        log(f"[ssd] time {json.dumps(row)}")

    # the scan: two chunks of 256 at full width, the state passed on the card
    Bb, S, nh, hd, N = 1, 512, 80, 64, 64
    xh = torch.randn((Bb, S, nh, hd), generator=g, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, nh), generator=g, device="cuda"))
    A = -torch.exp(torch.randn((nh,), generator=g, device="cuda") * 0.5)
    B_ = torch.randn((Bb, S, N), generator=g, device="cuda") * 0.5
    C_ = torch.randn((Bb, S, N), generator=g, device="cuda") * 0.5
    before = ops.ssd_chunk.launches
    y, s_fin = ops.ssd_scan(xh, dt, A, B_, C_, chunk=256)
    xb, Bf, Cf, seg = ops.chunk_inputs(xh, dt, A, B_, C_, 256)
    state, ys = torch.zeros_like(s_fin), []
    for i in range(2):
        sl = slice(256 * i, 256 * (i + 1))
        yi, state = ssd_chunk_ref(xb[:, sl], Bf[:, sl], Cf[:, sl], seg[:, sl],
                                  state)
        ys.append(yi)
    torch.cuda.synchronize()
    e = max(rel_err(y, torch.cat(ys, dim=1)), rel_err(s_fin, state))
    if ops.ssd_chunk.launches != before + 2 or not e <= SSD_TOL:
        raise AssertionError(f"ssd_scan S=512: {ops.ssd_chunk.launches - before}"
                             f" launches, rel_err {e:.3g}")
    log(f"[ssd] ssd_scan S=512 (2 launches, state on the card) vs the plain "
        f"chunk scan: rel_err {e:.3g} <= {SSD_TOL}")
    return {"timings": timings, "worst": worst}


# ------------------------------------------------------------------ phase 3 --

def _smoke_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 70, 130, 200)]


def _serve(cfg, params, prompts, *, device, engine_mode, sync, window,
           decode_width, new_tokens, weight_quant=None, kv_quant=None, **kw):
    from repro_torch.serving.scheduler import PagedBatcher
    max_len = max(len(p) for p in prompts) + new_tokens + 8
    per_req = -(-max_len // 32)
    cb = PagedBatcher(cfg, params, num_blocks=1 + len(prompts) * per_req,
                      block_size=32, max_blocks_per_seq=per_req,
                      decode_width=decode_width, sync=sync, window=window,
                      engine_mode=engine_mode, weight_quant=weight_quant,
                      kv_quant=kv_quant, device=device, **kw)
    return cb, _requests(prompts, new_tokens)


def _requests(prompts, new_tokens: int) -> list:
    from repro_torch.serving.scheduler import Request
    return [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]


class _eager_loops:
    """Inside this block the port's decode loops are made eager: each loop
    that ``core.sync`` makes copies its inputs to the card and runs its
    body step by step instead of a CUDA graph (for the eager arms held
    against the captured ones; the port itself has no such switch)."""

    def __enter__(self):
        from repro_torch.core import sync
        self.made = sync.make_loop

        def eager(body, inputs, **_):
            device = inputs[0].device
            return lambda *xs: body(*(x.to(device, non_blocking=True)
                                      for x in xs))

        sync.make_loop = eager

    def __exit__(self, *exc):
        from repro_torch.core import sync
        sync.make_loop = self.made


def _time_captures() -> None:
    """Record on every CapturedLoop the seconds its construction took (warm
    -up and capture) as ``capture_s``."""
    from repro_torch.core.sync import CapturedLoop
    init = CapturedLoop.__init__

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        init(self, *a, **k)
        self.capture_s = time.perf_counter() - t0

    CapturedLoop.__init__ = timed


def _graph_info(owner) -> dict:
    """A batcher's or an engine's decode graphs: count, replays, pool bytes
    and the seconds their captures took."""
    info = owner.graph_stats()
    info["capture_s"] = sum(getattr(lp, "capture_s", 0.0)
                            for lp in owner._loops.values())
    return info


def _count_syncs(cb) -> list:
    """Run the batcher's windows and ticks with CUDA's sync debug mode set
    to warn; returns the list that gets, per window or tick, the number of
    synchronising operations the mode reported in it."""
    import warnings
    import torch
    per_call = []

    def counting(fn):
        def run(*a, **k):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            per_call.append(sum("synchroniz" in str(w.message)
                                for w in seen))
            return out
        return run

    cb._decode_window = counting(cb._decode_window)
    cb._decode_tick = counting(cb._decode_tick)
    return per_call


def _counters():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.ssm_scan.ops import ssd_chunk
    return {"hetero_matmul": ops.mxu_matmul,
            "quant_matmul_int8": ops.mxu_quant_matmul,
            "quant_matmul_q4": ops.mxu_q4_matmul,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "ssd_chunk": ssd_chunk}


KERNEL_OF_FORMAT = {None: "hetero_matmul", "int8": "quant_matmul_int8",
                    "w4a16": "quant_matmul_q4"}


def _zero_counts() -> None:
    for c in _counters().values():
        c.launches = 0


def _read_counts() -> dict:
    return {k: c.launches for k, c in _counters().items()}


# (weight_quant, kv_quant) arms of the smoke-model token phase
TOKEN_FORMATS = ((None, None), ("int8", None), ("int8", "int8"),
                 ("w4a16", None), ("w4a16", "int8"))


def phase_tokens() -> None:
    """fp32 smoke model, fp weights and then int8 / w4a16 weights with an
    fp32 or int8 KV pool: within each format every engine mode x sync arm,
    on the card (captured decode graphs) and on the CPU, and the
    hetero-tensor arm of each sync on the card with eager decode loops,
    gives the same greedy tokens. A captured arm captures one graph (the
    window, or the tick's step) and replays it once per decode dispatch,
    each window or tick after the first reading the host once (CUDA's sync
    debug mode); an eager arm captures none. The format's kernel launches
    on the card in the mxu arms and wherever the hetero-tensor plan keeps a
    site off xla_only (sync device; under sync host the reference's 50 us
    T_sync keeps every smoke-size site there), and no other kernel
    launches: on quantized weights every matmul site, the untied head
    included, is quantized; decode launches no kernel of the port. Then
    temperature sampling: two captured runs from one seed agree, and
    whether they equal an eager run is logged."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
    cpu_params = _to_device(params, "cpu")
    prompts = _smoke_prompts(cfg.vocab_size)
    arms = [("cuda", m, s, False) for m in (None, "xla", "mxu",
                                            "hetero-tensor")
            for s in ("host", "device")]
    arms += [("cuda", "hetero-tensor", s, True) for s in ("host", "device")]
    arms += [("cpu", "hetero-tensor", "device", False)]
    for fmt, kvq in TOKEN_FORMATS:
        outputs = {}
        for device, mode, sync, eager in arms:
            with _eager_loops() if eager else nullcontext():
                cb, reqs = _serve(
                    cfg, params if device == "cuda" else cpu_params, prompts,
                    device=device, engine_mode=mode, sync=sync, window=4,
                    decode_width=4, new_tokens=12, weight_quant=fmt,
                    kv_quant=kvq)
                syncs = _count_syncs(cb) if device == "cuda" else []
                _zero_counts()
                cb.run(reqs)
            counts = _read_counts()
            cb.kv.assert_drained()
            arm = (f"{fmt or 'fp'}/kv={kvq}/{device}/{mode}/{sync}"
                   + ("/eager" if eager else ""))
            outputs[arm] = [r.output for r in reqs]
            graphs = cb.graph_stats()
            log(f"[tokens] {arm}: {cb.stats()} graphs {graphs} host syncs "
                f"per decode dispatch {syncs} launches {counts}")
            captured = device == "cuda" and not eager
            want = ({"graphs": 1, "replays": cb.decode_dispatches}
                    if captured else {"graphs": 0, "replays": 0})
            if {k: graphs[k] for k in want} != want:
                raise AssertionError(f"{arm}: graphs {graphs}, expected "
                                     f"{want}")
            if captured and any(n != 1 for n in syncs[1:]):
                raise AssertionError(f"{arm}: host syncs per decode "
                                     f"dispatch {syncs}, expected 1 after "
                                     "the capturing first")
            expect = device == "cuda" and (mode == "mxu" or (
                mode == "hetero-tensor" and any(
                    d.strategy != "xla_only"
                    for d in cb.ctx.plan.decisions.values())))
            mine = counts[KERNEL_OF_FORMAT[fmt]]
            if (mine > 0) != expect:
                raise AssertionError(f"{arm}: {mine} launches of "
                                     f"{KERNEL_OF_FORMAT[fmt]}, expected "
                                     f"{'some' if expect else 'none'}")
            if sum(counts.values()) != mine:
                raise AssertionError(f"{arm}: another kernel launched: "
                                     f"{counts}")
            del cb
        first = next(iter(outputs.values()))
        for arm, out in outputs.items():
            if out != first or any(len(o) != 12 for o in out):
                raise AssertionError(f"[tokens] {arm} differs: {out} vs "
                                     f"{first}")
        log(f"[tokens] {fmt or 'fp'}/kv={kvq}: {len(outputs)} arms "
            f"token-identical; request 0: {first[0]}")
    sampled = {}
    for run, eager in (("captured", False), ("captured again", False),
                       ("eager", True)):
        with _eager_loops() if eager else nullcontext():
            cb, reqs = _serve(cfg, params, prompts, device="cuda",
                              engine_mode="hetero-tensor", sync="device",
                              window=4, decode_width=4, new_tokens=12,
                              sampler=SamplerConfig(temperature=1.0,
                                                    top_k=8), seed=5)
            cb.run(reqs)
        sampled[run] = [r.output for r in reqs]
    if sampled["captured"] != sampled["captured again"]:
        raise AssertionError(f"[tokens] sampled windows differ between two "
                             f"captured runs from one seed: {sampled}")
    log(f"[tokens] sampled (temperature 1, top-k 8, seed 5): two captured "
        f"runs agree; equal to the eager run: "
        f"{sampled['captured'] == sampled['eager']}; request 0 captured "
        f"{sampled['captured'][0]}, eager {sampled['eager'][0]}")


ENGINE_MODES = ("xla", "mxu", "hetero-layer", "hetero-tensor")


def n_attention_layers(cfg) -> int:
    """Attention layers of a model: every layer of a transformer, one pass
    of the shared block per ``attn_every`` mamba layers of a hybrid, none
    in RWKV."""
    if cfg.rwkv is not None:
        return 0
    return cfg.n_layers // cfg.ssm.attn_every if cfg.ssm else cfg.n_layers


def attention_launches(chunks, n_layers: int, new_tokens: int) -> dict:
    """Launches of each attention kernel in one ``generate``: every
    attention layer of a chunk of more than one token runs the flash kernel,
    every attention layer of a 1-token chunk or a decode step the decode
    kernel."""
    multi = sum(1 for c, _ in chunks if c > 1)
    single = len(chunks) - multi + new_tokens - 1
    return {"flash_attention": multi * n_layers,
            "decode_attention": single * n_layers}


def ssd_launches(cfg, chunks) -> int:
    """Launches of the SSD chunk kernel in one ``generate``: every mamba
    layer of a prefill chunk of c tokens runs ceil(c / L) chunk steps, L =
    min(ssm.chunk, c); decode runs the plain one-step recurrence."""
    if cfg.ssm is None:
        return 0
    return cfg.n_layers * sum(-(-c // min(cfg.ssm.chunk, c))
                              for c, _ in chunks)


def engine_launches(eng, cfg, prompt_len: int, new_tokens: int) -> dict:
    """Every kernel's predicted launches in one ``eng.generate``."""
    chunks = eng._bucket_chunks(prompt_len)
    expect = attention_launches(chunks, n_attention_layers(cfg), new_tokens)
    expect["hetero_matmul"] = gemm_launches(eng.ctx, cfg, chunks)
    expect["ssd_chunk"] = ssd_launches(cfg, chunks)
    return expect


def gemm_launches(ctx, cfg, chunks) -> int:
    """Launches of the aligned-path GEMM in one ``generate``'s prefill:
    HeteroCtx sends a site to the kernel once unless its decision for the
    chunk's M is xla_only. A dense model runs the seven layer sites in
    every layer and the head once (M = 1: the last token); an MoE model
    runs its shared expert, where it has one, under the three FFN names,
    and its routed experts as plain batched products; a hybrid runs
    in_proj and out_proj in every mamba layer and the seven sites in every
    pass of the shared block, and takes its head as a plain matmul, as the
    reference does; RWKV ignores the HeteroCtx, as the reference does."""
    if ctx is None or ctx.mode == "xla" or cfg.rwkv is not None:
        return 0
    block = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    if cfg.moe is not None and not cfg.moe.d_ff_shared:
        block = block[:4]
    if cfg.ssm is not None:
        sites = [(s, cfg.n_layers) for s in ("in_proj", "out_proj")] + \
            [(s, n_attention_layers(cfg)) for s in block]
    else:
        sites = [(s, cfg.n_layers) for s in block] + [("head", 1)]
    n = 0
    for c, _ in chunks:
        for site, count in sites:
            M = 1 if site == "head" else c
            if ctx.mode == "mxu":
                hit = True
            elif ctx.mode == "hetero-layer":
                hit = M >= 128
            else:
                dec = ctx.plan.lookup(site, M)
                hit = M >= 128 if dec is None else dec.strategy != "xla_only"
            n += count * hit
    return n


def phase_engine_tokens(arch: str = "llama3-8b", prompt_len: int = 77,
                        new_tokens: int = 12, buckets=(32, 64),
                        modes=ENGINE_MODES) -> None:
    """fp32 smoke model of ``arch`` through InferenceEngine: for each
    prefill strategy, every engine mode x fast/host sync on the card takes
    two prompts of one length in turn (the first captures the decode graph,
    the second prefills into the same cache and replays it) and gives the
    tokens the engine gives on the CPU; so does the hetero-tensor arm of
    each sync with eager decode loops. On the second prompt each kernel
    (GEMM, flash, decode and, on the hybrid, SSD) launches exactly as often
    as the strategy's chunks and the plan predict, the eager arm's counts
    equal the captured arm's, and the engine holds one graph, replayed once
    per prompt (fast) or once per decoded token (host); ``modes`` are the
    engine modes of the captured arms. The strategies agree with one
    another, but for a recurrent model's pipe (its zero-padded tail moves
    the state, as in the reference) and for MoE (each strategy's chunks are
    its capacity groups)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import (PREFILL_STRATEGIES, InferenceEngine,
                                         build_plan)
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch).with_(param_dtype="float32",
                                       compute_dtype="float32")
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(7), device="cuda")
    cpu_params = _to_device(params, "cpu")
    prompts = [np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt_len)) for seed in (3, 5)]
    plans = {fast: build_plan(cfg, sync_mode="fast" if fast else "host")
             for fast in (True, False)}
    n_arms, outs = 0, {}
    for strategy in PREFILL_STRATEGIES:
        def engine(mode, fast, p, device):
            table, plan = plans[fast]
            return InferenceEngine(cfg, p, mode=mode, prefill_strategy=strategy,
                                   fast_sync=fast, table=table, plan=plan,
                                   buckets=buckets, device=device)
        cpu = engine("hetero-tensor", True, cpu_params, "cpu")
        want = [cpu.generate(p, new_tokens).tolist() for p in prompts]
        captured_counts = {}
        arms = [(m, f, False) for m in modes for f in (True, False)]
        arms += [("hetero-tensor", f, True) for f in (True, False)]
        for mode, fast, eager in arms:
            sync = "fast" if fast else "host"
            arm = f"{arch}/{strategy}/{mode}/{sync}" + ("/eager" if eager
                                                        else "")
            with _eager_loops() if eager else nullcontext():
                eng = engine(mode, fast, params, "cuda")
                got = [eng.generate(prompts[0], new_tokens).tolist()]
                _zero_counts()
                got.append(eng.generate(prompts[1], new_tokens).tolist())
            counts = _read_counts()
            graphs = eng.graph_stats()
            expect = engine_launches(eng, cfg, prompt_len, new_tokens)
            if got != want:
                raise AssertionError(f"[engine] {arm}: {got} vs the "
                                     f"CPU's {want}")
            for name, n in expect.items():
                if counts[name] != n:
                    raise AssertionError(f"[engine] {arm}: {counts[name]}"
                                         f" launches of {name}, expected "
                                         f"{n}")
            replays = 2 if fast else 2 * (new_tokens - 1)
            want_graphs = ((0, 0) if eager else (1, replays))
            if (graphs["graphs"], graphs["replays"]) != want_graphs:
                raise AssertionError(f"[engine] {arm}: graphs {graphs}, "
                                     f"expected (graphs, replays) "
                                     f"{want_graphs}")
            if mode == "hetero-tensor" and not eager:
                captured_counts[fast] = counts
            if eager and counts != captured_counts[fast]:
                raise AssertionError(f"[engine] {arm}: launches {counts} vs "
                                     f"the captured arm's "
                                     f"{captured_counts[fast]}")
            n_arms += 1
            log(f"[engine] {arm}: chunks {eng._bucket_chunks(prompt_len)}, "
                f"graphs {graphs}, launches {counts}")
            del eng
        outs[strategy] = want
        log(f"[engine] {arch}/{strategy}: {len(arms) - 2} captured and 2 "
            f"eager card arms equal the CPU's tokens {want[0][0]}, then "
            f"{want[1][0]}")
    recurrent = cfg.ssm is not None or cfg.rwkv is not None
    agree = {k: v for k, v in outs.items()
             if not (recurrent and k == "pipe")}
    if cfg.moe is None and len({str(o) for o in agree.values()}) != 1:
        raise AssertionError(f"[engine] {arch}: strategies differ: {outs}")
    log(f"[engine] {arch}: {n_arms} card arms token-identical to the CPU "
        "engine")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------------------------------------ phase 4 --

# (label, weight_quant, kv_quant) of the full-width pairs
FULL_PAIRS = (("fp", None, None), ("int8+kv8", "int8", "int8"),
              ("w4a16", "w4a16", None))


def full_model():
    """llama3-8b at full width, bf16, seeded random weights on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.models.transformer import init_params

    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    fence(params["embed"])
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    log(f"[full] {cfg.name}: {cfg.n_layers} layers, {cfg.n_params / 1e9:.2f} B "
        f"params, {n_bytes / 1e9:.2f} GB {cfg.param_dtype}, init "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def full_prompts(cfg, prompt_len: int = 300, n_requests: int = 4) -> list:
    """The full-width paged cells' seeded prompts (lengths 8 .. prompt_len)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size,
                         rng.integers(8, prompt_len)).astype(np.int32)
            for _ in range(n_requests)]


class RouteTape:
    """Routing pinned across two runs of an MoE model. ``record()`` keeps
    the expert ids that every ``models.moe.route`` call chooses, in call
    order; ``replay()`` gives each call the recorded ids (its gate values
    are the call's own probabilities at those ids, renormalised) and fails
    unless the calls' shapes match and the tape is used up; ``flips()``
    then counts the routed (token, layer) pairs whose own top-k set
    differed from the tape's: the near-ties the two runs break
    differently. In bf16 a
    rounding-level difference flips a near-tie in the router's top-k and
    the flip spreads through the layers (PERF.md §6, PR 22), so a gate that
    holds two numerics paths of an MoE model to each other pins the
    routing: it compares the arithmetic, not the routing's discontinuity.
    A captured decode loop runs no Python, so only eager calls (prefill,
    eager decode steps) are taped."""

    def __init__(self):
        self.ids, self._flips = [], []

    @contextmanager
    def _patched(self, pick):
        from repro_torch.models import moe
        inner = moe.route

        def route(router, xt, top_k):
            probs, gate_vals, gate_idx = inner(router, xt, top_k)
            return pick(probs, gate_vals, gate_idx)

        moe.route = route
        try:
            yield self
        finally:
            moe.route = inner

    @contextmanager
    def record(self):
        self.ids = []

        def keep(probs, gate_vals, gate_idx):
            self.ids.append(gate_idx.clone())
            return probs, gate_vals, gate_idx

        with self._patched(keep):
            yield self

    @contextmanager
    def replay(self):
        queue, self._flips = list(self.ids), []

        def give(probs, gate_vals, gate_idx):
            if not queue or queue[0].shape != gate_idx.shape:
                raise AssertionError(f"[route-tape] call of shape "
                                     f"{tuple(gate_idx.shape)} against the "
                                     f"tape's next {queue[:1]}")
            ids = queue.pop(0)
            own, taped = gate_idx.sort(-1).values, ids.sort(-1).values
            self._flips.append(((own != taped).any(-1).sum(),
                                own[..., 0].numel()))
            vals = probs.gather(-1, ids)
            return probs, vals / (vals.sum(-1, keepdim=True) + 1e-9), ids

        with self._patched(give):
            yield self
        if queue:
            raise AssertionError(f"[route-tape] {len(queue)} recorded calls "
                                 "left over")

    def flips(self) -> str:
        """The last replay's differing routes: total, of all routed
        (token, layer) pairs, and the most in one call."""
        got = [int(n) for n, _ in self._flips]
        total = sum(t for _, t in self._flips)
        return (f"{sum(got)} of {total} routed (token, layer) pairs chose "
                f"other experts than the tape's (at most {max(got, default=0)}"
                f" in one call of {len(got)})")


def _paged_arm(cfg, params, prompts, new_tokens: int, *, label: str, mode,
               weight_quant, kv_quant, profile: bool = False,
               table=None, pin=None) -> dict:
    """One full-width PagedBatcher (sync device, window 8, width 8; its
    plan solved from ``table`` where given): a first run over the prompts
    (which captures its decode graph), then a timed run and, with
    ``profile``, a profiled run, each over new requests for the same
    prompts. ``pin``, where given, is entered around the timed run (a
    ``RouteTape``'s record or replay); the first run's first-token logits
    are kept as ``free_first_logits``. Returns the timed run's numbers."""
    import torch
    from repro_torch.core.sync import fence

    t0 = time.perf_counter()
    cb, reqs = _serve(cfg, params, prompts, device="cuda", engine_mode=mode,
                      sync="device", window=8, decode_width=8,
                      new_tokens=new_tokens, weight_quant=weight_quant,
                      kv_quant=kv_quant, table=table)
    fence(params["embed"])
    setup = time.perf_counter() - t0
    timers, undo = _instrument(cb)
    t0 = time.perf_counter()
    cb.run(reqs)
    fence(params["embed"])
    first_run = time.perf_counter() - t0
    free_logits = timers["first_logits"]
    timers.update(prefill=0.0, decode=0.0, first_logits={})
    reqs = _requests(prompts, new_tokens)
    torch.cuda.reset_peak_memory_stats()
    fence(params["embed"])
    _zero_counts()
    t0 = time.perf_counter()
    with pin or nullcontext():
        cb.run(reqs)
    fence(params["embed"])
    wall = time.perf_counter() - t0
    counts = _read_counts()
    undo()
    cb.kv.assert_drained()
    tok = sum(len(r.output) for r in reqs)
    arm = {
        "label": label, "weight_quant": weight_quant, "kv_quant": kv_quant,
        "engine_mode": mode, "wall_s": wall, "setup_s": setup,
        "first_run_s": first_run, "new_tokens": new_tokens, "tokens": tok,
        "tok_per_s": tok / wall,
        "prefill_s": timers["prefill"], "decode_s": timers["decode"],
        "stats": cb.stats(), "launches": counts,
        "gemm_launches": counts[KERNEL_OF_FORMAT[weight_quant]],
        "outputs": [r.output for r in reqs],
        "first_logits": timers["first_logits"],
        "free_first_logits": free_logits,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pool_bytes": cb.kv.pool_bytes(), "graphs": _graph_info(cb),
    }
    if cb.ctx is not None:
        plan = cb.ctx.plan
        arm["strategies"] = dict(Counter(
            d.strategy for d in plan.decisions.values()))
        arm["decisions_m256"] = {
            s: f"{d.strategy}:{d.n_split}" for (s, m), d in
            plan.decisions.items() if m == 256}
    log(f"[full] {label} engine={mode}: {tok} tokens in {wall:.3f}s "
        f"({tok / wall:.1f} tok/s); prefill {timers['prefill']:.3f}s, "
        f"decode {timers['decode']:.3f}s; setup {setup:.1f}s, first run "
        f"{first_run:.3f}s; {cb.stats()}; graphs {arm['graphs']}; launches "
        f"{counts}; peak {arm['peak_mem_gb']:.2f} GB; pool "
        f"{arm['pool_bytes'] / 1e9:.3f} GB")
    if "strategies" in arm:
        log(f"[full] {label} plan strategies {arm['strategies']}; at "
            f"M=256 {arm['decisions_m256']}")
    for r in reqs:
        if len(r.output) != new_tokens:
            raise AssertionError(f"{label} request {r.rid}: "
                                 f"{len(r.output)} tokens")
    if profile:
        more = _requests(prompts, new_tokens)
        arm["profile"] = _profiled(label, lambda: cb.run(more),
                                   params["embed"])
    del cb, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return arm


def phase_full(cfg, params, tables: dict, prompt_len: int = 300,
               new_tokens: int = 16, n_requests: int = 4) -> dict:
    """llama3-8b at full width: for each of FULL_PAIRS, the hetero-tensor
    arm (the V5E plan), the engine-less arm and, phase C, the hetero-tensor
    arm on the plan of the format's measured table (``tables``, phase B) on
    the same seeded weights (quantized the same way at construction) and
    prompts, each through captured decode windows, the first also
    profiled; each hetero-tensor arm is held to the engine-less arm's
    first-token logits. Returns {label: V5E hetero arm, with the measured
    arm under "measured"}."""
    import torch

    prompts = full_prompts(cfg, prompt_len, n_requests)
    log(f"[full] prompt lengths {[len(p) for p in prompts]}, "
        f"{new_tokens} new tokens each")
    hetero, fp_logits = {}, None
    for label, wq, kvq in FULL_PAIRS:
        arms = {mode: _paged_arm(cfg, params, prompts, new_tokens,
                                 label=label, mode=mode, weight_quant=wq,
                                 kv_quant=kvq,
                                 profile=mode == "hetero-tensor")
                for mode in ("hetero-tensor", None)}
        het, base = arms["hetero-tensor"], arms[None]
        het["measured"] = _paged_arm(
            cfg, params, prompts, new_tokens, label=f"{label} measured",
            mode="hetero-tensor", weight_quant=wq, kv_quant=kvq,
            table=tables[(cfg.name, wq)])
        if het["gemm_launches"] <= 0:
            raise AssertionError(f"{label}: hetero-tensor arm never launched "
                                 f"{KERNEL_OF_FORMAT[wq]}")
        for arm in (het, het["measured"]):
            if sum(arm["launches"].values()) != arm["gemm_launches"] \
                    or sum(base["launches"].values()) != 0:
                raise AssertionError(f"{label}: launches outside the plan: "
                                     f"{arm['launches']}, "
                                     f"{base['launches']}")
        for rid, plan in ((r, p) for r in range(n_requests)
                          for p in ("V5E", "measured")):
            a = (het if plan == "V5E" else het["measured"])[
                "first_logits"][rid]
            b = base["first_logits"][rid]
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"{label} request {rid}: non-finite "
                                     "logits")
            cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
            msg = (f"[full] {label} request {rid} ({plan} plan): first-token"
                   f" logits cos {cos:.6f}, rel_err {rel_err(a, b):.3g}")
            if fp_logits is not None:      # quantized vs fp weights: quality
                msg += (", cos vs fp weights " + "%.6f" % float(
                    torch.nn.functional.cosine_similarity(
                        a, fp_logits[rid], dim=0)))
            log(msg)
            if cos < 0.99:
                raise AssertionError(f"{label} request {rid} ({plan} plan):"
                                     f" cosine {cos:.4f} < 0.99")
        same = sum(x == y for o1, o2 in zip(het["outputs"], base["outputs"])
                   for x, y in zip(o1, o2))
        total = sum(len(o) for o in het["outputs"])
        log(f"[full] {label} identical tokens hetero-tensor vs engine=None: "
            f"{same}/{total} ({same / total:.3f})")
        if wq is None:
            fp_logits = base["first_logits"]
        het["prompts"] = prompts
        het["plain_first_logits"] = base["first_logits"]
        het["plain_outputs"] = base["outputs"]
        hetero[label] = het
    return hetero


# the port's own kernels (csrc/*.cu), which _profiled lists by name even
# where they fall below the run's largest kernels
# ------------------------------------------------------------- phase H --

LSE_TOL = 1e-5   # the forward's fp32 row statistics against logsumexp


def _flash_bwd_bound(B, Sq, Sk, Hq, Hkv, D, el, causal) -> dict:
    """Bytes (q, k, v, o, dO, lse read once, dq, dk, dv written once) and
    the five products of the backward over the visible pairs."""
    pairs = (sum(min(i + Sk - Sq + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    nq, nk = B * Sq * Hq * D, B * Sk * Hkv * D
    nbytes = el * (4 * nq + 4 * nk) + 4 * B * Hq * Sq
    flops = 10 * B * Hq * D * pairs
    dname = {4: "float32", 2: "bfloat16"}[el]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def _flash_bwd_case(g, B, Sq, Sk, Hkv, G, D, dt, causal, *, label: str,
                    worst: dict, timing: bool = False) -> dict:
    """One backward check: the forward kernel's output and log-sum-exp
    (against ``lse_ref``), then the backward kernel against
    ``attention_bwd_ref`` on the same (q, k, v, o, lse, dO), within
    DTYPE_TOL (fp32 against the plain version carried in fp64); a second
    launch bitwise equal to the first. With ``timing``,
    the kernel's, the plain version's and SDPA's backward times and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         lse_ref)

    dname = str(dt).split(".")[-1]

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q, k, v = randn(B, Sq, Hkv * G, D), randn(B, Sk, Hkv, D), randn(B, Sk,
                                                                     Hkv, D)
    do = randn(B, Sq, Hkv * G, D)
    lse = torch.empty((B, Hkv * G, Sq), dtype=torch.float32, device="cuda")
    o = ops._launch(q, k, v, causal, lse)
    # fp32 is held to the plain version carried in fp64: at the path's
    # depth (8,192 packed rows a key) two fp32 orders of summation differ by
    # more than fp32's DTYPE_TOL, the plain version's own order included
    wide = (lambda t: t.double()) if dt == torch.float32 else (  # noqa: E731
        lambda t: t)
    e_lse = rel_err(lse, lse_ref(wide(q), wide(k), causal=causal))
    if not e_lse <= LSE_TOL:
        raise AssertionError(f"[train] {label} {dname}: lse rel_err "
                             f"{e_lse:.3g} > {LSE_TOL}")
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    if ops.flash_attention_bwd.launches != before + 2:
        raise AssertionError(f"[train] {label}: the backward never launched")
    want = attention_bwd_ref(*(wide(t) for t in (q, k, v, o, lse, do)),
                             causal=causal)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    key = ("flash_attention_bwd", dname)
    worst[key] = max(worst.get(key, 0.0), *errs)
    if not max(errs) <= DTYPE_TOL[dname]:
        raise AssertionError(f"[train] {label} {dname}: dq / dk / dv rel_err "
                             f"{errs} > {DTYPE_TOL[dname]}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"[train] {label} {dname}: two launches differ")
    row = {"case": label, "shape": [B, Sq, Sk, Hkv * G, Hkv, D],
           "dtype": dname, "causal": causal, "rel_err": errs,
           "lse_rel_err": e_lse,
           "max_abs_err": max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(got, want))}
    if dt == torch.float32 and Sq >= 1024:
        # the fp32 plain version's own distance from fp64, for scale
        plain = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        row["plain_fp32_rel_err"] = [rel_err(a, b)
                                     for a, b in zip(plain, want)]
        del plain
    if not timing:
        del want
        return row
    del want, got, again
    torch.cuda.empty_cache()
    run = lambda: ops.flash_attention_bwd(                      # noqa: E731
        q, k, v, o, lse, do, causal=causal)
    # CUDA events only: late in the whole script torch.profiler's short
    # traces here lost device events (0.0 ms for a 4.4 ms kernel); the
    # kernel's device time comes from H2's profiled training step instead
    row["ms"] = cuda_time_ms(run, iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal), iters=2, warmup=1)
    torch.cuda.empty_cache()
    # SDPA's backward through autograd: the graph made once, then only its
    # backward timed (retain_graph)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask_kw = {"is_causal": causal and Sq == Sk}
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **mask_kw)
        row["library_note"] = ("scaled_dot_product_attention(enable_gqa=True"
                               f", is_causal={mask_kw['is_causal']}) "
                               "backward")
    except TypeError:       # a PyTorch without enable_gqa: kv heads repeated
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
        out = F.scaled_dot_product_attention(qt, kr, vr, **mask_kw)
        row["library_note"] = "scaled_dot_product_attention backward, kv " \
                              "repeated"
    dot = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(                          # noqa: E731
        out, (qt, kt, vt), dot, retain_graph=True)
    row["library_ms"] = cuda_time_ms(lib, iters=10)
    del out
    row.update(_flash_bwd_bound(B, Sq, Sk, Hkv * G, Hkv, D,
                                q.element_size(), causal))
    return row


def phase_flash_bwd() -> dict:
    """H0: the flash-attention backward kernel against its plain version
    (``attention_bwd_ref``) on the card, fp32, bf16 and fp16: the
    attention conformance grid (1 / 2 / 4 query heads per kv head, causal
    and not, Sq == Sk and Sq < Sk, D = 16, 97 -> 97 and 128), hubert's smoke
    shape with its full head dim 80 (bidirectional), then the training
    path's shape at qwen3-1.7b ([2, 4096, 16 / 8, 128], causal) in fp32 and
    bf16, the bf16 one timed against the plain version and SDPA's backward.
    Every case also holds the forward's log-sum-exp to ``lse_ref`` and two
    backward launches to each other, bitwise."""
    import torch
    from repro_torch.configs import dtype_of

    g = torch.Generator(device="cuda").manual_seed(23)
    worst, n = {}, 0
    for name, M, K, _ in CONFORMANCE_CASES + (("smoke_d16", 77, 16, 0),):
        D = min(K, 128)
        for G in (1, 2, 4):
            for dname in DTYPE_TOL:
                for Sk in (M, M + 37):
                    for causal in (True, False):
                        _flash_bwd_case(g, 2, M, Sk, 2, G, D,
                                        dtype_of(dname), causal,
                                        label=f"{name} G={G} Sk={Sk}",
                                        worst=worst)
                        n += 1
    for dname in DTYPE_TOL:
        _flash_bwd_case(g, 2, 40, 40, 4, 1, 80, dtype_of(dname), False,
                        label="hubert smoke D=80", worst=worst)
        n += 1
    path = {}
    for dname in ("float32", "bfloat16"):
        path[dname] = _flash_bwd_case(
            g, 2, 4096, 4096, 8, 2, 128, dtype_of(dname), True,
            label="path qwen3-1.7b", worst=worst, timing=dname == "bfloat16")
        torch.cuda.empty_cache()
        n += 1
    for (kname, dname), e in sorted(worst.items()):
        log(f"[train] H0 {kname} {dname:8s}: worst rel_err {e:.3g} <= "
            f"{DTYPE_TOL[dname]}")
    log(f"[train] H0 {n} backward checks passed (lse within {LSE_TOL}, two "
        "launches bitwise equal)")
    for row in path.values():
        log(f"[train] H0 path {json.dumps(row)}")
    return {"path": path["bfloat16"], "path_fp32": path["float32"],
            "worst": worst}


TRAIN_SMOKE = ("smollm-135m", "qwen3-1.7b", "qwen2-moe-a2.7b",
               "chameleon-34b", "hubert-xlarge")
TRAIN_LOSS_TOL = 1e-5   # relative: the same fp32 loss, card against CPU
TRAIN_GRAD_TOL = 1e-4   # rel_err per leaf: fp32 sums in other orders


def _train_batch(cfg, B: int, S: int, seed: int = 0) -> tuple:
    """Seeded (inputs, targets): token ids, or float frames for an
    encoder-only config (the audio stub)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    inputs = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
              if cfg.encoder_only else toks[:, :-1])
    return inputs, toks[:, 1:]


def _flash_counts() -> dict:
    counts = _read_counts()
    return {k: counts[k] for k in ("flash_attention", "flash_attention_bwd")}


def phase_train_smoke(device: str = "cuda") -> dict:
    """H1: the fp32 smoke models of the five transformer configs on the
    card against the port on the CPU: loss (1e-5 relative) and every
    leaf's gradient (rel_err 1e-4), the card's attention through the flash
    kernel's forward (twice a layer: the pass and remat's recompute) and
    its backward (once a layer). Then ``train()`` of the smollm smoke model
    on the card, 9 steps with save_every=5, crashed before step 8 (at step
    index 7): the run restores step 5 and ends at the uninterrupted run's
    losses. On the card the embedding's backward (an index_put with
    accumulate) adds with atomics, so two runs need not agree bitwise: the
    losses are held within TRAIN_LOSS_TOL."""
    import shutil
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.sync import fence
    from repro_torch.models import build_model
    from repro_torch.serving.telemetry import FakeClock
    from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                                 train)

    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {}
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch).with_(**fp32)
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(3), device="cpu")
        card = _to_device(cpu, device)
        inputs, targets = _train_batch(cfg, 2, 40)
        want = loss_and_grads(model, cpu, torch.from_numpy(inputs),
                              torch.from_numpy(targets))
        _zero_counts()
        got = loss_and_grads(model, card,
                             torch.from_numpy(inputs).to(device),
                             torch.from_numpy(targets).to(device))
        fence(got[0])
        counts = _flash_counts()
        expect = {"flash_attention": 2 * cfg.n_layers,
                  "flash_attention_bwd": cfg.n_layers}
        if counts != expect:
            raise AssertionError(f"[train] H1 {arch}: launches {counts}, "
                                 f"expected {expect}")
        e_loss = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        e_aux = abs(float(got[1]["aux"]) - float(want[1]["aux"]))
        e_grad = max(rel_err(a.cpu(), b) for a, b in
                     zip(_leaves(got[2]), _leaves(want[2])) if b.any())
        if not (e_loss <= TRAIN_LOSS_TOL and e_aux <= TRAIN_LOSS_TOL
                * max(abs(float(want[1]["aux"])), 1.0)
                and e_grad <= TRAIN_GRAD_TOL):
            raise AssertionError(f"[train] H1 {arch}: loss {e_loss:.3g}, aux "
                                 f"{e_aux:.3g}, grads {e_grad:.3g}")
        out[arch] = {"loss_rel_err": e_loss, "aux_abs_err": e_aux,
                     "grad_rel_err": e_grad, "launches": counts}
        log(f"[train] H1 {arch}: loss card {float(got[0]):.6f} cpu "
            f"{float(want[0]):.6f} (rel {e_loss:.2e}), aux "
            f"{float(got[1]['aux']):.6f}, worst grad rel_err {e_grad:.2e}, "
            f"launches {counts}")

    cfg = get_smoke_config("smollm-135m").with_(**fp32)
    shape = ShapeSpec("h1", 32, 4, "train")
    ckpt = ROOT / "build" / "train_ckpt"
    crashed = []

    def injector(step):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    runs = {}
    for label, inject in (("plain", None), ("crashed", injector)):
        shutil.rmtree(ckpt / label, ignore_errors=True)
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), device=device)
        _, losses, _ = train(
            cfg, TrainConfig(steps=9, log_every=1, save_every=5,
                             ckpt_dir=str(ckpt / label)), shape,
            device=device, params=params, clock=FakeClock(),
            fail_injector=inject, log=lambda *a: None)
        runs[label] = dict(losses)
    shutil.rmtree(ckpt, ignore_errors=True)
    diffs = [abs(runs["crashed"][k] - v) / abs(v)
             for k, v in runs["plain"].items()]
    if crashed != [7] or sorted(runs["crashed"]) != list(range(1, 10)) \
            or max(diffs) > TRAIN_LOSS_TOL:
        raise AssertionError(f"[train] H1 crash-restart: {runs}")
    log(f"[train] H1 crash at step 7, restored step 5: losses "
        f"{[round(v, 6) for v in runs['crashed'].values()]} against "
        f"{[round(v, 6) for v in runs['plain'].values()]} (worst relative "
        f"{max(diffs):.2e}, bitwise equal: "
        f"{runs['crashed'] == runs['plain']})")
    out["crash"] = {"worst": max(diffs),
                    "bitwise": runs["crashed"] == runs["plain"]}
    return out


@contextmanager
def _plain_attention():
    """``models.layers``' flash attention swapped for its plain version
    (``attention_ref``), whose gradient is torch's autograd."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers
    saved = layers.flash_attention
    layers.flash_attention = attention_ref
    try:
        yield
    finally:
        layers.flash_attention = saved


def _matmul_params(params) -> int:
    """Parameters of the products (layer matrices and an untied head; not
    the embedding gather or the norms)."""
    n = sum(t.numel() for t in _leaves(params["layers"]) if t.ndim >= 3)
    return n + (params["head"].numel() if "head" in params else 0)


def phase_train_full(seq: int = 4096, batch: int = 2, steps: int = 4,
                     device: str = "cuda") -> dict:
    """H2: qwen3-1.7b at full width (28 layers, d_model 2048, 16 / 8 heads
    of 128, d_ff 6144, vocab 151936, untied, qk-norm; bf16, seeded random
    weights, fp32 AdamW moments), per-layer remat, seq 4096 x batch 2 of
    SyntheticLM tokens. Parity first: step 1's loss and every leaf's
    gradient through the flash kernels against the same with plain
    attention under autograd on the card (loss within 1e-3 relative, each
    gradient at cosine >= 0.999). Then 1 warm-up and ``steps`` timed steps
    of ``make_train_step`` (each fenced), the flash kernels' launches
    counted from 0 over the timed steps, peak memory over them, and one
    more step under torch.profiler for the busy share. No checkpoint is
    written at this width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import tree_flatten

    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    n_mm = _matmul_params(params)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    first = data.next()
    inputs = torch.from_numpy(first["inputs"]).to(device)
    targets = torch.from_numpy(first["targets"]).to(device)

    loss_k, _, grads_k = loss_and_grads(model, params, inputs, targets)
    with _plain_attention():
        loss_p, _, grads_p = loss_and_grads(model, params, inputs, targets)
    e_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    cos = {"/".join(path): float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for (path, a), (_, b) in zip(tree_flatten(grads_k),
                                     tree_flatten(grads_p))}
    worst = min(cos, key=cos.get)
    log(f"[train] H2 parity: step-1 loss kernels {float(loss_k):.6f}, plain "
        f"attention {float(loss_p):.6f} (rel {e_loss:.2e}); gradient cosine "
        f"worst {cos[worst]:.6f} ({worst}), mean "
        f"{sum(cos.values()) / len(cos):.6f} over {len(cos)} leaves")
    if not (e_loss <= 1e-3 and cos[worst] >= 0.999):
        raise AssertionError(f"[train] H2 parity: loss {e_loss:.3g}, "
                             f"cosine {cos[worst]:.6f} ({worst})")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    _, step_fn = make_train_step(cfg, TrainConfig(), device=device)
    state = opt.init_state(params)
    state, metrics = step_fn(state, first)          # warm-up step
    fence(state["step"])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses = [], []
    for _ in range(steps):
        batch_np = data.next()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_np)
        fence(state["step"])
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {"flash_attention": 2 * cfg.n_layers * steps,
              "flash_attention_bwd": cfg.n_layers * steps}
    if counts != expect:
        raise AssertionError(f"[train] H2 launches {counts}, expected "
                             f"{expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] H2 losses {losses}")
    nxt = data.next()
    prof = _profiled("train-step", lambda: step_fn(state, nxt),
                     state["step"])
    step_s = sum(times) / len(times)
    tokens = seq * batch
    pairs = seq * (seq + 1) // 2
    attn_flops = 12 * cfg.n_layers * batch * cfg.n_heads * cfg.head_dim \
        * pairs
    model_flops = 6 * n_mm * tokens + attn_flops
    def per_call_ms(names, calls):
        us = sum(r[0] for r in prof["rows"] if any(n in r[2] for n in names))
        return us / 1e3 / calls

    row = {"arch": cfg.name, "seq": seq, "batch": batch,
           "params": n_params, "matmul_params": n_mm,
           "step_s": times, "mean_step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "model_flops": model_flops,
           "model_flop_share": model_flops / step_s / PEAK_FLOPS["bfloat16"],
           "remat_flops": 8 * n_mm * tokens + 16 * attn_flops // 12,
           "peak_gb": peak / 1e9, "busy_share": prof["share"],
           "profiled_wall_s": prof["wall_s"], "losses": losses,
           "launches": counts, "parity_loss_rel": e_loss,
           "parity_worst_cos": cos[worst],
           # device time a call in the profiled step: the backward's three
           # kernels, and the forward's (twice a layer)
           "bwd_step_device_ms": per_call_ms(("flash_bwd",), cfg.n_layers),
           "fwd_step_device_ms": per_call_ms(("flash_tc",),
                                             2 * cfg.n_layers)}
    log(f"[train] H2 {cfg.name} seq {seq} x batch {batch}: step "
        f"{step_s:.4f}s ({', '.join(f'{t:.4f}' for t in times)}), "
        f"{row['tokens_per_s']:.0f} tok/s, model-FLOP share "
        f"{row['model_flop_share']:.4f} of 989 TFLOP/s, peak "
        f"{row['peak_gb']:.2f} GB, busy {prof['share']}, losses {losses}")
    log(f"[train] H2 {json.dumps(row)}")
    del state, params, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_training() -> dict:
    """Phase H: training through the flash kernel's backward. H0 the
    backward kernel, H1 the fp32 smoke models and a crash-restart on the
    card, H2 qwen3-1.7b at full width."""
    out = {}
    for key, phase in (("H0", phase_flash_bwd), ("H1", phase_train_smoke),
                       ("H2", phase_train_full)):
        t0 = time.perf_counter()
        out[key] = phase()
        log(f"[time] phase H {key}: {time.perf_counter() - t0:.1f}s")
    return out


PORT_KERNELS = ("gemm_tc", "splitk_reduce", "mm_output_stationary",
                "mm_weight_stationary", "quant_mm", "flash_tc", "flash_fwd",
                "flash_bwd", "decode_split", "decode_combine", "ssd_cb_tc",
                "ssd_chunk_tc")


def _profiled(label: str, run, anchor) -> dict:
    """``run()`` under torch.profiler, tracing the card only (a trace of
    every host-side operator of an eager run slows the run it measures and
    is slow to read back): device time by kernel (the 12 largest,
    then every other kernel of the port) and the device's busy share of the
    run's wall time. Returns {"wall_s", "busy_s", "share"} (busy None where
    the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sync import fence

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        fence(anchor)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():       # device-side events: kernels, copies
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log(f"[profile] {label}: torch.profiler saw no device time")
        return {"wall_s": wall, "busy_s": None, "share": None, "rows": []}
    log(f"[profile] {label} run: wall {wall:.3f}s (profiled), "
        f"device busy {busy:.3f}s ({busy / wall:.3f} of wall)")
    for us, n, key in rows[:12]:
        log(f"[profile] {label} {us / 1e3:10.2f} ms {n:7d}x  {key[:90]}")
    for us, n, key in rows[12:]:
        if any(name in key for name in PORT_KERNELS):
            log(f"[profile] {label} {us / 1e3:10.2f} ms {n:7d}x  {key[:90]} "
                "(a port kernel)")
    return {"wall_s": wall, "busy_s": busy, "share": busy / wall,
            "rows": rows}


ENGINE_ARMS = (("hetero-tensor", True), ("xla", True), ("hetero-tensor", False))


def _strict_decode(engine_module):
    """Wrap the engine's ``generate_on_device`` (on the card: copying the
    inputs into the captured loop's buffers and replaying it) so that it
    runs with CUDA's sync debug mode set to error: any host sync inside the
    fast-sync decode loop raises. Returns the function that undoes the
    wrap."""
    import torch
    inner = engine_module.generate_on_device

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine_module.generate_on_device = strict
    return lambda: setattr(engine_module, "generate_on_device", inner)


# Kernel-vs-plain gates on the full-width engine's logits (bf16): the same
# arm with a path's kernels and with their plain versions must agree to
# this cosine and relative error (PERF.md §2 gives the measured margins).
ATTENTION_GATE_COS, ATTENTION_GATE_REL = 0.999, 0.05


def gate_bounds(name: str) -> tuple[float, float]:
    """(least cosine, largest rel_err) of a gate's output ``name``. The
    logits take the bounds above; ssd_gate's probes of the first mamba
    layer ("scan", "state") are fp32 and read the same inputs on both
    sides, so there the kernel is held to its own contract, SSD_TOL."""
    if name in ("scan", "state"):
        return ATTENTION_GATE_COS, SSD_TOL
    return ATTENTION_GATE_COS, ATTENTION_GATE_REL


def _step_logits(eng, prompt) -> list:
    """[first-token logits, first decode step's logits] of ``prompt``
    through ``eng``, in fp32: the last prefill chunk's last-position logits
    of ``eng.generate(prompt, 1)``, then the decode step that comes next,
    run eagerly on the same cache (a captured loop replays the same
    launches, and no graph is captured here)."""
    import torch

    seen, prefill = {}, eng._prefill

    def keep(*a, **k):
        seen["logits"], seen["cache"] = prefill(*a, **k)
        return seen["logits"], seen["cache"]

    eng._prefill = keep
    try:
        eng.generate(prompt, 1)
    finally:
        eng._prefill = prefill
    first = torch.argmax(seen["logits"][:, -1, :], dim=-1)[:, None]
    logits, _ = eng.model.decode_step(eng.params, first, seen["cache"])
    return [seen["logits"][0, -1].float(), logits[0, -1].float()]


def _kernel_gate(label, cfg, params, prompt, module, plain: dict, predict,
                 check: bool, probe=None) -> dict:
    """Arm 1 (hetero-tensor, fast sync, hetero strategy) on the card twice:
    through the kernels, then with ``module``'s names in ``plain`` swapped
    for the plain versions given there, on the same weights and prompt.
    ``predict(chunks)`` gives each kernel's launches on the kernel side (the
    plain side launches none). ``probe(run)``, where given, runs ``run()``
    and returns (its result, {name: one more tensor to compare}). Returns
    {"first" | "decode" | probe's names: {cos, rel_err, max_abs}} and
    raises, when ``check``, if any pair disagrees beyond the gate or a
    kernel launched where it should not have. An MoE model's plain run
    replays the kernel run's routing (``RouteTape``)."""
    import torch
    from repro_torch.core.engine import InferenceEngine

    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy="hetero")
    launches = predict(eng._bucket_chunks(prompt.shape[1]))

    def run() -> dict:
        if probe is None:
            return dict(zip(("first", "decode"), _step_logits(eng, prompt)))
        logits, extra = probe(lambda: _step_logits(eng, prompt))
        return {**dict(zip(("first", "decode"), logits)), **extra}

    tape = RouteTape()                  # an MoE model's routing pinned
    moe = cfg.moe is not None
    _zero_counts()
    with tape.record() if moe else nullcontext():
        kernel = run()
    k_counts = _read_counts()
    _zero_counts()                      # before the swap: the counters
    saved = {name: getattr(module, name) for name in plain}   # may be swapped
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        with tape.replay() if moe else nullcontext():
            ref = run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    p_counts = _read_counts()
    if moe:
        log(f"[{label}] {cfg.name} plain run pinned to the kernel run's "
            f"routing: {tape.flips()}")
    got = ({k: k_counts[k] for k in launches},
           {k: p_counts[k] for k in launches})
    if check and got != (launches, {k: 0 for k in launches}):
        raise AssertionError(f"[{label}] launches (kernels, plain) {got}, "
                             f"expected {launches} and none")
    out = {}
    for name in kernel:
        a, b = kernel[name].reshape(-1), ref[name].reshape(-1)
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        out[name] = {"cos": cos, "rel_err": rel_err(a, b),
                     "max_abs": float((a - b).abs().max())}
        log(f"[{label}] {cfg.name} kernels vs plain, {name}: cos "
            f"{cos:.6f}, rel_err {out[name]['rel_err']:.4g}, max |diff| "
            f"{out[name]['max_abs']:.4g}")
        least_cos, most_rel = gate_bounds(name)
        if check and (not torch.isfinite(a).all() or cos < least_cos
                      or out[name]["rel_err"] > most_rel):
            raise AssertionError(f"[{label}] {cfg.name} kernels vs plain on "
                                 f"the {name} output: {out[name]}, gate cos "
                                 f">= {least_cos}, rel_err <= {most_rel}")
    return out


def attention_gate(cfg, params, prompt, plain=None, *, check: bool = True
                   ) -> dict:
    """``_kernel_gate`` of the attention kernels: ``models.layers``' two
    attention calls swapped for ``plain`` (flash, decode; the plain versions
    unless given). This runs the kernels on the path's own operands:
    strided per-layer cache views, the model's head dim and the device
    length ``index + 1``."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers

    flash, decode = plain or (attention_ref, decode_attention_ref)
    return _kernel_gate(
        "attention-gate", cfg, params, prompt, layers,
        {"flash_attention": flash, "decode_attention": decode},
        lambda chunks: attention_launches(chunks, n_attention_layers(cfg), 2),
        check)


def ssd_gate(cfg, params, prompt, plain=None, *, check: bool = True) -> dict:
    """``_kernel_gate`` of the SSD chunk kernel: the scan's ``ssd_chunk``
    swapped for ``plain`` (``ssd_chunk_ref`` unless given). This runs the
    kernel on the path's operands: B_ and C_ strided out of the conv
    output, the state passed between the launches of a chunk, between
    prefill chunks, and on into decode (whose logits read it). The logits
    see little of a chunk's incoming state: at the reference's A (-1 to
    -16 per step of dt) it decays within a few steps. So the gate also holds
    the first mamba layer (whose inputs are the same on both sides): "scan",
    its SSD output at every prompt position, whose rows next to a chunk
    boundary read the carried state, and "state", its SSM state after the
    prefill, both within SSD_TOL (``gate_bounds``): a kernel that keeps
    less than fp32 accuracy, as one pass of TF32 would, fails there."""
    import torch
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref
    from repro_torch.models import mamba2

    def first_layer(run):
        inner, seen = mamba2.scan_chunks, []

        def record(*a):
            y, state = inner(*a)
            # layer 0 of each prefill chunk
            seen.append((y, state) if len(seen) % cfg.n_layers == 0 else None)
            return y, state

        mamba2.scan_chunks = record
        try:
            logits = run()
        finally:
            mamba2.scan_chunks = inner
        mine = [r for r in seen if r is not None]
        return logits, {"scan": torch.cat([y for y, _ in mine], dim=1),
                        "state": mine[-1][1]}

    return _kernel_gate(
        "ssd-gate", cfg, params, prompt, ops,
        {"ssd_chunk": plain or ssd_chunk_ref},
        lambda chunks: {"ssd_chunk": ssd_launches(cfg, chunks)}, check,
        first_layer)


def _engine_arm(cfg, params, prompt, new_tokens: int, *, mode: str,
                fast: bool, label: str, strict: bool = False,
                profile: bool = False, table=None, pin=None) -> dict:
    """One full-width InferenceEngine (hetero strategy): a first generate
    (which meets the chunk lengths and captures the decode graph; its
    tokens are kept as ``first_tokens``), then a timed one on the reused
    cache, every kernel launching as predicted, decoding under CUDA's
    sync debug mode set to error where ``strict``, and, with ``profile``, a
    profiled one. ``pin``, where given, is entered around the timed
    generate (a ``RouteTape``'s record or replay); the first generate's
    first-token logits are kept as ``free_logits``. Returns the timed
    generate's numbers."""
    import torch
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.engine import EngineStats, InferenceEngine
    from repro_torch.core.sync import fence

    eng = InferenceEngine(cfg, params, mode=mode, prefill_strategy="hetero",
                          fast_sync=fast, table=table)
    prefill, first = eng._prefill, {}

    def keep_logits(*a, **k):
        logits, cache = prefill(*a, **k)
        first["logits"] = logits[0, -1].float()
        return logits, cache

    eng._prefill = keep_logits
    first_tokens = eng.generate(prompt, new_tokens)[0].tolist()
    free_logits = first["logits"]
    warm = eng.stats
    eng.stats = EngineStats()
    fence(params["embed"])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    undo = _strict_decode(engine_mod) if strict else (lambda: None)
    try:
        with pin or nullcontext():
            out = eng.generate(prompt, new_tokens)
    finally:
        undo()
    counts = _read_counts()
    st = eng.stats
    chunks = eng._bucket_chunks(prompt.shape[1])
    expect = engine_launches(eng, cfg, prompt.shape[1], new_tokens)
    for name, n in expect.items():
        if counts[name] != n:
            raise AssertionError(f"[engine-full] {cfg.name} {label}: "
                                 f"{counts[name]} launches of {name}, "
                                 f"expected {n}")
    logits = first["logits"]
    if out.shape != (1, new_tokens) or not torch.isfinite(logits).all():
        raise AssertionError(f"[engine-full] {cfg.name} {label}: output "
                             f"{tuple(out.shape)} or non-finite logits")
    arm = {"mode": mode, "fast_sync": fast, "chunks": chunks,
           "prefill_s": st.prefill_s, "decode_s": st.decode_s,
           "tok_per_s": new_tokens / (st.prefill_s + st.decode_s),
           **st.tokens_per_s(),
           "first_call_compile_s": warm.compile_s,
           "n_compiles": warm.n_compiles, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graphs": _graph_info(eng), "prompt": prompt,
           "tokens": out[0].tolist(), "first_tokens": first_tokens,
           "logits": logits, "free_logits": free_logits}
    if pin is not None:            # the first generate's routing was free
        arm["free_tokens"] = first_tokens
    log(f"[engine-full] {cfg.name} {label}: chunks {chunks}; prefill "
        f"{st.prefill_s:.3f}s, decode {st.decode_s:.3f}s "
        f"({arm['decode_tok_s']:.1f} decode tok/s, {arm['tok_per_s']:.2f}"
        f" tok/s end to end); first call {warm.compile_s:.2f}s over "
        f"{warm.n_compiles} compiles (chunk lengths and captures); graphs "
        f"{arm['graphs']}; launches {counts}; peak "
        f"{arm['peak_mem_gb']:.2f} GB")
    if profile:
        arm["profile"] = _profiled(f"engine {cfg.name} {label}",
                                   lambda: eng.generate(prompt, new_tokens),
                                   params["embed"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return arm


def phase_engine_full(cfg, params, table, prompt_len: int = 300,
                      new_tokens: int = 16, arms=ENGINE_ARMS, seed: int = 4,
                      gates=(attention_gate,)) -> dict:
    """The single-request engine at full width: one seeded prompt, hetero
    strategy, each of ``arms`` (mode, fast sync) through ``_engine_arm``
    (captured decode loops), then, where ``table`` is given, phase C's
    hetero-tensor / fast arm on the plan of that measured table; the
    hetero-tensor fast arm decodes its timed run under the sync debug mode
    and is profiled. Every arm is held to the xla arm's first-token logits
    (an MoE model's arms with the xla arm's routing, ``RouteTape``; their
    logits with free routing are logged beside).
    Then each of ``gates`` holds the first arm's kernels against their
    plain versions. Returns {arm: result}."""
    import numpy as np
    import torch
    from repro_torch.core.sync import measure_dispatch_overhead

    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (1, prompt_len))
    results, tape, pins = {}, RouteTape(), {}
    if cfg.moe is not None:        # every arm routes as the xla arm does
        arms = sorted(arms, key=lambda a: a != ("xla", True))
        pins = {a: tape.replay() for a in arms[1:]}
        pins[arms[0]] = tape.record()
    for mode, fast in arms:
        label = f"{mode}/{'fast' if fast else 'host'}"
        results[label] = _engine_arm(
            cfg, params, prompt, new_tokens, mode=mode, fast=fast,
            label=label, strict=label == "hetero-tensor/fast",
            profile=label == "hetero-tensor/fast", pin=pins.get((mode, fast)))
    if pins:
        log(f"[engine-full] {cfg.name} routing of the last arm pinned to "
            f"xla/fast: {tape.flips()}")
    if table is not None:
        results["hetero-tensor/fast measured"] = _engine_arm(
            cfg, params, prompt, new_tokens, mode="hetero-tensor", fast=True,
            label="hetero-tensor/fast measured", table=table)
    base = results["xla/fast"]
    log(f"[engine-full] {cfg.name} hetero-tensor/fast decode loop replayed "
        "with sync debug mode 'error': no host sync inside it")
    for label, arm in results.items():
        if pins:
            free = float(torch.nn.functional.cosine_similarity(
                arm["free_logits"], base["free_logits"], dim=0))
            arm["free_cos_vs_xla"] = free
            log(f"[engine-full] {cfg.name} {label}: first-token logits cos "
                f"vs xla/fast with free routing {free:.6f}")
        cos = float(torch.nn.functional.cosine_similarity(
            arm["logits"], base["logits"], dim=0))
        same = sum(a == b for a, b in zip(arm["tokens"], base["tokens"]))
        arm["cos_vs_xla"] = cos
        log(f"[engine-full] {cfg.name} {label}: first-token logits cos vs "
            f"xla/fast {cos:.6f}, rel_err "
            f"{rel_err(arm['logits'], base['logits']):.3g}; tokens equal to "
            f"xla/fast {same}/{new_tokens}")
        if cos < 0.99:
            raise AssertionError(f"[engine-full] {cfg.name} {label}: cosine "
                                 f"{cos:.4f} < 0.99")
    for gate in gates:
        results["hetero-tensor/fast"][gate.__name__] = gate(cfg, params,
                                                            prompt)
    if "hetero-tensor/host" in results:
        fast, host = results["hetero-tensor/fast"], \
            results["hetero-tensor/host"]
        log(f"[engine-full] decode host/fast "
            f"{host['decode_s'] / fast['decode_s']:.3f}; dispatch overhead "
            f"{measure_dispatch_overhead():.1f} us (median launch + sync)")
    return results


def _pair_line(cell: str, cap: dict, eager: dict) -> dict:
    """One cell's captured arm against its eager arm: logged as one line,
    raising unless both launched every kernel equally often and gave the
    same tokens (a pinned captured arm's free-routing tokens, from its
    first generate)."""
    def side(arm):
        prof = arm.get("profile") or {}
        return {"tok_per_s": arm["tok_per_s"], "decode_s": arm["decode_s"],
                "prefill_s": arm["prefill_s"], "busy_share": prof.get("share"),
                "profiled_wall_s": prof.get("wall_s")}

    row = {"cell": cell, "captured": side(cap), "eager": side(eager),
           "graphs": cap["graphs"], "eager_graphs": eager["graphs"]["graphs"],
           "launches": cap["launches"]}
    c, e = row["captured"], row["eager"]
    log(f"[graph-decode] {cell}: captured {c['tok_per_s']:.2f} tok/s, decode "
        f"{c['decode_s']:.3f}s, prefill {c['prefill_s']:.3f}s, busy "
        f"{c['busy_share']}; eager {e['tok_per_s']:.2f} tok/s, decode "
        f"{e['decode_s']:.3f}s, prefill {e['prefill_s']:.3f}s, busy "
        f"{e['busy_share']}; {cap['graphs']['graphs']} graph(s) captured in "
        f"{cap['graphs']['capture_s']:.3f}s, pool "
        f"{cap['graphs']['pool_bytes']} bytes, {cap['graphs']['replays']} "
        f"replays; launches {cap['launches']}")
    if cap["launches"] != eager["launches"] or eager["graphs"]["graphs"]:
        raise AssertionError(f"[graph-decode] {cell}: launches captured "
                             f"{cap['launches']}, eager {eager['launches']}"
                             f" (eager graphs {eager['graphs']})")
    toks = ("outputs", "outputs") if "outputs" in cap else (
        "free_tokens" if "free_tokens" in cap else "tokens", "tokens")
    if cap[toks[0]] != eager[toks[1]]:
        raise AssertionError(f"[graph-decode] {cell}: tokens differ, "
                             f"captured {cap[toks[0]]}, eager "
                             f"{eager[toks[1]]}")
    return row


def phase_graph_decode(cfg, params, paged, engine) -> dict:
    """Each cell's captured arm, run by phase_full (the hetero-tensor arm
    of each paged pair; ``paged`` None skips them) and phase_engine_full
    (its hetero-tensor/fast arm), against an eager arm run now on the same
    weights and prompts, in the same call: tok/s, decode and prefill
    seconds and the profiled busy share of each, the captured arm's graphs
    (count, capture seconds, pool bytes, replays) and each kernel's
    launches, which must be equal, as must the greedy tokens."""
    rows = {}
    for label, wq, kvq in FULL_PAIRS if paged else ():
        cap = paged[label]
        with _eager_loops():
            eager = _paged_arm(cfg, params, cap["prompts"], cap["new_tokens"],
                               label=f"{label} eager", mode="hetero-tensor",
                               weight_quant=wq, kv_quant=kvq, profile=True)
        rows[f"paged {label}"] = _pair_line(f"paged {label}", cap, eager)
    cap = engine["hetero-tensor/fast"]
    with _eager_loops():
        eager = _engine_arm(cfg, params, cap["prompt"], len(cap["tokens"]),
                            mode="hetero-tensor", fast=True,
                            label="hetero-tensor/fast eager", profile=True)
    rows[f"engine {cfg.name}"] = _pair_line(f"engine {cfg.name}", cap, eager)
    return rows


def full_width_model(arch: str, tag: str):
    """``arch`` at full width, bf16, seeded random weights on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.models import build_model

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    fence(params["embed"])
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, "
        f"{cfg.n_params / 1e9:.2f} B params, {n_bytes / 1e9:.2f} GB "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f}s")
    return cfg, params


def hybrid_model():
    """zamba2-2.7b at full width (54 mamba layers, d_model 2560, one shared
    attention block), bf16, seeded random weights on the card."""
    return full_width_model("zamba2-2.7b", "hybrid")


def phase_engine_hybrid(cfg, params, table) -> dict:
    """zamba2-2.7b through the single-request engine: prompt 600 (chunks
    512 and 88: a two-launch SSD scan at full width, then a ragged L), 16
    new tokens, hetero-tensor and xla with fast sync and hetero-tensor on
    the measured ``table``, then ``ssd_gate`` and ``attention_gate`` on
    this model (D = 80, 32 / 32 heads)."""
    return phase_engine_full(cfg, params, table, prompt_len=600,
                             new_tokens=16,
                             arms=(("hetero-tensor", True), ("xla", True)),
                             seed=6, gates=(ssd_gate, attention_gate))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _instrument(cb):
    """Wrap the batcher's admission and decode dispatches with device-synced
    wall timers, and keep each request's first-token logits (the last
    prefill chunk's logits when the request takes its lane). Returns (the
    timers, the function that undoes the wraps)."""
    from repro_torch.core.sync import fence
    timers = {"prefill": 0.0, "decode": 0.0, "first_logits": {}}
    last = {}

    def timed(fn, key):
        def run(*a, **k):
            fence(cb.kv.pool["k"])
            t0 = time.perf_counter()
            out = fn(*a, **k)
            fence(cb.kv.pool["k"])
            timers[key] += time.perf_counter() - t0
            return out
        return run

    prefill, place = cb._prefill, cb._place

    def keep_logits(*a, **k):
        out = prefill(*a, **k)
        last["logits"] = out[0]
        return out

    def place_and_record(req, seq, first):
        timers["first_logits"][req.rid] = last["logits"][0, -1].float()
        return place(req, seq, first)

    admit, window = cb._admit, cb._decode_window
    cb._prefill = keep_logits
    cb._place = place_and_record
    cb._admit = timed(admit, "prefill")
    cb._decode_window = timed(window, "decode")

    def undo():
        cb._prefill, cb._place = prefill, place
        cb._admit, cb._decode_window = admit, window

    return timers, undo


# ------------------------------------------------- phases A-D: the solver --

def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of ``fn()`` per call: ``iters`` calls captured into one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch cost (which ``cuda_time_ms`` sees where it exceeds the
    kernels') drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # first-use costs, uncaptured
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _event_wait_us(n: int = 400) -> tuple[float, float]:
    """(device microseconds per cross-stream event wait, per tiny kernel):
    ``n`` one-element adds queued behind a ``torch.cuda._sleep`` (so the
    host is far ahead and the card runs them back to back), once on one
    stream and once alternating between two streams with a wait at every
    switch; the difference over the ``n`` waits is the waits' cost."""
    import torch
    x = torch.zeros(1, device="cuda")
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()

    def chain(cross: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)         # ~30 ms: the host runs ahead
        start.record()
        for i in range(n):
            if cross and i % 2:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    x.add_(1)
                main.wait_stream(side)
            else:
                x.add_(1)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    chain(True)
    plain = min(chain(False) for _ in range(3))
    cross = min(chain(True) for _ in range(3))
    return (cross - plain) / n, plain / n


def _copy_fraction(n_streams: int, nbytes: int = 2 ** 30,
                   reps: int = 5) -> float:
    """HBM copy rate of ``n_streams`` concurrent streams, each copying its
    own ``nbytes`` buffer ``reps`` times (read + write), over H100's
    datasheet bandwidth."""
    import torch
    pairs = [(torch.empty(nbytes, dtype=torch.uint8, device="cuda"),
              torch.empty(nbytes, dtype=torch.uint8, device="cuda"))
             for _ in range(n_streams)]
    main = torch.cuda.current_stream()
    streams = [main] + [torch.cuda.Stream() for _ in range(n_streams - 1)]
    for dst, src in pairs:
        dst.copy_(src)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for s, (dst, src) in zip(streams, pairs):
        s.wait_stream(main)
        with torch.cuda.stream(s):
            for _ in range(reps):
                dst.copy_(src)
    for s in streams[1:]:
        main.wait_stream(s)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    return 2 * nbytes * reps * n_streams / seconds / HBM_BYTES_PER_S


def phase_characterize() -> dict:
    """Phase A, the paper's characterization step on the card: the host's
    launch + fence cost (``measure_dispatch_overhead``), the device cost of
    one cross-stream event wait, HBM copy bandwidth of one stream and of
    two concurrent streams (1 GiB each; the paper's Memory-1), and, at the
    llama3-8b sites with M = 256 (the largest prefill chunk of the paths),
    the device time of torch.matmul (the flexible path) and of
    ``HeteroCtx._mxu`` (the aligned path, padding and order exchange
    included) from CUDA graphs, against the stage model at peak; and a
    fenced torch.matmul at M = 1 beyond its bytes. Each derived constant
    is printed beside ``H100``'s committed one."""
    import statistics
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.characteristics import H100, mxu_matmul_parts
    from repro_torch.core.partition import HeteroCtx
    from repro_torch.core.profiler import model_weight_shapes
    from repro_torch.core.sync import fence, measure_dispatch_overhead

    g = torch.Generator(device="cuda").manual_seed(3)
    cfg = get_config("llama3-8b")
    ctx = HeteroCtx(mode="hetero-tensor")
    at_peak = replace(H100, mxu_eff=1.0)
    wait_us, add_us = _event_wait_us()
    single, dual = _copy_fraction(1), _copy_fraction(2)
    flops = xla_us = mxu_model_us = mxu_us = 0.0
    overheads, rows = [], []
    for site, (K, N) in model_weight_shapes(cfg).items():
        w = torch.randn((K, N), generator=g, device="cuda").bfloat16()
        x = torch.randn((256, K), generator=g, device="cuda").bfloat16()
        t_xla = graph_ms(lambda: x @ w) * 1e3
        t_mxu = graph_ms(lambda: ctx._mxu(x, w)) * 1e3
        model = mxu_matmul_parts(256, K, N, at_peak)[0]
        flops += 2 * 256 * K * N
        xla_us += t_xla
        mxu_model_us += model
        mxu_us += t_mxu
        x1 = x[:1].clone()
        fence(x1 @ w)
        walls = []
        for _ in range(30):
            t0 = time.perf_counter()
            fence(x1 @ w)
            walls.append((time.perf_counter() - t0) * 1e6)
        nbytes = (K + N + K * N) * 2
        over = statistics.median(walls) - nbytes / (HBM_BYTES_PER_S *
                                                    single) * 1e6
        overheads.append(over)
        rows.append({"site": site, "K": K, "N": N, "xla_us": t_xla,
                     "mxu_us": t_mxu, "mxu_model_at_peak_us": model,
                     "fenced_m1_us": statistics.median(walls),
                     "m1_overhead_us": over})
        log(f"[characterize] {site} (256 x {K} x {N}): torch.matmul "
            f"{t_xla:.2f} us, HeteroCtx._mxu {t_mxu:.2f} us (stage model "
            f"at peak {model:.2f}); fenced M = 1 "
            f"{statistics.median(walls):.2f} us, {over:.2f} beyond its "
            "bytes")
    measured = {
        "dispatch_us": measure_dispatch_overhead(n=200),
        "device_sync_us": wait_us,
        "bw_frac_single": single,
        "bw_frac_dual": dual,
        "xla_eff": flops / (xla_us * 1e-6) / H100.peak_flops_bf16,
        "xla_kernel_overhead_us": statistics.median(overheads),
        "mxu_eff": mxu_model_us / mxu_us,
    }
    for k, v in measured.items():
        log(f"[characterize] {k}: measured {v:.6g}, H100 committed "
            f"{getattr(H100, k):.6g}")
    log(f"[characterize] one-element add in a queued chain {add_us:.3f} us")
    log("[characterize] " + json.dumps({"measured": measured, "sites": rows}))
    return {"measured": measured, "sites": rows, "add_us": add_us}


# (arch, weight format) of the measured latency tables
PROFILE_CELLS = (("llama3-8b", None), ("llama3-8b", "int8"),
                 ("llama3-8b", "w4a16"), ("zamba2-2.7b", None))
# token counts profiled: the reference's grid plus the 64-token bucket
PROFILE_MS = (1, 32, 64, 128, 256, 512)


def phase_profile() -> dict:
    """Phase B: ``profile_measured`` at full width, uncapped, for llama3-8b
    (fp bf16, int8, W4A16) and zamba2-2.7b (fp): each table's wall time,
    the measured plan's decisions per strategy, and every (site, M) where
    it differs from the V5E plan. Each table is saved under build/tables/.
    Returns {(arch, weight format): table}."""
    from repro_torch.configs import get_config
    from repro_torch.core.characteristics import H100
    from repro_torch.core.engine import build_plan
    from repro_torch.core.profiler import model_weight_shapes, \
        profile_measured

    out_dir = ROOT / "build" / "tables"
    out_dir.mkdir(parents=True, exist_ok=True)
    tables = {}
    for arch, wq in PROFILE_CELLS:
        cfg = get_config(arch)
        label = f"{arch} {wq or 'fp'}"
        t0 = time.perf_counter()
        table = profile_measured(cfg, PROFILE_MS, weight_quant=wq)
        wall = time.perf_counter() - t0
        if table.spec is not H100 or table.mode != "measured" \
                or table.sites != model_weight_shapes(cfg):
            raise AssertionError(f"[profile] {label}: spec "
                                 f"{table.spec.name}, mode {table.mode}, "
                                 f"sites {table.sites}")
        _, plan = build_plan(cfg, table=table, weight_quant=wq)
        _, v5e = build_plan(cfg, weight_quant=wq)
        diffs = [f"{s}@{m}: {v5e.decisions[(s, m)].strategy}:"
                 f"{v5e.decisions[(s, m)].n_split}->{d.strategy}:{d.n_split}"
                 for (s, m), d in plan.decisions.items()
                 if (d.strategy, d.n_split, d.m_bucket) !=
                 (v5e.decisions[(s, m)].strategy,
                  v5e.decisions[(s, m)].n_split,
                  v5e.decisions[(s, m)].m_bucket)]
        log(f"[profile] {label}: table {len(table.entries)} entries in "
            f"{wall:.2f}s; measured plan "
            f"{dict(Counter(d.strategy for d in plan.decisions.values()))}"
            f", V5E plan "
            f"{dict(Counter(d.strategy for d in v5e.decisions.values()))}"
            f"; {len(diffs)}/{len(plan.decisions)} decisions differ")
        log(f"[profile] {label} differs at " + "; ".join(diffs))
        for M in (1, 64, 256):
            log(f"[profile] {label} M={M}: " + ", ".join(
                f"{s} xla {table.entries[(s, M, 'xla')]:.1f}"
                + (f" mxu {table.entries[(s, M, 'mxu')]:.1f}"
                   if (s, M, "mxu") in table.entries else "")
                + f" -> {plan.lookup(s, M).strategy}"
                for s in table.sites) + " (us)")
        table.save(out_dir / f"table_{arch}_{wq or 'fp'}.json")
        tables[(arch, wq)] = table
    return tables


def split_plan(cfg, ms):
    """A plan that splits every site of ``cfg``: at M = 1 by weight, and at
    each token count of ``ms`` (the prefill chunk lengths) by weight, act
    or hybrid in turn (site i at the j-th length: the (i + j) % 3-th), the
    column split near the middle on a 128 boundary, the token split at the
    middle."""
    from repro_torch.core.profiler import model_weight_shapes
    from repro_torch.core.solver import Decision, PartitionPlan

    plan = PartitionPlan(arch=cfg.name, sync_mode="fast")
    kinds = ("weight", "act", "hybrid")
    for i, (site, (_, N)) in enumerate(model_weight_shapes(cfg).items()):
        n = max(128, N // 256 * 128)
        plan.decisions[(site, 1)] = Decision(site, 1, "weight", 0.0,
                                             n_split=n, ratio="split")
        for j, M in enumerate(ms):
            kind = kinds[(i + j) % 3]
            plan.decisions[(site, M)] = Decision(
                site, M, kind, 0.0, n_split=0 if kind == "act" else n,
                m_bucket=0 if kind == "weight" else max(1, M // 2),
                ratio="split")
    return plan


class _one_stream:
    """Inside this block a split runs both halves on the current stream:
    ``core.partition.side_stream`` is patched to return it (for the
    one-stream arm held against two streams; the port has no switch)."""

    def __enter__(self):
        import torch
        from repro_torch.core import partition
        self.made = partition.side_stream
        partition.side_stream = torch.cuda.current_stream

    def __exit__(self, *exc):
        from repro_torch.core import partition
        partition.side_stream = self.made


def _split_engine(cfg, params, plan, device="cuda", **kw):
    """An InferenceEngine (hetero-tensor, hetero strategy) on ``plan`` whose
    decode steps also run through its HeteroCtx, so a decode loop captured
    on the card holds splits at M = 1."""
    from dataclasses import replace
    from functools import partial
    from repro_torch.core.engine import InferenceEngine

    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy="hetero", plan=plan,
                          device=device, **kw)
    eng.model = replace(eng.model, decode_step=partial(
        eng.model.decode_step, hetero_ctx=eng.ctx))
    return eng


def _split_logits(eng, prompt):
    """fp32 first-token logits of ``prompt`` through ``eng`` (its prefill
    chunks), the first decode step's logits run eagerly, and the same step
    captured as a CUDA graph and replayed. For the dense transformer that
    is the same step thrice: each writes the same KV slot (a hybrid's step
    would advance its recurrent state each time). Returns (the logits,
    the captured step, its inputs)."""
    from repro_torch.core.sync import make_loop

    seen, prefill = {}, eng._prefill

    def keep(*a, **k):
        seen["logits"], seen["cache"] = prefill(*a, **k)
        return seen["logits"], seen["cache"]

    eng._prefill = keep
    try:
        eng.generate(prompt, 1)
    finally:
        eng._prefill = prefill
    import torch
    cache = seen["cache"]
    first = torch.argmax(seen["logits"][:, -1, :], dim=-1)[:, None]
    eager, _ = eng.model.decode_step(eng.params, first, dict(cache))

    def step(token, index):
        return eng.model.decode_step(eng.params, token,
                                     {**cache, "index": index})[0]

    args = (first, cache["index"])
    loop = make_loop(step, args)
    captured = loop(*args)
    return ({"first": seen["logits"][0, -1].float(),
             "decode": eager[0, -1].float(),
             "decode_captured": captured[0, -1].float().clone()},
            loop, args)


# the aligned half's kernels (the port's GEMMs); every kernel on their
# stream is the aligned half, every kernel on another stream the flexible
GEMM_KERNELS = ("gemm_tc", "splitk_reduce", "mm_output_stationary",
                "mm_weight_stationary", "cast_from_f32", "quant_mm",
                "qgemm_tc")


def _overlap(label: str, run, by_name: bool = False) -> dict:
    """``run()`` under torch.profiler (the card only), its Chrome trace read
    back: the streams of the port's GEMM kernels, and the fraction of the
    device time of every kernel on those streams (the aligned halves) that
    overlaps a kernel on another stream (the flexible halves). With
    ``by_name`` (a graph replay, whose branches the trace need not show as
    streams) the aligned halves are the GEMM kernels themselves and the
    flexible halves every other kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "build" / "traces" / f"{label.replace(' ', '_')}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and e.get("dur")]
    path.unlink()
    gemm = [any(k in e["name"] for k in GEMM_KERNELS) for e in events]
    aligned_streams = {e["args"].get("stream")
                       for e, is_gemm in zip(events, gemm) if is_gemm}
    aligned = gemm if by_name else [e["args"].get("stream") in
                                    aligned_streams for e in events]
    side = [(e["ts"], e["ts"] + e["dur"])
            for e, a in zip(events, aligned) if a]
    other = sorted((e["ts"], e["ts"] + e["dur"])
                   for e, a in zip(events, aligned) if not a)
    union = []
    for a, b in other:                   # the flexible halves' busy spans
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    busy = sum(b - a for a, b in side)
    shared = sum(max(0.0, min(b, v) - max(a, u))
                 for a, b in side for u, v in union)
    row = {"kernels": len(events), "aligned_streams": sorted(
        s for s in aligned_streams if s is not None),
        "n_streams": len({e["args"].get("stream") for e in events}),
        "aligned_busy_us": busy, "overlap_us": shared,
        "overlap_fraction": shared / busy if busy else None}
    log(f"[two-streams] {label} trace: {json.dumps(row)}")
    return row


def phase_two_streams_smoke() -> None:
    """Phase D on the fp32 smoke models: a plan that splits every site
    (``split_plan`` at the chunk lengths, weight at M = 1) gives the same
    greedy tokens on two streams, on one stream (the hook patched) and on
    the CPU: the engine (llama3 and zamba2; decode through the HeteroCtx,
    its loop captured with the splits inside, two prompts so the second
    replays it) and, for llama3, the paged batcher (splits in prefill)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving.scheduler import PREFILL_BUCKETS, bucket_chunks

    for arch in ("llama3-8b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch).with_(param_dtype="float32",
                                           compute_dtype="float32")
        params = build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(7), device="cuda")
        cpu_params = _to_device(params, "cpu")
        prompts = [np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, 77)) for seed in (3, 5)]
        plan = split_plan(cfg, (64, 13))
        outs = {}
        for arm in ("two streams", "one stream", "cpu"):
            device = "cpu" if arm == "cpu" else "cuda"
            with _one_stream() if arm == "one stream" else nullcontext():
                eng = _split_engine(cfg, cpu_params if arm == "cpu"
                                    else params, plan, device=device,
                                    buckets=(32, 64))
                _zero_counts()
                outs[arm] = [eng.generate(p, 12).tolist() for p in prompts]
            counts, graphs = _read_counts(), eng.graph_stats()
            log(f"[two-streams] {arch} engine {arm}: chunks "
                f"{eng._bucket_chunks(77)}, graphs {graphs}, launches "
                f"{counts}, tokens {outs[arm][0][0]}")
            if device == "cuda" and (graphs["graphs"] != 1
                                     or counts["hetero_matmul"] <= 0):
                raise AssertionError(f"[two-streams] {arch} {arm}: graphs "
                                     f"{graphs}, launches {counts}")
        if len({str(o) for o in outs.values()}) != 1:
            raise AssertionError(f"[two-streams] {arch} engine tokens "
                                 f"differ: {outs}")
        if cfg.ssm is not None:
            continue
        sp = _smoke_prompts(cfg.vocab_size)
        ms = sorted({c for p in sp for c in bucket_chunks(len(p),
                                                          PREFILL_BUCKETS)})
        plan = split_plan(cfg, [m for m in ms if m > 1])
        outs = {}
        for arm in ("two streams", "one stream", "cpu"):
            device = "cpu" if arm == "cpu" else "cuda"
            with _one_stream() if arm == "one stream" else nullcontext():
                cb, reqs = _serve(cfg, cpu_params if arm == "cpu" else
                                  params, sp, device=device,
                                  engine_mode="hetero-tensor",
                                  sync="device", window=4, decode_width=4,
                                  new_tokens=12)
                cb.ctx.plan = plan
                cb.run(reqs)
            outs[arm] = [r.output for r in reqs]
        if len({str(o) for o in outs.values()}) != 1:
            raise AssertionError(f"[two-streams] {arch} paged tokens "
                                 f"differ: {outs}")
        log(f"[two-streams] {arch}: engine and paged tokens equal on two "
            f"streams, one stream and the CPU (chunk lengths {ms})")


def phase_two_streams(cfg, params, prompt_len: int = 300,
                      new_tokens: int = 8, seed: int = 4) -> dict:
    """Phase D at full width: llama3-8b through the engine on
    ``split_plan`` at its chunk lengths (every site split in prefill, every
    site split by weight in decode), once on two streams and once with the
    side-stream hook patched to the current stream. The first-token logits,
    the first decode step's logits (eager and in a captured graph) and the
    captured loop's greedy tokens must be bitwise equal, and the launches
    equal; then each arm's prefill is timed and profiled, and the trace
    gives the share of the aligned halves' device time that overlaps the
    flexible halves."""
    import numpy as np
    import torch
    from repro_torch.core.sync import fence

    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (1, prompt_len))
    arms = {}
    for arm in ("two streams", "one stream"):
        with _one_stream() if arm == "one stream" else nullcontext():
            eng = _split_engine(cfg, params, None)
            eng.plan = eng.ctx.plan = split_plan(
                cfg, [c for c, _ in eng._bucket_chunks(prompt_len)])
            _zero_counts()
            logits, step, args = _split_logits(eng, prompt)
            tokens = eng.generate(prompt, new_tokens)[0].tolist()
            counts = _read_counts()
            step_ms = cuda_time_ms(lambda: step(*args))
            step_trace = _overlap(f"llama3 decode step {arm}",
                                  lambda: [step(*args) for _ in range(2)],
                                  by_name=True)
            walls = []
            for _ in range(3):
                fence(params["embed"])
                t0 = time.perf_counter()
                eng.generate(prompt, 1)
                fence(params["embed"])
                walls.append(time.perf_counter() - t0)
            trace = _overlap(f"llama3 prefill {arm}",
                             lambda: eng.generate(prompt, 1))
        arms[arm] = {"logits": logits, "tokens": tokens, "launches": counts,
                     "prefill_s": sorted(walls)[1], "trace": trace,
                     "step_ms": step_ms, "step_trace": step_trace}
        log(f"[two-streams] {cfg.name} {arm}: prefill (median of 3) "
            f"{sorted(walls)[1]:.4f}s, captured split decode step "
            f"{step_ms:.4f} ms, tokens {tokens}, launches {counts}")
        del eng, step
        gc.collect()
        torch.cuda.empty_cache()
    two, one = arms["two streams"], arms["one stream"]
    for name in two["logits"]:
        a, b = two["logits"][name], one["logits"][name]
        if not (torch.isfinite(a).all() and torch.equal(a, b)):
            raise AssertionError(f"[two-streams] {name} logits differ: max "
                                 f"|diff| {float((a - b).abs().max())}")
    if two["tokens"] != one["tokens"] or two["launches"] != one["launches"] \
            or two["launches"]["hetero_matmul"] <= 0:
        raise AssertionError(f"[two-streams] tokens or launches differ: "
                             f"{two['tokens']} / {one['tokens']}, "
                             f"{two['launches']} / {one['launches']}")
    if len(two["trace"]["aligned_streams"]) != 1 \
            or one["trace"]["n_streams"] != 1:
        raise AssertionError(f"[two-streams] streams: two "
                             f"{two['trace']}, one {one['trace']}")
    log(f"[two-streams] {cfg.name}: first-token, decode and captured decode "
        f"logits bitwise equal on two streams and one; captured tokens "
        f"equal; aligned halves overlap the flexible halves "
        f"{two['trace']['overlap_fraction']:.3f} of their device time in "
        f"the eager prefill, {two['step_trace']['overlap_fraction']:.3f} "
        f"in the captured decode step; prefill {two['prefill_s']:.4f}s on "
        f"two streams, {one['prefill_s']:.4f}s on one; captured step "
        f"{two['step_ms']:.4f} ms on two, {one['step_ms']:.4f} ms on one")
    return {k: {key: v[key] for key in ("tokens", "launches", "prefill_s",
                                        "trace", "step_ms", "step_trace")}
            for k, v in arms.items()}


# ---------------------------------------------------------------------- main --

# ---------------------------------------------- phase E: the serving arms --

def _instrument_arms(cb):
    """Wrap a batcher's dispatches with device-synced wall timers: target
    prefill (``prefill``, and by chunk length ``prefill_by_len``: {length:
    [dispatches, seconds]}), decode windows / ticks / speculative rounds
    (``decode``), the draft lanes' prompt prefill (``draft_prefill``); keep
    each request's first-token logits (a standalone prefill's, or the
    mixed window's chunk logits); and count the launches of each kernel
    inside the windows that carry a prefill chunk (``mixed_launches``),
    inside the speculative rounds (``verify_launches``: the draft loop runs
    no kernel of the port, so these are the verify dispatch's) and inside
    the draft prefill (``draft_launches``). Returns the record."""
    from repro_torch.core.sync import fence
    rec = {"prefill": 0.0, "decode": 0.0, "draft_prefill": 0.0,
           "mixed_windows": 0, "first_logits": {},
           "mixed_launches": Counter(), "draft_launches": Counter(),
           "verify_launches": Counter(), "prefill_by_len": {}}
    last = {}
    anchor = cb.kv.pool["k"]

    def timed(fn, key, launches=None, when=lambda *a: True):
        def run(*a, **k):
            fence(anchor)
            before = _read_counts()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            fence(anchor)
            rec[key] += time.perf_counter() - t0
            if launches is not None and when(*a):
                after = _read_counts()
                rec[launches].update({n: after[n] - before[n] for n in after
                                      if after[n] != before[n]})
            return out
        return run

    prefill, place, finish = cb._prefill, cb._place, cb._finish_admission

    def keep_logits(params, tokens, *a, **k):
        fence(anchor)
        t0 = time.perf_counter()
        out = prefill(params, tokens, *a, **k)
        fence(anchor)
        dt = time.perf_counter() - t0
        rec["prefill"] += dt
        n_s = rec["prefill_by_len"].setdefault(int(tokens.shape[1]), [0, 0.0])
        n_s[0] += 1
        n_s[1] += dt
        last["logits"] = out[0]
        return out

    def keep_chunk_logits(pre_logits):
        last["logits"] = pre_logits
        return finish(pre_logits)

    def place_and_record(req, seq, first):
        rec["first_logits"][req.rid] = last["logits"][0, -1].float()
        return place(req, seq, first)

    def mixed(*a):
        if len(a) > 1 and a[1] is not None:
            rec["mixed_windows"] += 1
            return True
        return False

    cb._prefill = keep_logits
    cb._finish_admission = keep_chunk_logits
    cb._place = place_and_record
    cb._decode_window = timed(cb._decode_window, "decode", "mixed_launches",
                              mixed)
    cb._decode_tick = timed(cb._decode_tick, "decode", "mixed_launches",
                            mixed)
    cb._spec_round = timed(cb._spec_round, "decode", "verify_launches")
    if cb.drafts is not None:
        cb.drafts.prefill = timed(cb.drafts.prefill, "draft_prefill",
                                  "draft_launches")
    return rec


def _run_waves(cb, waves, new_tokens: int, device) -> dict:
    """Each wave of prompts through ``cb`` in turn (request ids 0.., then
    100.., ...): the tokens and first-token logits of each wave, its wall
    and the record's times, launches per kernel, and ``stats()`` after
    the last wave."""
    from repro_torch.core.sync import fence
    rec = _instrument_arms(cb)
    anchor = cb.kv.pool["k"]
    out = {"waves": [], "record": rec}
    _zero_counts()
    for w, prompts in enumerate(waves):
        reqs = _requests(prompts, new_tokens)
        for r in reqs:
            r.rid += 100 * w
        rec["first_logits"] = {}
        before = {k: rec[k] for k in ("prefill", "decode", "draft_prefill")}
        fence(anchor)
        t0 = time.perf_counter()
        cb.run(reqs)
        fence(anchor)
        wall = time.perf_counter() - t0
        cb.kv.assert_drained()
        for r in reqs:
            if len(r.output) != new_tokens:
                raise AssertionError(f"request {r.rid}: {len(r.output)} "
                                     "tokens")
        tok = sum(len(r.output) for r in reqs)
        out["waves"].append({
            "outputs": [r.output for r in reqs], "wall_s": wall,
            "tok_per_s": tok / wall,
            "first_logits": [rec["first_logits"][r.rid] for r in reqs],
            **{k: rec[k] - before[k] for k in before}})
    out["launches"] = _read_counts()
    out["stats"] = cb.stats()
    out["graphs"] = cb.graph_stats()
    out["capture_s"] = sum(getattr(lp, "capture_s", 0.0) for lp in
                           list(cb._loops.values())
                           + list((cb.drafts.loops if cb.drafts else
                                   {}).values()))
    return out


def _prefix_waves(vocab: int, prefix_len: int, suffixes, seed: int = 6):
    """Two waves of requests sharing one ``prefix_len``-token prefix, the
    second the first's prompts again (every full block of the prefix and
    of each suffix hits)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    wave = [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in suffixes]
    return [wave, [p.copy() for p in wave]]


# the serving arms of phase E on the smoke models: (label, batcher kwargs,
# waves: "plain" prompts or the two "prefix" waves)
SMOKE_ARMS = (
    ("mixed/device", dict(mixed_batch=True, sync="device", window=3),
     "plain"),
    ("mixed/host", dict(mixed_batch=True, sync="host"), "plain"),
    ("spec self/device", dict(spec=3, sync="device"), "plain"),
    ("spec self/host", dict(spec=3, sync="host"), "plain"),
    ("spec smollm/device", dict(spec="smollm", sync="device"), "plain"),
    ("spec smollm/host", dict(spec="smollm", sync="host"), "plain"),
    ("prefix/device", dict(prefix_cache=True, sync="device", window=3),
     "prefix"),
    ("prefix kv8/device", dict(prefix_cache=True, sync="device", window=3,
                               kv_quant="int8"), "prefix"),
    ("int8+kv8 mixed/device", dict(mixed_batch=True, sync="device",
                                   window=3, weight_quant="int8",
                                   kv_quant="int8"), "plain"),
    ("int8+kv8 prefix/device", dict(prefix_cache=True, sync="device",
                                    window=3, weight_quant="int8",
                                    kv_quant="int8"), "prefix"),
    ("w4a16 mixed/device", dict(mixed_batch=True, sync="device", window=3,
                                weight_quant="w4a16"), "plain"),
    ("w4a16 prefix/device", dict(prefix_cache=True, sync="device",
                                 window=3, weight_quant="w4a16"), "prefix"),
)


def _smoke_arms(devices=("cuda", "cpu")) -> dict:
    """Phase E on the fp32 llama3 smoke model: every arm of SMOKE_ARMS
    (hetero-tensor) on each of ``devices`` gives the non-arm batcher's
    tokens of its format on that device (sync device, window 3, over the
    same waves), and the card's tokens equal the CPU's. The spec arms
    draft with the target (k = 3) or an independent fp32 smollm smoke draft
    (k = 3) that shares its vocab. On the card each mixed arm launches the
    format's GEMM inside its chunk-carrying windows where its plan sends
    work to the aligned path (sync device; under sync host the plan keeps
    every smoke-size site xla_only), and each spec arm the flash kernel in
    its draft prefill."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving.spec import SpecConfig

    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    cfg = get_smoke_config("llama3-8b").with_(**fp32)
    dcfg = get_smoke_config("smollm-135m").with_(**fp32)
    gen = torch.Generator(device=devices[0])
    params = {devices[0]: build_model(cfg).init(gen.manual_seed(7),
                                                device=devices[0])}
    dparams = {devices[0]: build_model(dcfg).init(gen.manual_seed(8),
                                                  device=devices[0])}
    for d in devices[1:]:
        params[d] = _to_device(params[devices[0]], d)
        dparams[d] = _to_device(dparams[devices[0]], d)
    prompts = _smoke_prompts(cfg.vocab_size)
    waves = {"plain": [prompts],
             "prefix": _prefix_waves(cfg.vocab_size, 64, (9, 40, 0, 71))}
    new_tokens = 12
    base, outs = {}, {}

    def run(label, kw, shape, device):
        kw = dict(kw)
        if kw.get("spec") == "smollm":
            kw["spec"] = SpecConfig(k=3, draft=dcfg)
            kw["spec_draft_params"] = dparams[device]
        cb, _ = _serve(cfg, params[device], waves[shape][0], device=device,
                       engine_mode="hetero-tensor", decode_width=4,
                       new_tokens=new_tokens,
                       **{"sync": "device", "window": 3, **kw})
        got = _run_waves(cb, waves[shape], new_tokens, device)
        # under sync host the reference's 50 us T_sync keeps every
        # smoke-size site xla_only: no GEMM launch is expected there
        got["planned"] = any(d.strategy != "xla_only"
                             for d in cb.ctx.plan.decisions.values())
        rec = got["record"]
        log(f"[arms] smoke {label} {device}: {got['stats']} graphs "
            f"{got['graphs']} launches {got['launches']}; mixed windows "
            f"{rec['mixed_windows']} launching {dict(rec['mixed_launches'])}"
            f"; draft prefill launching {dict(rec['draft_launches'])}")
        return got

    for label, kw, shape in SMOKE_ARMS:
        fmt = (kw.get("weight_quant"), kw.get("kv_quant"))
        for device in devices:
            if (fmt, shape, device) not in base:
                plain = run(f"{fmt[0] or 'fp'}/kv={fmt[1]} plain {shape}",
                            dict(weight_quant=fmt[0], kv_quant=fmt[1]),
                            shape, device)
                base[fmt, shape, device] = [w["outputs"]
                                            for w in plain["waves"]]
            got = run(label, kw, shape, device)
            rec = got["record"]
            outs[label, device] = [w["outputs"] for w in got["waves"]]
            if outs[label, device] != base[fmt, shape, device]:
                raise AssertionError(
                    f"[arms] smoke {label} on {device}: tokens "
                    f"{outs[label, device]} differ from the non-arm "
                    f"batcher's {base[fmt, shape, device]}")
            if shape == "prefix" and got["stats"]["prefix_hits"] <= 0:
                raise AssertionError(f"[arms] smoke {label}: no prefix hit")
            if device != "cuda":
                continue
            gemm = KERNEL_OF_FORMAT[fmt[0]]
            if kw.get("mixed_batch") and \
                    (rec["mixed_launches"][gemm] > 0) != got["planned"]:
                raise AssertionError(
                    f"[arms] smoke {label}: {rec['mixed_launches'][gemm]} "
                    f"{gemm} launches in the chunk-carrying windows, "
                    f"expected {'some' if got['planned'] else 'none'}")
            if "spec" in kw and rec["draft_launches"]["flash_attention"] <= 0:
                raise AssertionError(f"[arms] smoke {label}: the draft "
                                     "prefill never launched flash attention")
    for label, _, _ in SMOKE_ARMS:
        if len({str(outs[label, d]) for d in devices}) != 1:
            raise AssertionError(f"[arms] smoke {label}: card and CPU tokens "
                                 f"differ: {[outs[label, d] for d in devices]}")
    log(f"[arms] smoke: {len(SMOKE_ARMS)} arms on {', '.join(devices)} give "
        "the non-arm batcher's tokens, card equal to CPU")
    return outs


def _cosines(label: str, got, want) -> list:
    """First-token logits of each request against the plain arm's: cosine
    (gated at 0.99) and rel_err, logged."""
    import torch
    cos = []
    for rid, (a, b) in enumerate(zip(got, want)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"[arms] {label} request {rid}: non-finite "
                                 "logits")
        c = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        cos.append(c)
        log(f"[arms] {label} request {rid}: first-token logits cos {c:.6f}, "
            f"rel_err {rel_err(a, b):.3g}")
        if c < 0.99:
            raise AssertionError(f"[arms] {label} request {rid}: cosine "
                                 f"{c:.4f} < 0.99")
    return cos


def _full_arm(cfg, params, waves, new_tokens: int, label: str,
              device="cuda", **kw) -> dict:
    """One full-width PagedBatcher arm (hetero-tensor, sync device, window
    8, width 8): a first pass over the waves, which captures its graphs,
    then a timed pass over new requests for the same prompts. Returns the
    timed pass (``stats`` counting both passes)."""
    import torch
    cb, _ = _serve(cfg, params, [p for w in waves for p in w], device=device,
                   engine_mode="hetero-tensor", decode_width=8,
                   new_tokens=new_tokens, **{"sync": "device", "window": 8,
                                             **kw})
    t0 = time.perf_counter()
    first = _run_waves(cb, waves, new_tokens, device)
    first_s = time.perf_counter() - t0
    if kw.get("prefix_cache"):          # the timed pass starts cold again
        cb.kv._reclaim(cb.kv.allocator.n_cached)
    run = _run_waves(cb, waves, new_tokens, device)
    run["first_pass_s"] = first_s
    run["first_pass_stats"] = first["stats"]
    run["pool_bytes"] = cb.kv.pool_bytes()
    w = run["waves"]
    log(f"[arms] {label}: " + "; ".join(
        f"wave {i + 1}: {x['tok_per_s']:.2f} tok/s in {x['wall_s']:.3f}s, "
        f"prefill {x['prefill']:.3f}s, decode {x['decode']:.3f}s"
        + (f", draft prefill {x['draft_prefill']:.3f}s"
           if x["draft_prefill"] else "") for i, x in enumerate(w))
        + f"; stats {run['stats']}; graphs {run['graphs']}, capture "
        f"{run['capture_s']:.2f}s (first pass {first_s:.2f}s); launches "
        f"{run['launches']}; mixed windows {run['record']['mixed_windows']} "
        f"launching {dict(run['record']['mixed_launches'])}; verify "
        f"launching {dict(run['record']['verify_launches'])}; draft prefill "
        f"launching {dict(run['record']['draft_launches'])}; target prefill "
        "by chunk length {length: [dispatches, s]} (both waves) "
        + str({n: [c, round(t, 4)] for n, (c, t) in
               sorted(run['record']['prefill_by_len'].items())}))
    del cb
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run


def phase_serving_arms(cfg, params, full, new_tokens: int = 16,
                       device="cuda") -> dict:
    """Phase E: mixed batching, speculative decoding and the prefix cache.
    First on the smoke models (``_smoke_arms``), then at full width on
    llama3-8b (bf16, hetero-tensor on the V5E plan, sync device, window 8,
    width 8, block 32), each held to a plain arm by first-token cosine
    (>= 0.99):

      * mixed: phase 4's prompts (256, 44, 37, 193; 16 new tokens), all
        submitted at once, so every admission after the first rides a
        running lane's window: fused steps > 0, fewer standalone prefill
        dispatches than the plain fp arm (``full["fp"]``), GEMM 2.1
        launched inside the chunk-carrying windows;
      * spec: the same prompts, self-draft, k = 4: verify dispatches fewer
        than the plain arm's decode steps, kernel 2.4 launched by the draft
        prefill; acceptance and token agreement printed, not gated;
      * prefix: two waves of four requests sharing a 256-token prefix
        (suffixes 44, 37, 193, 16) against a plain batcher on the same
        waves: wave 2 hits, every block back after the run.

    Returns {arm: record}, each with its launches per kernel. (``device``
    "cpu" rehearses the phase on the CPU, where no kernel launches.)"""
    smoke = _smoke_arms(("cuda", "cpu") if device == "cuda" else ("cpu",))
    plain = full["fp"]
    prompts = plain["prompts"]
    out = {"smoke_arms": len(smoke)}
    card = device == "cuda"

    mixed = _full_arm(cfg, params, [prompts], new_tokens, "mixed", device,
                      mixed_batch=True)
    s, ps = mixed["stats"], plain["stats"]
    _cosines("mixed", mixed["waves"][0]["first_logits"],
             [plain["first_logits"][r] for r in range(len(prompts))])
    gemm = mixed["record"]["mixed_launches"]["hetero_matmul"]
    if s["fused_steps"] <= 0 or \
            s["prefill_dispatches"] >= ps["prefill_dispatches"] or \
            (card and gemm <= 0):
        raise AssertionError(f"[arms] mixed: fused {s['fused_steps']}, "
                             f"prefill dispatches {s['prefill_dispatches']} "
                             f"(plain {ps['prefill_dispatches']}), GEMM "
                             f"launches in mixed windows {gemm}")
    out["mixed"] = mixed

    spec = _full_arm(cfg, params, [prompts], new_tokens, "spec k=4", device,
                     spec=4)
    s = spec["stats"]
    _cosines("spec", spec["waves"][0]["first_logits"],
             [plain["first_logits"][r] for r in range(len(prompts))])
    same = sum(x == y for a, b in zip(spec["waves"][0]["outputs"],
                                      plain["outputs"])
               for x, y in zip(a, b))
    total = sum(len(o) for o in plain["outputs"])
    flash = spec["record"]["draft_launches"]["flash_attention"]
    log(f"[arms] spec: acceptance {s['acceptance_rate']:.4f} "
        f"({s['accepted_tokens']}/{s['drafted_tokens']}), verify dispatches "
        f"{s['verify_dispatches']} against the plain arm's "
        f"{ps['decode_steps']} decode steps; tokens equal to the plain "
        f"arm's {same}/{total}; flash launches by the draft prefill {flash}")
    if s["verify_dispatches"] >= ps["decode_steps"] or (card and flash <= 0):
        raise AssertionError(f"[arms] spec: verify dispatches "
                             f"{s['verify_dispatches']} (plain decode steps "
                             f"{ps['decode_steps']}), draft flash launches "
                             f"{flash}")
    spec["agreement"] = same / total
    out["spec"] = spec

    waves = _prefix_waves(cfg.vocab_size, 256, (44, 37, 193, 16))
    base = _full_arm(cfg, params, waves, new_tokens, "prefix plain", device)
    pre = _full_arm(cfg, params, waves, new_tokens, "prefix", device,
                    prefix_cache=True)
    for w in range(2):
        _cosines(f"prefix wave {w + 1}", pre["waves"][w]["first_logits"],
                 base["waves"][w]["first_logits"])
    s = pre["stats"]
    if s["prefix_hits"] <= 0:
        raise AssertionError(f"[arms] prefix: no warm hit: {s}")
    log(f"[arms] prefix: wave 2 prefill {pre['waves'][1]['prefill']:.4f}s "
        f"against wave 1's {pre['waves'][0]['prefill']:.4f}s (plain "
        f"{base['waves'][1]['prefill']:.4f}s / "
        f"{base['waves'][0]['prefill']:.4f}s); hits {s['prefix_hits']}, "
        f"tokens reused {s['prefix_tokens_reused']}, cached blocks "
        f"{s['cached_blocks']}, all blocks back")
    out["prefix"], out["prefix plain"] = pre, base
    return out


# ------------------------------------------------------------------ phase F --

# phase F0's workload on the smoke models: the reference fuzz test's prompt
# palette, budgets 4..11, the first half of the arrivals low priority and
# the second half high, Poisson at 300 req/s on a FakeClock (1 ms a tick),
# a pool of 11 blocks of 16 (two or three requests): the schedule, and with
# it a preemption, is the same on every device
F0_PALETTE = (4, 9, 20, 32, 33, 48, 57, 64)
F0_POOL = dict(num_blocks=11, block_size=16, max_blocks_per_seq=5,
               decode_width=3, buckets=(32, 64))
F0_MAX_LEN = 80
# phase F1's pool: 12 blocks of 32, 11 usable. The longest requests (256
# + 16 tokens, 9 blocks) run alone, a low-priority request of 7 blocks
# (193 or 177 tokens) runs beside one small lane at most, and a
# high-priority arrival of 3 blocks is blocked beside it and preempts it.
# On an H100 at 700 W a pool of 10 blocks, and one of 14 with an admission
# watermark of 4, admitted both high-priority arrivals beside the small
# low-priority lanes running when they came, and preempted nothing; a
# schedule model (FakeClock, a prefill chunk 0.08-0.16 s plus 0-0.4 ms a
# token, a window 0.05-0.1 s) preempted in 14 of 18 cost settings at 12
# blocks, against 11 of 18 at 13 and 8 of 18 at 11. At 12 blocks the card
# preempted in some runs and not in others, so F1's preemption gate holds on
# a FakeClock run of the same requests (_f1_forced_preemption).
F1_BLOCKS = 12


def _check_trace():
    """scripts/check_trace.py (which imports no JAX) from the checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "scripts" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f0_workload(vocab: int, n: int = 6):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.choice(F0_PALETTE, size=n)
    prompts = [rng.integers(0, vocab, s).astype(np.int32) for s in lens]
    budgets = [int(b) for b in rng.integers(4, 12, size=n)]
    return prompts, budgets, [0] * (n // 2) + [1] * (n - n // 2)


def _dense_sequential(cfg, params, prompt, n: int, device) -> list:
    """The port's sequential reference for the dense batcher: one request
    alone in a one-slot dense cache (the model's default dtype), prefilled
    by bucket chunks, then greedy steps."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.scheduler import bucket_chunks
    model = build_model(cfg)
    cache = model.init_cache(batch=1, max_len=F0_MAX_LEN, device=device)
    cache["index"] = torch.zeros((1,), dtype=torch.int32, device=device)
    idx = 0
    for c in bucket_chunks(len(prompt), F0_POOL["buckets"]):
        piece = torch.as_tensor(prompt[idx: idx + c], device=device).long()
        logits, cache = model.prefill_slot(params, cache, piece, 0, idx)
        idx += c
    cache["index"][0] = len(prompt)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[out[-1]]], device=device), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def _f0_serve(cfg, params, batcher, device, traced: bool = False) -> dict:
    """Phase F0's workload through AsyncServer (open loop, FakeClock) over
    one batcher: "dense", or paged "host" / "device" (hetero-tensor; host
    with the prefix cache). Returns the streams and the server's counts."""
    import torch
    from repro_torch.serving.ingress import (AsyncServer, arrival_times,
                                             open_loop_workload)
    from repro_torch.serving.scheduler import ContinuousBatcher, PagedBatcher
    from repro_torch.serving.telemetry import FakeClock
    from repro_torch.serving.trace import Tracer, counter_reconciliation
    clock = FakeClock()
    tracer = Tracer(clock) if traced else None
    if batcher == "dense":
        cb = ContinuousBatcher(cfg, params, max_batch=3, max_len=F0_MAX_LEN,
                               buckets=F0_POOL["buckets"], tracer=tracer,
                               device=device)
    else:
        sync = (dict(sync="host", prefix_cache=True) if batcher == "host"
                else dict(sync="device", window=3))
        cb = PagedBatcher(cfg, params, engine_mode="hetero-tensor",
                          cache_dtype=torch.float32, tracer=tracer,
                          device=device, **F0_POOL, **sync)
    server = AsyncServer(cb, clock=clock, step_time_s=1e-3)
    prompts, budgets, prios = _f0_workload(cfg.vocab_size)
    handles = server.run_sync(open_loop_workload(
        prompts, budgets, arrival_times("poisson", 300.0, len(prompts), 0),
        prios))
    if batcher != "dense":
        cb.kv.assert_drained()
    for h, m in zip(handles, budgets):
        if not h.done or h.terminal_events != 1 or len(h.tokens) != m:
            raise AssertionError(f"[front-end] smoke {batcher} on {device}:"
                                 f" request {h.rid} streamed {h.tokens}")
    out = {"tokens": [h.tokens for h in handles],
           "preemptions": server.preemptions, "stats": server.stats()}
    if traced:
        mism = counter_reconciliation(tracer, server.stats())
        if mism:
            raise AssertionError(f"[front-end] smoke {batcher} on {device}:"
                                 f" counters do not reconcile: {mism}")
        out["events"] = tracer.n_events
    return out


def _front_end_smoke(devices=("cuda", "cpu")) -> dict:
    """Phase F0 on the fp32 llama3 smoke model, on each device: the dense
    batcher, and AsyncServer over the paged batcher with host and with
    device sync, each through a preemption and its resume, give the port's
    sequential reference's tokens (the dense one-slot run, and the paged
    batcher with one lane); a traced run gives the untraced run's tokens;
    the card's tokens equal the CPU's."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving.scheduler import PagedBatcher, Request

    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = {devices[0]: build_model(cfg).init(
        torch.Generator(device=devices[0]).manual_seed(7),
        device=devices[0])}
    for d in devices[1:]:
        params[d] = _to_device(params[devices[0]], d)
    prompts, budgets, _ = _f0_workload(cfg.vocab_size)
    got = {}
    for device in devices:
        p = params[device]
        dense_ref = [_dense_sequential(cfg, p, x, m, device)
                     for x, m in zip(prompts, budgets)]
        one = PagedBatcher(cfg, p, **{**F0_POOL, "decode_width": 1},
                           cache_dtype=torch.float32, device=device)
        reqs = [Request(rid=i, prompt=x, max_new_tokens=m)
                for i, (x, m) in enumerate(zip(prompts, budgets))]
        one.run(reqs)
        paged_ref = [r.output for r in reqs]
        for batcher, want in (("dense", dense_ref), ("host", paged_ref),
                              ("device", paged_ref)):
            run = _f0_serve(cfg, p, batcher, device)
            log(f"[front-end] smoke {batcher} on {device}: preemptions "
                f"{run['preemptions']}, stats {run['stats']}")
            if run["tokens"] != want:
                raise AssertionError(
                    f"[front-end] smoke {batcher} on {device}: tokens "
                    f"{run['tokens']} differ from the sequential "
                    f"reference's {want}")
            if batcher != "dense" and run["preemptions"] < 1:
                raise AssertionError(f"[front-end] smoke {batcher} on "
                                     f"{device}: no preemption")
            got[batcher, device] = run["tokens"]
        traced = _f0_serve(cfg, p, "device", device, traced=True)
        if traced["tokens"] != got["device", device]:
            raise AssertionError(f"[front-end] smoke traced run on {device}:"
                                 " tokens differ from the untraced run's")
        log(f"[front-end] smoke traced device-sync run on {device}: "
            f"{traced['events']} events, counters reconcile, tokens equal "
            "the untraced run's")
    for batcher in ("dense", "host", "device"):
        if len({str(got[batcher, d]) for d in devices}) != 1:
            raise AssertionError(f"[front-end] smoke {batcher}: card and "
                                 "CPU tokens differ")
    log(f"[front-end] smoke: dense, paged host and device (each preempted "
        f"and resumed) give the sequential reference's tokens on "
        f"{', '.join(devices)}, card equal to CPU")
    return got


def _fused_windows_nested(trace: dict) -> dict:
    """How many ``fused_window`` spans (a window's replay, fenced) lie
    inside a window dispatch span of the same track, and the median
    duration of each kind (ms)."""
    import numpy as np
    open_, spans = {}, {"fused_window": [], "window": []}
    for e in trace["traceEvents"]:
        if e["ph"] not in ("B", "E"):
            continue
        key = (e["tid"], e["name"])
        if e["ph"] == "B":
            open_.setdefault(key, []).append(e["ts"])
            continue
        t0 = open_[key].pop()
        if e["name"] == "fused_window":
            spans["fused_window"].append((e["tid"], t0, e["ts"]))
        elif e["name"] in ("decode_window", "mixed_window"):
            spans["window"].append((e["tid"], t0, e["ts"]))
    inside = sum(any(t == w[0] and w[1] <= b and e <= w[2]
                     for w in spans["window"])
                 for t, b, e in spans["fused_window"])

    def median_ms(xs):
        return float(np.median([e - b for _, b, e in xs])) / 1e3 \
            if xs else 0.0

    return {"windows": len(spans["fused_window"]), "inside": inside,
            "replay_ms": median_ms(spans["fused_window"]),
            "dispatch_ms": median_ms(spans["window"])}


def _f1_open_loop(cfg, params, check, device="cuda") -> dict:
    """Phase F1: AsyncServer over PagedBatcher(hetero-tensor, sync device,
    window 8, width 8, prefix cache) at full width, on a MonotonicClock
    with a live Tracer, 8 requests drawn as serve.py draws them (seed 0,
    lengths 8..300, priority mix 0.5), 16 new tokens each, Poisson at 4
    req/s (arrival seed 0), on a pool of F1_BLOCKS blocks of 32."""
    import numpy as np
    from repro_torch.core.sync import fence
    from repro_torch.launch.serve import draw_workload
    from repro_torch.serving.ingress import (AsyncServer, arrival_times,
                                             open_loop_workload)
    from repro_torch.serving.scheduler import PagedBatcher, Request
    from repro_torch.serving.telemetry import MonotonicClock
    from repro_torch.serving.trace import Tracer, counter_reconciliation

    n, new = 8, 16
    prompts, prios = draw_workload(np.random.default_rng(0), cfg.vocab_size,
                                   n, 300, 0, 0.5)
    clock = MonotonicClock()
    tracer = Tracer(clock)
    cb = PagedBatcher(cfg, params, num_blocks=F1_BLOCKS, block_size=32,
                      max_blocks_per_seq=-(-(300 + new + 8) // 32),
                      decode_width=8, sync="device", window=8,
                      engine_mode="hetero-tensor", prefix_cache=True,
                      tracer=tracer, device=device)
    anchor = cb.kv.pool["k"]
    t0 = time.perf_counter()
    cb.run([Request(rid=100, prompt=prompts[1], max_new_tokens=new)])
    cb.kv._reclaim(cb.kv.allocator.n_cached)        # start cold
    fence(anchor)
    warm_s = time.perf_counter() - t0
    times = arrival_times("poisson", 4.0, n, 0)
    log(f"[front-end] F1 workload: lengths {[len(p) for p in prompts]}, "
        f"priorities {prios}, arrivals (s) {[round(float(t), 3) for t in times]}"
        f", pool {F1_BLOCKS} blocks of 32; warm-up request (captures the "
        f"window) {warm_s:.2f}s")
    server = AsyncServer(cb, clock=clock)
    _zero_counts()
    fence(anchor)
    t0 = clock.now()
    handles = server.run_sync(open_loop_workload(
        prompts, [new] * n, t0 + times, prios))
    fence(anchor)
    wall = clock.now() - t0
    launches = _read_counts()
    for h in handles:
        tr = server.telemetry.traces[h.rid]
        if not h.done or h.terminal_events != 1 or len(h.tokens) != new \
                or tr.n_tokens != new:
            raise AssertionError(f"[front-end] F1 request {h.rid}: "
                                 f"{len(h.tokens)} tokens streamed, "
                                 f"{tr.n_tokens} stamped, done {h.done}")
    cb.kv.assert_drained()
    stats = server.stats()
    mism = counter_reconciliation(tracer, stats)
    trace_path = ROOT / "build" / "front_end_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    tracer.save_chrome(trace_path)
    tracer.save_prometheus(ROOT / "build" / "front_end_metrics.prom")
    trace = json.loads(trace_path.read_text())
    errors = check.validate(trace)
    nested = _fused_windows_nested(trace)
    rows = tracer.drift.report()["rows"]
    sites = {s for (s, _) in cb._plan.decisions}
    rep = server.report()
    log(f"[front-end] F1 open loop: {n * new} tokens in {wall:.3f}s "
        f"({n * new / wall:.2f} tok/s); preemptions {server.preemptions}, "
        f"deferrals {server.deferrals}, ticks {server.ticks}; events "
        f"{tracer.n_events} ({tracer.dropped} dropped), trace "
        f"{trace_path.stat().st_size} bytes; launches {launches}; stats "
        f"{stats}")
    for m in ("ttft_ms", "tpot_ms", "queue_delay_ms"):
        x = rep[m]
        log(f"[front-end] F1 {m}: p50 {x['p50']:.2f}, p95 {x['p95']:.2f}, "
            f"p99 {x['p99']:.2f}, mean {x['mean']:.2f}, max {x['max']:.2f} "
            f"(n={x['n']})")
    log(f"[front-end] F1 goodput {rep['goodput_req_s']:.3f} req/s, "
        f"makespan {rep['makespan_s']:.3f}s, throughput "
        f"{rep['throughput_tok_s']:.2f} tok/s; per request (rid: ttft ms, "
        f"preemptions) " + ", ".join(
            f"{r}: {t.ttft * 1e3:.1f}, {t.preemptions}"
            for r, t in sorted(server.telemetry.traces.items())))
    log(f"[front-end] F1 fused_window spans inside their dispatch spans: "
        f"{nested['inside']} of {nested['windows']}; replay / dispatch span "
        f"median {nested['replay_ms']:.2f} / {nested['dispatch_ms']:.2f} ms")
    log("[front-end] F1 drift table (predicted: the V5E plan's us; "
        "observed: the fenced dispatch time shared by predicted weight)\n"
        + tracer.drift.format_table())
    # the launches are the card's gate: a CPU rehearsal launches no kernel.
    # Whether this wall-clock schedule preempts depends on the card's speed
    # (none in one run of three at 700 W), so the preemption is gated on the
    # virtual-clock run below, whose schedule is the same on every device
    if mism or errors or {r["site"] for r in rows} != sites or \
            nested["windows"] == 0 or \
            nested["inside"] != nested["windows"] or \
            (device == "cuda" and launches["hetero_matmul"] <= 0):
        raise AssertionError(
            f"[front-end] F1: reconciliation {mism}, trace errors "
            f"{errors[:5]}, nesting {nested}, preemptions "
            f"{server.preemptions}, drift sites "
            f"{sorted({r['site'] for r in rows})} of {sorted(sites)}, GEMM "
            f"launches {launches['hetero_matmul']}")
    # the same requests closed loop, none preempted, on the same batcher
    cb.kv._reclaim(cb.kv.allocator.n_cached)
    closed = AsyncServer(cb, clock=clock).run_sync(open_loop_workload(
        prompts, [new] * n, [clock.now()] * n))
    cb.kv.assert_drained()
    same = [sum(a == b for a, b in zip(h.tokens, c.tokens))
            for h, c in zip(handles, closed)]
    log(f"[front-end] F1 tokens equal to a closed-loop unpreempted run, per "
        f"request: {same} of {new} (preempted: "
        f"{[server.telemetry.traces[r].preemptions for r in range(n)]})")
    forced = _f1_forced_preemption(cb, prompts, prios, new, closed)
    return {"launches": launches, "wall_s": wall, "report": rep,
            "preemptions": server.preemptions, "drift": rows,
            "agreement": same, "events": tracer.n_events,
            "forced_preemptions": forced}


def _f1_forced_preemption(cb, prompts, prios, new, closed) -> int:
    """F1's preemption gate: the same requests on the same batcher, on a
    FakeClock charging 0.1 s a tick, the low-priority ones arriving at 0
    and the high-priority ones at 0.05 s. The first tick admits the low
    requests that fit the pool (lengths 44, 37 and 193: 11 of its 11 usable
    blocks), so the 256-token high-priority arrival is blocked at the
    second tick and evicts the youngest low lane, whatever the card's
    speed. Gates: a preemption, every stream complete, no leaked block.
    Returns the preemption count."""
    from repro_torch.serving.ingress import AsyncServer, open_loop_workload
    from repro_torch.serving.telemetry import FakeClock

    cb.kv._reclaim(cb.kv.allocator.n_cached)
    times = [0.05 * p for p in prios]
    server = AsyncServer(cb, clock=FakeClock(), step_time_s=0.1)
    handles = server.run_sync(open_loop_workload(
        prompts, [new] * len(prompts), times, prios))
    cb.kv.assert_drained()
    # handles come in arrival order (a stable sort by time)
    order = sorted(range(len(prompts)), key=lambda i: times[i])
    same = [sum(a == b for a, b in zip(h.tokens, closed[i].tokens))
            for h, i in zip(handles, order)]
    log(f"[front-end] F1 forced preemption (FakeClock, 0.1 s a tick, low "
        f"priorities at 0 s, high at 0.05 s): preemptions "
        f"{server.preemptions}, deferrals {server.deferrals}, ticks "
        f"{server.ticks}; tokens equal to the closed-loop run, per request: "
        f"{same} of {new} in arrival order {order} (preempted: "
        f"{[server.telemetry.traces[h.rid].preemptions for h in handles]})")
    if server.preemptions < 1 or any(
            not h.done or len(h.tokens) != new for h in handles):
        raise AssertionError(
            f"[front-end] F1 forced: preemptions {server.preemptions}, "
            f"streams {[len(h.tokens) for h in handles]}")
    return server.preemptions


def _f2_dense(cfg, params, full, device="cuda") -> dict:
    """Phase F2: ContinuousBatcher(max_batch=4) at full width on phase 4's
    prompts, 16 new tokens each, closed loop through AsyncServer on a
    MonotonicClock; its first-token logits held to the paged engine-less
    fp arm's (cosine >= 0.999)."""
    import dataclasses
    import torch
    from repro_torch.core.sync import fence
    from repro_torch.serving.ingress import AsyncServer, open_loop_workload
    from repro_torch.serving.scheduler import ContinuousBatcher
    from repro_torch.serving.telemetry import MonotonicClock

    prompts, new = full["fp"]["prompts"], 16
    cb = ContinuousBatcher(cfg, params, max_batch=4, max_len=300 + new + 8,
                           device=device)
    anchor = cb.cache["k"]
    rec = {"prefill": 0.0, "decode": 0.0, "first": []}
    model = cb.model

    def timed(fn, key):
        def run(*a, **k):
            fence(anchor)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            fence(anchor)
            rec[key] += time.perf_counter() - t0
            return out
        return run

    prefill = timed(model.prefill_slot, "prefill")

    def prefill_slot(params, cache, tokens, slot, start):
        logits, cache = prefill(params, cache, tokens, slot, start)
        if start == 0:                    # admissions go in rid order here
            rec["first"].append(None)
        rec["first"][-1] = logits[0, -1].float()
        return logits, cache

    cb.model = dataclasses.replace(
        model, prefill_slot=prefill_slot,
        decode_step=timed(model.decode_step, "decode"))
    clock = MonotonicClock()
    server = AsyncServer(cb, clock=clock)
    _zero_counts()
    fence(anchor)
    t0 = clock.now()
    handles = server.run_sync(open_loop_workload(
        prompts, [new] * len(prompts), [t0] * len(prompts)))
    fence(anchor)
    wall = clock.now() - t0
    launches = _read_counts()
    tok = sum(len(h.tokens) for h in handles)
    if any(len(h.tokens) != new for h in handles):
        raise AssertionError(f"[front-end] F2: streams "
                             f"{[len(h.tokens) for h in handles]}")
    plain = full["fp"]["plain_first_logits"]
    cos = []
    for rid, a in enumerate(rec["first"]):
        b = plain[rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"[front-end] F2 request {rid}: non-finite")
        cos.append(float(torch.nn.functional.cosine_similarity(a, b, dim=0)))
    same = sum(x == y for h, o in zip(handles, full["fp"]["plain_outputs"])
               for x, y in zip(h.tokens, o))
    log(f"[front-end] F2 dense: {tok} tokens in {wall:.3f}s "
        f"({tok / wall:.2f} tok/s); prefill {rec['prefill']:.3f}s, decode "
        f"{rec['decode']:.3f}s; stats {server.stats()}; launches {launches};"
        f" first-token cos vs the paged engine-less arm "
        f"{[round(c, 6) for c in cos]}; tokens equal to its {same}/{tok}")
    if len(cos) != len(prompts) or min(cos) < 0.999 or \
            (device == "cuda" and (launches["flash_attention"] <= 0
                                   or launches["decode_attention"] <= 0)):
        raise AssertionError(f"[front-end] F2: cosines {cos}, launches "
                             f"{launches}")
    return {"launches": launches, "tok_per_s": tok / wall, "wall_s": wall,
            "prefill_s": rec["prefill"], "decode_s": rec["decode"],
            "cos": cos}


def phase_front_end(cfg, params, full, device="cuda") -> dict:
    """Phase F: the serving front end (the dense batcher, the open-loop
    ingress, telemetry and the tracer). F0 on the fp32 smoke models (card
    and CPU), then F1 and F2 on the llama3-8b weights at full width.
    Returns {"F1": ..., "F2": ...}, each with its launches per kernel."""
    t0 = time.perf_counter()
    _front_end_smoke(("cuda", "cpu") if device == "cuda" else ("cpu",))
    log(f"[time] front end F0: {time.perf_counter() - t0:.1f}s")
    out = {}
    for name, run in (("F1", lambda: _f1_open_loop(cfg, params,
                                                   _check_trace(), device)),
                      ("F2", lambda: _f2_dense(cfg, params, full, device))):
        t0 = time.perf_counter()
        out[name] = run()
        gc.collect()
        log(f"[time] front end {name}: {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ phase G --

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _family_paged_smoke(arch: str) -> None:
    """The fp32 smoke model of ``arch`` through PagedBatcher (hetero-tensor)
    on the card with sync device (window 4) and host, and on the CPU: the
    same greedy tokens in every arm, each card arm holding one captured
    graph replayed once per decode dispatch, every block back."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch).with_(**FP32)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(7), device="cuda")
    cpu_params = _to_device(params, "cpu")
    prompts = _smoke_prompts(cfg.vocab_size)
    outputs = {}
    for device, sync in (("cuda", "device"), ("cuda", "host"),
                         ("cpu", "device")):
        cb, reqs = _serve(cfg, params if device == "cuda" else cpu_params,
                          prompts, device=device, engine_mode="hetero-tensor",
                          sync=sync, window=4, decode_width=4, new_tokens=12)
        _zero_counts()
        cb.run(reqs)
        counts = _read_counts()
        cb.kv.assert_drained()
        graphs = cb.graph_stats()
        arm = f"{arch}/{device}/{sync}"
        outputs[arm] = [r.output for r in reqs]
        log(f"[families] G0 paged {arm}: {cb.stats()} graphs {graphs} "
            f"launches {counts}")
        want = ((1, cb.decode_dispatches) if device == "cuda" else (0, 0))
        if (graphs["graphs"], graphs["replays"]) != want:
            raise AssertionError(f"[families] G0 paged {arm}: graphs "
                                 f"{graphs}, expected {want}")
        del cb
    first = next(iter(outputs.values()))
    for arm, out in outputs.items():
        if out != first or any(len(o) != 12 for o in out):
            raise AssertionError(f"[families] G0 paged {arm} differs: {out}"
                                 f" vs {first}")
    log(f"[families] G0 paged {arch}: {len(outputs)} arms token-identical; "
        f"request 0: {first[0]}")


def _encoder_smoke() -> None:
    """The fp32 hubert smoke model's ``encode`` of seeded frame embeddings
    on the card (bidirectional flash 2.4, one launch a layer) within fp32
    DTYPE_TOL of the CPU's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("hubert-xlarge").with_(**FP32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(7),
                        device="cuda")
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    _zero_counts()
    got = model.encode(params, frames.cuda())
    torch.cuda.synchronize()
    counts = _read_counts()
    want = model.encode(_to_device(params, "cpu"), frames)
    e = rel_err(got.cpu(), want)
    log(f"[families] G0 encode hubert smoke: rel_err {e:.3g} vs the CPU "
        f"(<= {DTYPE_TOL['float32']}); launches {counts}")
    if not e <= DTYPE_TOL["float32"] or \
            counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"[families] G0 encode: rel_err {e:.3g}, "
                             f"launches {counts}")


def _families_line(cell: str, arm: dict) -> None:
    """One full-width arm's numbers on a ``[families]`` line; a decode
    step's time over ``decode_steps`` (a batcher's window steps) or, for
    an engine, its tokens less the first."""
    steps = arm.get("decode_steps") or (len(arm["tokens"]) - 1
                                        if "tokens" in arm else None)
    per_step = (arm["decode_s"] / steps * 1e3) if steps else None
    arm["decode_ms_per_step"] = per_step
    graphs = arm.get("graphs") or {}
    prof = arm.get("profile") or {}
    log(f"[families] {cell}: {arm['tok_per_s']:.2f} tok/s, prefill "
        f"{arm['prefill_s']:.3f}s, decode {arm['decode_s']:.3f}s"
        + (f" ({per_step:.2f} ms a step)" if per_step else "")
        + f", peak {arm['peak_mem_gb']:.2f} GB, graphs {graphs}"
        + (f", pool {arm['pool_bytes'] / 1e9:.3f} GB" if "pool_bytes" in arm
           else "")
        + (f", busy {prof['share']:.3f}" if prof.get("share") else "")
        + f", launches {arm['launches']}")


def phase_moe_full(cfg, params, prompt_len: int = 300,
                   new_tokens: int = 16) -> dict:
    """G1: qwen2-moe-a2.7b at full width. PagedBatcher (hetero-tensor,
    sync device, window 8, width 8, block 32) on phase 4's seeded prompts
    against the engine_mode=None arm, whose timed run's routing it replays
    (``RouteTape``): first-token cosine >= 0.99 (the cosine with free
    routing, from the first runs, is logged beside), GEMM 2.1 launched;
    then the engine (prompt 300, hetero-tensor and xla, fast
    sync; flash 2.4 and decode 2.5 launched as the chunks predict, the
    hetero arm profiled), ``attention_gate`` on this model, and the
    captured engine loop against an eager one (tokens equal)."""
    import torch

    prompts = full_prompts(cfg, prompt_len)
    log(f"[families] G1 prompt lengths {[len(p) for p in prompts]}, "
        f"{new_tokens} new tokens each")
    tape = RouteTape()
    base, het = (_paged_arm(cfg, params, prompts, new_tokens,
                            label=f"{cfg.name} fp", mode=mode,
                            weight_quant=None, kv_quant=None, pin=pin)
                 for mode, pin in ((None, tape.record()),
                                   ("hetero-tensor", tape.replay())))
    log(f"[families] G1 paged routing, hetero-tensor pinned to "
        f"engine=None: {tape.flips()}")
    if het["gemm_launches"] <= 0:
        raise AssertionError("[families] G1: the hetero-tensor arm never "
                             "launched GEMM 2.1")
    for rid in range(len(prompts)):
        a, b = het["first_logits"][rid], base["first_logits"][rid]
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        free = float(torch.nn.functional.cosine_similarity(
            het["free_first_logits"][rid], base["free_first_logits"][rid],
            dim=0))
        het.setdefault("free_cos", []).append(free)
        het.setdefault("pinned_cos", []).append(cos)
        log(f"[families] G1 paged request {rid}: first-token logits cos "
            f"{cos:.6f} vs engine=None with its routing, rel_err "
            f"{rel_err(a, b):.3g}; with free routing cos {free:.6f}")
        if not (torch.isfinite(a).all() and cos >= 0.99):
            raise AssertionError(f"[families] G1 request {rid}: cosine "
                                 f"{cos:.4f} < 0.99 or non-finite")
    for label, arm in (("hetero-tensor", het), ("engine=None", base)):
        # each window replays its 8 steps, whichever lanes are active
        arm["decode_steps"] = 8 * arm["stats"]["decode_dispatches"]
        _families_line(f"G1 {cfg.name} paged {label}", arm)
    engine = phase_engine_full(cfg, params, None, prompt_len=prompt_len,
                               new_tokens=new_tokens,
                               arms=(("hetero-tensor", True), ("xla", True)),
                               seed=4, gates=(attention_gate,))
    graphs = phase_graph_decode(cfg, params, None, engine)
    for label, arm in engine.items():
        _families_line(f"G1 {cfg.name} engine {label}", arm)
    return {"paged": het, "paged_plain": base, "engine": engine,
            "graphs": graphs}


def phase_rwkv_full(cfg, params, prompt_len: int = 600,
                    new_tokens: int = 16, seed: int = 6) -> dict:
    """G2: rwkv6-3b at full width through the engine (prompt 600: chunks
    512 and 88; hetero-tensor, which RWKV ignores; fast sync): the timed
    generate on the reused cache gives the first one's tokens (each prefill
    from position 0 starts from zero states), and the captured decode loop
    the eager one's. No kernel of the port is on this path."""
    import numpy as np

    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (1, prompt_len))
    cap = _engine_arm(cfg, params, prompt, new_tokens, mode="hetero-tensor",
                      fast=True, label="hetero-tensor/fast", strict=True,
                      profile=True)
    if cap["tokens"] != cap["first_tokens"]:
        raise AssertionError(f"[families] G2: the reused cache's tokens "
                             f"{cap['tokens']} differ from the first "
                             f"generate's {cap['first_tokens']}")
    with _eager_loops():
        eager = _engine_arm(cfg, params, prompt, new_tokens,
                            mode="hetero-tensor", fast=True,
                            label="hetero-tensor/fast eager", profile=True)
    row = _pair_line(f"engine {cfg.name}", cap, eager)
    if any(cap["launches"].values()):
        raise AssertionError(f"[families] G2: a kernel launched on the RWKV "
                             f"path: {cap['launches']}")
    _families_line(f"G2 {cfg.name} engine captured", cap)
    _families_line(f"G2 {cfg.name} engine eager", eager)
    log(f"[families] G2 {cfg.name}: a second generate on the reused cache "
        f"and the eager loop give the first generate's tokens "
        f"{cap['tokens']}")
    return {"engine": cap, "eager": eager, "graphs": row}


def phase_encoder_full(cfg, params, n_frames: int = 1500,
                       seed: int = 9) -> dict:
    """G3: hubert-xlarge at full width: ``encode`` of 1 x 1500 seeded frame
    embeddings (30 s of audio at 50 Hz), timed, flash 2.4 launched once a
    layer (bidirectional, D = 80); then the same run with the plain
    attention in its place: hidden states at cosine >= 0.999."""
    import torch
    from repro_torch.core.sync import fence
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model, layers

    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn((1, n_frames, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)

    def run():
        return model.encode(params, frames)

    fence(run())
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = fence(run())
    wall = time.perf_counter() - t0
    counts = _read_counts()
    ms = cuda_time_ms(run, iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profiled(f"encode {cfg.name}", run, frames)
    inner = layers.flash_attention
    layers.flash_attention = attention_ref
    try:
        _zero_counts()
        plain = fence(run())
        plain_counts = _read_counts()
        plain_ms = cuda_time_ms(run, iters=3, warmup=0)
    finally:
        layers.flash_attention = inner
    a, b = out.float().reshape(-1), plain.float().reshape(-1)
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    res = {"shape": list(out.shape), "wall_s": wall, "ms": ms,
           "plain_ms": plain_ms, "peak_mem_gb": peak, "launches": counts,
           "busy_share": prof.get("share"), "cos": cos,
           "rel_err": rel_err(a, b)}
    log(f"[families] G3 {cfg.name} encode {tuple(out.shape)}: {ms:.2f} ms "
        f"(events, 5 runs; first timed run {wall * 1e3:.1f} ms wall), "
        f"with the plain attention {plain_ms:.2f} ms; peak {peak:.2f} GB; "
        f"busy {res['busy_share']}; launches {counts}; kernels vs plain: "
        f"cos {cos:.6f}, rel_err {res['rel_err']:.4g}")
    if out.shape != (1, n_frames, cfg.d_model) or not torch.isfinite(a).all():
        raise AssertionError(f"[families] G3: output {tuple(out.shape)} or "
                             "non-finite hidden states")
    if counts["flash_attention"] != cfg.n_layers or \
            plain_counts["flash_attention"] or cos < ATTENTION_GATE_COS:
        raise AssertionError(f"[families] G3: launches {counts} / "
                             f"{plain_counts}, cosine {cos:.6f} < "
                             f"{ATTENTION_GATE_COS}")
    return res


def phase_families() -> dict:
    """Phase G: the MoE, RWKV6 and encoder-only families. G0 on the fp32
    smoke models (card against CPU), then G1-G3 at full width, each
    model's weights freed before the next is made."""
    import torch

    for arch in ("qwen2-moe-a2.7b", "dbrx-132b", "chameleon-34b"):
        _family_paged_smoke(arch)
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b", "rwkv6-3b"):
        phase_engine_tokens(arch, modes=("hetero-tensor",))
    _encoder_smoke()
    out = {}
    for key, arch, phase in (("G1", "qwen2-moe-a2.7b", phase_moe_full),
                             ("G2", "rwkv6-3b", phase_rwkv_full),
                             ("G3", "hubert-xlarge", phase_encoder_full)):
        t0 = time.perf_counter()
        cfg, params = full_width_model(arch, "families")
        out[key] = phase(cfg, params)
        del cfg, params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] phase G {key} {arch}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _time_captures()
    t_start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        what = f" {args[0]}" if args and isinstance(args[0], str) else ""
        log(f"[time] {phase.__name__}{what}: "
            f"{time.perf_counter() - t0:.1f}s")
        return out

    card = timed(phase_card_and_build)
    kern = timed(phase_kernels)
    qkern = timed(phase_quant_kernels)
    attn = timed(phase_attention_kernels)
    ssd = timed(phase_ssd_kernel)
    timed(phase_characterize)
    timed(phase_tokens)
    timed(phase_engine_tokens, "llama3-8b")
    timed(phase_engine_tokens, "zamba2-2.7b")
    timed(phase_two_streams_smoke)
    tables = timed(phase_profile)
    cfg, params = full_model()
    full = timed(phase_full, cfg, params, tables)
    engine = timed(phase_engine_full, cfg, params,
                   tables[("llama3-8b", None)])
    graphs = timed(phase_graph_decode, cfg, params, full, engine)
    streams = timed(phase_two_streams, cfg, params)
    arms = timed(phase_serving_arms, cfg, params, full)
    front = timed(phase_front_end, cfg, params, full)
    del cfg, params                  # the llama3 weights leave the card
    gc.collect()                     # (each graph went with its owner)
    torch.cuda.empty_cache()
    hcfg, hparams = hybrid_model()
    hybrid = timed(phase_engine_hybrid, hcfg, hparams,
                   tables[("zamba2-2.7b", None)])
    graphs.update(timed(phase_graph_decode, hcfg, hparams, None, hybrid))
    del hcfg, hparams                # the zamba2 weights leave the card
    gc.collect()
    torch.cuda.empty_cache()
    families = timed(phase_families)
    training = timed(phase_training)

    def arms_launches(name):
        """The kernel's launches on each serving arm's timed pass (phase
        E), on phase F's open-loop and dense runs, and on phase G's
        qwen2-moe paged and engine arms and hubert's encode, where it
        launched there."""
        got = {arm: arms[arm]["launches"][name]
               for arm in ("mixed", "spec", "prefix")
               if arms[arm]["launches"][name]}
        out = {"serving_arms_launches": got} if got else {}
        got = {ph: front[ph]["launches"][name] for ph in ("F1", "F2")
               if front[ph]["launches"][name]}
        out = {**out, "front_end_launches": got} if got else out
        got = {"G1 paged": families["G1"]["paged"]["launches"][name],
               "G1 engine": families["G1"]["engine"]["hetero-tensor/fast"][
                   "launches"][name],
               "G3 encode": families["G3"]["launches"][name]}
        got = {k: n for k, n in got.items() if n}
        return {**out, "families_launches": got} if got else out

    def entry(name, source, replaces, row, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "shape": [row["M"], row["K"], row["N"]],
                "dtype": row["dtype"], **arms_launches(name),
                **{k: row[k] for k in ("device_ms", "plan_bn", "plan_split",
                                       "matmul_bf16_device_ms",
                                       "library_device_ms") if k in row}}

    def wgate(rows):
        return next(r for r in rows if r["case"] == "path_wgate_m256")

    def path_entry(name, source, replaces, row, arms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": arms["hetero-tensor/fast"]["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"],
                "dtype": row["dtype"], **arms_launches(name),
                **{k: row[k] for k in ("device_ms", "library_device_ms",
                                       "n_split", "split_1_device_ms",
                                       "split_max", "split_max_device_ms",
                                       "bound_split_tf32_ms",
                                       "bound_split_tf32_by")
                   if k in row}}

    flash_row, decode_row = attn["timings"][0], attn["timings"][2]
    hubert_row = attn["timings"][-1]

    kernels = {"kernels": [
        entry("hetero_matmul", "src/repro_torch/csrc/hetero_matmul.cu",
              "src/repro/kernels/hetero_matmul/kernel.py:78",
              wgate(kern["timings"]), full["fp"]["gemm_launches"]),
        entry("quant_matmul_int8", "src/repro_torch/csrc/quant_matmul.cu",
              "src/repro/kernels/hetero_matmul/kernel.py:173",
              wgate(qkern["timings"]["int8"]),
              full["int8+kv8"]["gemm_launches"]),
        entry("quant_matmul_q4", "src/repro_torch/csrc/quant_matmul.cu",
              "src/repro/kernels/hetero_matmul/kernel.py:146",
              wgate(qkern["timings"]["w4a16"]),
              full["w4a16"]["gemm_launches"]),
        path_entry("flash_attention",
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:73",
                   flash_row, engine),
        path_entry("decode_attention",
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:59",
                   decode_row, engine),
        path_entry("ssd_chunk", "src/repro_torch/csrc/ssd_chunk.cu",
                   "src/repro/kernels/ssm_scan/kernel.py:50",
                   ssd["timings"][0], hybrid),
    ]}
    bwd = training["H0"]["path"]
    kernels["kernels"][3]["training_launches"] = training["H2"][
        "launches"]["flash_attention"]
    kernels["kernels"].append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none: not a TPU kernel (the reference's training "
                    "differentiates src/repro/models/layers.py:75 "
                    "blockwise_attention with JAX autodiff)",
        "tpu_kernel": False,
        "launches": training["H2"]["launches"]["flash_attention_bwd"],
        **{k: bwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "shape", "dtype",
                               "library_note")},
        "kernel_ms": bwd["ms"],
        "device_ms": training["H2"]["bwd_step_device_ms"]})
    kernels["kernels"][3]["encoder_row"] = {
        k: hubert_row[k] for k in ("shape", "causal", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms",
                                   "max_abs_err", "rel_err")}
    for k in kernels["kernels"]:
        if k["name"] in ("hetero_matmul", "flash_attention",
                         "decode_attention") \
                and not k.get("families_launches"):
            raise AssertionError(f"{k['name']} never launched on phase G")
    if any(k["launches"] <= 0 for k in kernels["kernels"]):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{[(k['name'], k['launches']) for k in kernels['kernels']]}")
    log(f"[summary] card {card}; tok/s "
        + ", ".join(f"{k} {v['tok_per_s']:.2f}" for k, v in full.items())
        + "; engine tok/s "
        + ", ".join(f"{k} {v['tok_per_s']:.2f}" for k, v in engine.items())
        + "; zamba2 engine tok/s "
        + ", ".join(f"{k} {v['tok_per_s']:.2f}" for k, v in hybrid.items())
        + "; captured / eager tok/s "
        + ", ".join(f"{k} {v['captured']['tok_per_s']:.2f} / "
                    f"{v['eager']['tok_per_s']:.2f}"
                    for k, v in graphs.items())
        + "; measured plan tok/s paged "
        + ", ".join(f"{k} {v['measured']['tok_per_s']:.2f}"
                    for k, v in full.items())
        + "; two streams: overlap eager prefill "
        + f"{streams['two streams']['trace']['overlap_fraction']:.3f}, "
        + "captured decode step "
        + f"{streams['two streams']['step_trace']['overlap_fraction']:.3f}, "
        + "prefill s two / one "
        + f"{streams['two streams']['prefill_s']:.4f} / "
        + f"{streams['one stream']['prefill_s']:.4f}"
        + "; serving arms tok/s mixed "
        + f"{arms['mixed']['waves'][0]['tok_per_s']:.2f}, spec "
        + f"{arms['spec']['waves'][0]['tok_per_s']:.2f} (acceptance "
        + f"{arms['spec']['stats']['acceptance_rate']:.3f}), prefix wave "
        + "1 / 2 " + " / ".join(f"{w['tok_per_s']:.2f}"
                               for w in arms['prefix']['waves'])
        + f"; front end: open loop {front['F1']['wall_s']:.3f}s, "
        + f"{front['F1']['preemptions']} preemptions (forced run "
        + f"{front['F1']['forced_preemptions']}), TTFT p50 "
        + f"{front['F1']['report']['ttft_ms']['p50']:.1f} ms; dense "
        + f"{front['F2']['tok_per_s']:.2f} tok/s"
        + "; families: qwen2-moe paged "
        + f"{families['G1']['paged']['tok_per_s']:.2f} tok/s, engine "
        + ", ".join(f"{k} {v['tok_per_s']:.2f}"
                    for k, v in families["G1"]["engine"].items())
        + f" tok/s; rwkv6 engine {families['G2']['engine']['tok_per_s']:.2f}"
        + f" tok/s; hubert encode {families['G3']['ms']:.2f} ms"
        + f"; training qwen3-1.7b step {training['H2']['mean_step_s']:.4f}s"
        + f" ({training['H2']['tokens_per_s']:.0f} tok/s, model-FLOP share "
        + f"{training['H2']['model_flop_share']:.4f}, peak "
        + f"{training['H2']['peak_gb']:.2f} GB), backward kernel "
        + f"{training['H2']['bwd_step_device_ms']:.3f} ms device a call"
        + f"; total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
