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
  L. the port's linter (``repro_torch.analysis``, what
     ``scripts/repolint_torch.py --check`` runs) over this checkout, its
     summary on a ``[lint]`` line: a new finding or a stale baseline entry
     fails;
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
     this model, and its engine's ``phase_graph_decode`` pair. Prefill and
     verify are CUDA graphs too, one per chunk length (M2b):
     ``phase_graph_prefill``, after each model's ``phase_graph_decode``,
     holds every replay bitwise to the model's own entry point run eagerly
     on a copy of the pool or cache (logits, and the pool or cache after):
     llama3-8b paged (fp, int8 + int8 KV, W4A16: the V5E hetero-tensor
     arms of phase 4, their prompts again in reverse order so the chunk
     lengths replay in another order than their capture's, tokens equal,
     then prefill-only runs alternating captured and eager), the spec arm
     (self-draft, k = 4: every verify round and its acceptance, and the
     draft lanes' prefill chunks), the same arm under host sync (every
     draft-lane prefill chunk and step replay held to ``prefill_slot`` /
     ``decode_step`` on a copy of the draft cache, tokens equal; the draft
     lanes' prefill and rounds timed alternating captured and eager, and
     a round's acceptance as a captured call against the eager
     ``greedy_verify``; ``[graph-dense]`` line), the engine on prompts 428
     and 300 over one cache (the 44-token chunk's graph replays at starts
     384 and 256; no host sync in a replay; ``n_compiles`` = chunk lengths
     + decode graphs; eager prefill's tokens; timed alternating), and
     zamba2-2.7b's engine on prompt 600 (the SSD chunk kernel and the flash
     kernel's device-start entry replayed). Phase 2 holds that entry
     bitwise to the host-start launch and within DTYPE_TOL of its plain
     version over the conformance grid and at the engine's shapes.

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
     smoke model on the card and the CPU: the dense ContinuousBatcher (fp,
     int8 and W4A16 weights), and
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
     loop through AsyncServer, its prefill pieces (one graph per chunk
     length, every slot and start) and its decode step captured (M2c):
     a first run captures, a second holds every replay bitwise to
     ``prefill_slot`` / ``decode_step`` run eagerly on a copy of the cache,
     then runs alternating captured, eager, eager, captured with equal
     tokens; first-token cosine >= 0.999 against phase 4's engine-less fp
     arm, kernels 2.4 and 2.5 launched (through replays). (``[front-end]``
     and ``[graph-dense]`` lines.)

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
     the flash kernel's backward (``csrc/flash_attention_bwd.cu``) and the
     SSD chunk kernel's (the ``ssd_chunk_bwd`` entry of
     ``csrc/ssd_chunk.cu``). H0 the flash backward against
     ``attention_bwd_ref`` on the card in fp32, bf16 and fp16 over the
     attention conformance grid, hubert's smoke shape with D = 80
     (bidirectional), qwen3-1.7b's path shape [2, 4096, 16 / 8, 128]
     causal in fp32 and bf16 (fp32 held to the plain version carried in
     fp64) and zamba2-2.7b's [2, 4096, 32 / 32, 80] causal in bf16, the
     forward's log-sum-exp against ``lse_ref``, two launches bitwise
     equal, both bf16 path shapes timed against the plain version and
     SDPA's backward; then the SSD backward against ``ssd_chunk_bwd_ref``
     carried in fp64 (``phase_ssd_bwd``: L 1 / 17 / 88 / 256, nh 1 / 3 /
     80, hd = N 16 / 64, zero and random S_prev, strided operands, decays
     whose upper exponents overflow; 1e-4 on every output, two launches
     bitwise equal; the path shape [2, 256, 80, 64, 64] timed beside its
     bounds and the plain version). H1 the seven fp32 smoke models' loss
     and gradients on the card against the CPU (the five transformers,
     zamba2 and rwkv6; launches as ``train_launches`` counts them) and
     ``train()``s of the smollm and zamba2 smoke models crashed at step 7
     with save_every=5 ending at the uninterrupted losses. H2 qwen3-1.7b,
     H3 zamba2-2.7b and H4 rwkv6-3b at full width (bf16, fp32 AdamW
     moments, remat per layer or period, seq 4096 x batch 2): for H2 and
     H3 step 1's loss and gradients through the kernels against their
     plain versions under autograd (H2 in bf16: loss 1e-3 relative, cosine
     >= 0.999 a leaf; H3 on the same model in fp32, loss 1e-5, cosine >=
     0.99999: in bf16 its gradient's floor under any perturbation is near
     0.9985), then 1 warm-up and 4 timed steps (H4: 1) (step time,
     tokens/s, model-FLOP share, peak memory, the kernels' launches equal
     to ``train_launches``) and, for H2 and H3, a profiled step (busy
     share, device time a call of each backward). (``[train]`` lines.)

  T. (after F, the llama3 weights still on the card; T2 after they are
     freed) ``phase_tp`` and ``phase_tp_gloo``: tensor-parallel paged
     serving (``serving/layout.py``). This process joins a one-rank NCCL
     group. T0, the fp32 llama3 smoke model with TF32 off, on the eight
     arms of the reference's ``tests/test_tp_serving.py`` (host, device
     window 3, mixed, prefix, spec self k = 2, W4A16 + int8 KV, int8
     weights, int8 KV): ``DeviceLayout`` on the card, ``MeshLayout`` over
     the one-rank NCCL group on the card (its loops captured with the
     collectives inside) and TP = 2 over two gloo CPU ranks give the same
     tokens, pools drained, ``stats()["tp"]`` right. T1, llama3-8b at full
     width and depth (bf16, phase 4's prompts, 16 new tokens, block 32,
     width 8, window 8): ``DeviceLayout`` against the one-rank NCCL
     ``MeshLayout`` on the fp window, the host tick, mixed and W4A16 +
     int8 KV: tokens bitwise equal; tok/s, prefill and decode s of both in
     the order device, mesh, mesh, device; graphs, capture s, pool bytes,
     peak memory. T3, split-KV decode over the group at llama3's decode
     shape ([8, 4096, 8, 128] bf16, positions 0, 1, 1234, 4095) against
     the plain decode and kernel 2.5 within DTYPE_TOL, cache writes
     bitwise, timed; ``compressed_psum`` on the group equal to its
     arithmetic on the CPU. The group is left. T2, llama3-8b at full width
     at TP = 2 as two processes sharing the card over gloo (eager: gloo's
     collectives are not captured), host tick and device window, each rank
     building the seeded full model and keeping its slices: first-token
     cosine >= 0.999 against T1's ``DeviceLayout``, the two ranks' streams
     equal, tokens compared with T1's (where a stream first differs, T1's
     top-2 logit margin there must be within 4 bf16 ulps of its top
     logit: A2's one-ulp column-split rounding compounded over 32 layers;
     ``_tp_token_gate``), and the fp32 smoke model's host and device arms
     equal T0's tokens. Its times are the gloo transport's. (``[tp]``
     lines.) No port kernel lies on this path (TP excludes
     ``engine_mode``; the pool's attention is plain torch): the kernels'
     launches on the earlier paths are unchanged.

  P. (after T2) ``phase_pipeline``: llama3-8b at full width and depth,
     bf16, through ``distributed/pipeline.py``'s ``make_pipeline_forward``
     as two stages of 16 layers in two gloo processes sharing the card
     (each builds the seeded model, keeps its stage and frees the rest),
     4 microbatches of 1 x 1024 tokens (a causal prefill, no cache); this
     process then runs the 32 layers serially on the same microbatches.
     Both ranks' outputs bitwise equal to the serial forward, flash
     attention launched 64 times on each; tick times and the measured
     bubble beside ``pipeline_stats(4, 2)``'s 0.2. (``[pipeline]``
     lines.)

  R. ``phase_dryrun_serve`` (right after T, the llama3 weights still on
     the card: T4's prefill, 8 x 1024 into 4096, KV "head") and
     ``phase_dryrun_train`` (phase H, after H5: qwen3-1.7b's train step at
     4096 x 2): ``launch/dryrun.py``'s trace of the step on fake CUDA
     tensors over a one-rank fake process group against the same step on
     the card under the same count (``roofline/count.py``): FLOPs and
     bytes accessed equal exactly, calls per kernel operator equal the
     wrappers' launches (flash attention, and its backward in the train
     cell, nonzero), the predicted per-rank peak within 25 % of the
     card's; ``roofline/analysis.py``'s H100 bound beside the measured
     step time. (``[dryrun]`` lines.)

The line before the last is the kernels JSON line (each kernel launched
on a phase E arm also carries ``serving_arms_launches``, on phase F's
F1 / F2 ``front_end_launches``, and on phase G's G1 / G3
``families_launches``; the flash entry carries hubert's row as
``encoder_row``; the flash and SSD entries carry their launches in H2's
and H3's timed steps as ``training_launches``; the flash entry its
launches on each pipeline rank as ``pipeline_launches``, the flash and
flash backward entries their launches in phase R's steps as
``dryrun_launches``; the seventh row is the
flash backward, the eighth the SSD backward, neither a TPU kernel, their
launches H2's and H3's); the last line is ``{"ok": true, "device":
{...}}``.
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
from functools import partial
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
# ssd_cb_tc and ssd_chunk_tc, the flash backward's two wgmma kernels and
# the SSD backward's ssd_bwd_tc) and split-KV decode attention
SPILL_FREE = ("gemm_tc", "flash_tc", "decode_split", "decode_combine",
              "ssd_cb_tc", "ssd_chunk_tc", "flash_bwd_dkdv_wg",
              "flash_bwd_dq_wg", "ssd_bwd_tc")


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


def phase_lint(card: str) -> dict:
    """Phase L: the port's linter (``scripts/repolint_torch.py --check``'s
    rules, ``repro_torch.analysis``) over the checkout this script sits in.
    Raises on any finding the baseline does not cover and on any stale
    baseline entry: a checkout that breaks the port's disciplines (a CUDA
    graph's outputs copied before the next replay, loops captured once per
    key, no host pull in a captured body, ``fence`` the one sync site)
    stops here, before the card runs it."""
    from repro_torch.analysis.core import run_repolint
    t0 = time.perf_counter()
    report = run_repolint(ROOT)
    seconds = time.perf_counter() - t0
    for f in report.new:
        log(f"[lint] {f.render()}")
    for fp in report.stale:
        log(f"[lint] stale baseline entry (no longer fires): {fp}")
    log(f"[lint] {report.summary()}; {seconds:.1f}s on the host ({card})")
    if not report.ok:
        raise AssertionError(f"repolint-torch: {len(report.new)} new "
                             f"finding(s), {len(report.stale)} stale "
                             f"baseline entries")
    return {"files": report.n_files, "findings": len(report.findings),
            "suppressed": report.suppressed, "s": seconds}


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
    from repro_torch.kernels import work
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
        row.update(work.bound(*work.gemm(M, K, N, 2), "bfloat16"))
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
    from repro_torch.kernels import work
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
            row.update(work.bound(*work.quant_gemm(
                M, K, N, 2, 1.0 if fmt == "int8" else 0.5), "bfloat16"))
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
    from repro_torch.kernels import work
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = k.shape[2]
    if kind == "flash":
        Sq, Sk = q.shape[1], k.shape[1]
        run = lambda: flash_attention(q, k, v, causal=causal)    # noqa: E731
        plain = lambda: attention_ref(q, k, v, causal=causal)    # noqa: E731
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
    row.update(work.bound(*(
        work.flash(B, Sq, Sk, Hq, Hkv, D, el, causal) if kind == "flash"
        else work.decode(B, Hq, Hkv, D, length, el)), row["dtype"]))
    return row


def _flash_at_timing(q, k, v, start: int) -> dict:
    """The flash kernel's device-start entry at a path shape: a chunk q
    ``[B, Sq, Hq, D]`` at ``start`` over the whole cache k/v ``[B, Smax,
    Hkv, D]``, held bitwise to the host-start launch on the cache prefix
    ``[0, start + Sq)`` and within DTYPE_TOL to its plain version
    (``attention_at_ref``); kernel and plain times (CUDA events), the
    kernel's device time (torch.profiler), the bound of this start's work
    (``work.flash_at``) and SDPA's time on the sliced prefix."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_at_ref

    B, Sq, Hq, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    end = start + Sq
    at = torch.tensor(start, dtype=torch.int32, device=q.device)
    run = lambda: flash_attention(q, k, v, start=at)               # noqa: E731
    host = lambda: flash_attention(q, k[:, :end], v[:, :end])      # noqa: E731
    plain = lambda: attention_at_ref(q, k, v, at)                  # noqa: E731
    before = flash_attention.launches
    out, want, ref = run(), host(), plain()
    torch.cuda.synchronize()
    if flash_attention.launches != before + 2:
        raise AssertionError("[attention] the device-start entry did not "
                             "launch the kernel")
    qt, kt, vt = (t.transpose(1, 2).contiguous()
                  for t in (q, k[:, :end], v[:, :end]))
    mask = (torch.arange(end, device=q.device)[None, :]
            <= torch.arange(Sq, device=q.device)[:, None] + start)
    lib = lambda: F.scaled_dot_product_attention(                  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dname = str(q.dtype).split(".")[-1]
    row = {"kind": "flash_at", "shape": [B, Sq, Smax, Hq, Hkv, D],
           "start": start, "dtype": dname,
           "bitwise_host_start": bool(torch.equal(out, want)),
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "rel_err": rel_err(out, ref),
           "ms": cuda_time_ms(run), "host_start_ms": cuda_time_ms(host),
           "plain_ms": cuda_time_ms(plain), "device_ms": device_ms(run),
           "library_ms": cuda_time_ms(lib),
           "library_device_ms": device_ms(lib),
           "library_note": "scaled_dot_product_attention(enable_gqa=True, "
                           "explicit bottom-right mask) on k[:, :start + Sq]"}
    row.update(work.bound(*work.flash_at(B, Sq, Smax, Hq, Hkv, D,
                                         q.element_size(), start), dname))
    if not (row["bitwise_host_start"]
            and row["rel_err"] <= DTYPE_TOL[dname]):
        raise AssertionError(f"[attention] device start {row}")
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
    from repro_torch.kernels.flash_attention.ref import (attention_at_ref,
                                                         attention_ref)

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
    # the device-start entry over a cache 37 rows longer than the chunk:
    # bitwise the host-start launch on the prefix, within DTYPE_TOL of its
    # plain version
    n_at = 0
    for name, M, K, _ in cases:
        D, Hkv, Smax = min(K, 128), 2, M + 37
        for G in (1, 2, 4):
            for dname in DTYPE_TOL:
                dt = dtype_of(dname)
                q = randn(2, M, Hkv * G, D, dt=dt)
                k, v = randn(2, Smax, Hkv, D, dt=dt), randn(2, Smax, Hkv, D,
                                                           dt=dt)
                for start in (0, 19, 37):
                    at = torch.tensor(start, dtype=torch.int32, device="cuda")
                    before = flash_attention.launches
                    out = flash_attention(q, k, v, start=at)
                    check(f"flash device start {name} G={G} start={start}",
                          flash_attention, out,
                          attention_at_ref(q, k, v, at), dname, before)
                    host = flash_attention(q, k[:, :start + M],
                                           v[:, :start + M])
                    if not torch.equal(out, host):
                        raise AssertionError(
                            f"flash device start {name} G={G} start={start}"
                            f" {dname}: not bitwise the host-start launch")
                    n_at += 1
    for (kname, dname), e in sorted(worst.items()):
        log(f"[attention] {kname:16s} {dname:8s}: worst rel_err {e:.3g} <= "
            f"{DTYPE_TOL[dname]}")
    log(f"[attention] {n_checks} checks passed; the device-start entry "
        f"bitwise the host-start launch in all {n_at} of its")

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
    # the device-start entry at the captured engine prefill's shapes:
    # llama3-8b's 44-token chunk at 256 and 256 at 0 over the 324-row
    # cache; zamba2-2.7b's 88 at 512 over 616 rows
    device_start = []
    for (Hq, Hkv, D), Sq, start, Smax in (((32, 8, 128), 44, 256, 324),
                                          ((32, 8, 128), 256, 0, 324),
                                          ((32, 32, 80), 88, 512, 616)):
        q = randn(1, Sq, Hq, D, dt=bf16)
        k, v = randn(1, Smax, Hkv, D, dt=bf16), randn(1, Smax, Hkv, D,
                                                     dt=bf16)
        device_start.append(_flash_at_timing(q, k, v, start))
        log(f"[attention] device start {json.dumps(device_start[-1])}")
    return {"timings": timings, "worst": worst, "device_start": device_start}


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
    from repro_torch.kernels import work
    flops, nbytes = work.ssd_chunk(Bb, L, nh, hd, N)
    split = work.bound(3 * flops, nbytes, "tf32")
    return {**work.bound(flops, nbytes, "float32"),
            "bound_split_tf32_ms": split["bound_ms"],
            "bound_split_tf32_by": split["bound_by"]}


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


class _EagerCalls(dict):
    """An owner's ``_calls`` (an engine's, a batcher's) under which every
    call it makes runs eagerly: a captured call stored in it is replaced by
    its body run on each call's inputs copied to the card: the eager side
    of a comparison, a gate's runs (hooks on the model's entry points see
    every call) and an arm whose routing a ``RouteTape`` pins (the tape
    sees eager calls only)."""

    def __setitem__(self, key, call):
        from repro_torch.core.sync import CapturedCall, make_call
        if isinstance(call, CapturedCall):
            call = make_call(call.body, call.device, capture=False)
        super().__setitem__(key, call)


class _eager_loops:
    """Inside this block the port's decode loops are made eager: each loop
    that ``core.sync`` makes copies its inputs to the card and runs its
    body step by step instead of a CUDA graph; and so are the prefill and
    verify calls that the engine, the batcher and the spec decoder make
    (``make_call`` as under a layout whose collectives a graph cannot
    record) (for the eager arms held against the captured ones; the port
    itself has no such switch)."""

    OWNERS = ("repro_torch.core.engine", "repro_torch.serving.scheduler",
              "repro_torch.serving.spec")

    def __enter__(self):
        import importlib
        from repro_torch.core import sync
        self.made_loop = sync.make_loop
        self.owners = [importlib.import_module(m) for m in self.OWNERS]

        def eager(body, inputs, **_):
            device = inputs[0].device
            return lambda *xs: body(*(x.to(device, non_blocking=True)
                                      for x in xs))

        def eager_call(body, device, **_):
            return sync.make_call(body, device, capture=False)

        sync.make_loop = eager
        for mod in self.owners:
            mod.make_call = eager_call

    def __exit__(self, *exc):
        from repro_torch.core import sync
        sync.make_loop = self.made_loop
        for mod in self.owners:
            mod.make_call = sync.make_call


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
    and the seconds their captures took; the same of its prefill and
    verify graphs under ``calls`` (capture seconds: warm-up, which is the
    first call, and capture)."""
    info = owner.graph_stats()
    info["capture_s"] = sum(getattr(lp, "capture_s", 0.0)
                            for lp in getattr(owner, "_loops", {}).values())
    calls = list(owner._calls.values())
    if getattr(owner, "drafts", None) is not None:
        calls += list(owner.drafts.calls.values())
    info["calls"]["capture_s"] = sum(getattr(c, "capture_s", 0.0)
                                     for c in calls)
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
    from repro_torch.kernels.ssm_scan.ops import ssd_chunk, ssd_chunk_bwd
    return {"hetero_matmul": ops.mxu_matmul,
            "quant_matmul_int8": ops.mxu_quant_matmul,
            "quant_matmul_q4": ops.mxu_q4_matmul,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "ssd_chunk": ssd_chunk, "ssd_chunk_bwd": ssd_chunk_bwd}


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
               table=None, pin=None, then=None) -> dict:
    """One full-width PagedBatcher (sync device, window 8, width 8; its
    plan solved from ``table`` where given): a first run over the prompts
    (which captures its decode graph and its prefill calls), then a timed
    run and, with ``profile``, a profiled run, each over new requests for
    the same prompts. ``pin``, where given, is entered around the timed
    run (a ``RouteTape``'s record or replay; the arm's prefill then runs
    eagerly); the first run's first-token logits are kept as
    ``free_first_logits``. ``then(cb, arm)``, where given, runs last on the
    batcher, its result kept as ``arm["graph_prefill"]``. Returns the timed
    run's numbers."""
    import torch
    from repro_torch.core.sync import fence

    t0 = time.perf_counter()
    cb, reqs = _serve(cfg, params, prompts, device="cuda", engine_mode=mode,
                      sync="device", window=8, decode_width=8,
                      new_tokens=new_tokens, weight_quant=weight_quant,
                      kv_quant=kv_quant, table=table)
    if pin is not None:       # the tape sees eager calls only: prefill too
        cb._calls = _EagerCalls()
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
    if then is not None:
        arm["graph_prefill"] = then(cb, arm)
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
        def check(cb, arm, label=label):   # phase_graph_prefill's cell
            return _paged_prefill_check(cb, prompts, new_tokens,
                                       arm["outputs"], f"paged {label}")

        arms = {mode: _paged_arm(cfg, params, prompts, new_tokens,
                                 label=label, mode=mode, weight_quant=wq,
                                 kv_quant=kvq,
                                 profile=mode == "hetero-tensor",
                                 then=check if mode else None)
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
    from repro_torch.kernels import work
    flops, nbytes = work.flash_bwd(B, Sq, Sk, Hq, Hkv, D, el, causal)
    dname = {4: "float32", 2: "bfloat16"}[el]
    return {**work.bound(flops, nbytes, dname), "flops": flops,
            "bytes": nbytes}


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
    if label.startswith("path"):
        row["plan"] = ops.bwd_plan(q, k, v, do, causal=causal)
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
    bf16, the bf16 one timed against the plain version and SDPA's backward,
    and zamba2-2.7b's shared block ([2, 4096, 32 / 32, 80], causal, bf16:
    D taken at its own 80), timed the same way; the path rows carry the
    launch plan the C entry reports for their operands (``ops.bwd_plan``).
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
    path["zamba2"] = _flash_bwd_case(
        g, 2, 4096, 4096, 32, 1, 80, torch.bfloat16, True,
        label="path zamba2-2.7b", worst=worst, timing=True)
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
            "path_zamba2": path["zamba2"], "worst": worst}


def _ssd_bwd_bound(Bb, L, nh, hd, N) -> dict:
    """The least time of one SSD chunk backward on the card: its bytes (xb,
    B_, C_, seg, S_prev, dy and dS_new read once; dxb, dB_, dC_, dseg and
    dS_prev written once) over the memory rate against its operations over
    the causal pairs (C.B^T once per batch; dM, M^T dy, dA B and dA^T C a
    head; five per pair for the decay and its products) and the five
    state products a head, over the CUDA-core fp32 rate (``bound_ms``);
    and the same operations as three TF32 products each on the tensor
    cores (``bound_split_tf32_ms``)."""
    from repro_torch.kernels import work
    flops, nbytes = work.ssd_chunk_bwd(Bb, L, nh, hd, N)
    split = work.bound(3 * flops, nbytes, "tf32")
    return {**work.bound(flops, nbytes, "float32"),
            "bound_split_tf32_ms": split["bound_ms"],
            "bound_split_tf32_by": split["bound_by"], "flops": flops,
            "bytes": nbytes}


def _ssd_bwd_inputs(g, Bb, L, nh, hd, N, *, state: bool, steep: bool):
    """Seeded operands of one chunk's backward laid out as ``scan_chunks``
    hands them to the kernel: xb, seg and dy a run of L rows out of a
    longer sequence, B_ and C_ column slices of the conv output; S_prev
    zero or not. ``steep``: seg falls 20 a step, so exp(seg_i - seg_j)
    above the diagonal overflows fp32 (exponents up to 20 (L - 1))."""
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    S, at, conv = L + 9, 5, hd * nh + 2 * N
    sl = slice(at, at + L)
    xb = r(Bb, S, nh, hd, scale=0.5)[:, sl]
    wide = r(Bb, S, conv, scale=0.5)
    B_, C_ = wide[:, sl, conv - 2 * N:conv - N], wide[:, sl, conv - N:]
    step = (torch.full((Bb, S, nh), 20.0, device="cuda") if steep
            else r(Bb, S, nh).abs() * 0.1)
    seg = -torch.cumsum(step[:, sl], dim=1).contiguous()
    seg = torch.cat([seg, seg], dim=1)[:, :L]          # rows strided 2 L nh
    S_prev = (r(Bb, nh, hd, N, scale=0.3) if state else
              torch.zeros((Bb, nh, hd, N), device="cuda"))
    dy = r(Bb, S, nh, hd)[:, sl]
    dS = r(Bb, nh, hd, N)
    return (xb, B_, C_, seg, S_prev), dy, dS


def phase_ssd_bwd() -> dict:
    """H0, the SSD chunk backward (``ssd_chunk_bwd``, not a TPU kernel)
    against its plain version (``ssd_chunk_bwd_ref``) carried in fp64: L in
    1 / 17 / 88 / 256, nh in 1 / 3 / 80, hd = N in 16 / 64, S_prev zero
    and not, strided operands as ``scan_chunks`` passes them, and decays
    whose upper exponents overflow fp32; rel_err <= SSD_TOL on every output,
    every output finite, a second launch bitwise equal. Then the training
    path's shape (B 2, L 256, nh 80, hd = N = 64): CUDA events, the plain
    version's time and both bounds, and the launch plan the C entry reports
    (``ops.ssd_bwd_plan``); no PyTorch call computes it."""
    import torch
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(29)
    names = ("dxb", "dB", "dC", "dseg", "dS_prev")
    worst, n = 0.0, 0
    cases = [(L, nh, d, state, False) for L in (1, 17, 88, 256)
             for nh in (1, 3, 80) for d in (16, 64) for state in (False, True)]
    cases += [(L, 3, 16, True, True) for L in (17, 88, 256)]
    for L, nh, d, state, steep in cases:
        ins, dy, dS = _ssd_bwd_inputs(g, 2, L, nh, d, d, state=state,
                                      steep=steep)
        before = ops.ssd_chunk_bwd.launches
        got = ops.ssd_chunk_bwd(*ins, dy, dS)
        again = ops.ssd_chunk_bwd(*ins, dy, dS)
        torch.cuda.synchronize()
        if ops.ssd_chunk_bwd.launches != before + 2:
            raise AssertionError("[train] H0 ssd_chunk_bwd never launched")
        want = ssd_chunk_bwd_ref(*(t.double() for t in (*ins, dy, dS)))
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        label = (f"L {L} nh {nh} hd = N = {d} S_prev "
                 f"{'random' if state else 'zero'}{' steep' if steep else ''}")
        if not (all(torch.isfinite(t).all() for t in got)
                and max(errs) <= SSD_TOL):
            raise AssertionError(f"[train] H0 ssd_chunk_bwd {label}: rel_err "
                                 f"{dict(zip(names, errs))} > {SSD_TOL}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"[train] H0 ssd_chunk_bwd {label}: two "
                                 "launches differ")
        worst = max(worst, *errs)
        n += 1
    log(f"[train] H0 ssd_chunk_bwd: {n} cases, worst rel_err {worst:.3g} <= "
        f"{SSD_TOL} (fp64 plain version), two launches bitwise equal")

    Bb, L, nh, d = 2, 256, 80, 64
    ins, dy, dS = _ssd_bwd_inputs(g, Bb, L, nh, d, d, state=True,
                                  steep=False)
    got = ops.ssd_chunk_bwd(*ins, dy, dS)
    want = ssd_chunk_bwd_ref(*(t.double() for t in (*ins, dy, dS)))
    plain = ssd_chunk_bwd_ref(*ins, dy, dS)
    torch.cuda.synchronize()
    row = {"case": "path zamba2-2.7b", "shape": [Bb, L, nh, d, d],
           "dtype": "float32", "plan": ops.ssd_bwd_plan(Bb, L, nh, d, d),
           "rel_err": dict(zip(names, (rel_err(a, b)
                                       for a, b in zip(got, want)))),
           "plain_fp32_rel_err": max(rel_err(a, b)
                                     for a, b in zip(plain, want)),
           "max_abs_err": max(float((a.double() - b).abs().max())
                              for a, b in zip(got, want))}
    del want, plain
    row["ms"] = cuda_time_ms(lambda: ops.ssd_chunk_bwd(*ins, dy, dS))
    row["plain_ms"] = cuda_time_ms(lambda: ssd_chunk_bwd_ref(*ins, dy, dS),
                                   iters=5, warmup=1)
    row.update(_ssd_bwd_bound(Bb, L, nh, d, d))
    row.update(library_ms=None, library_note="none: no single PyTorch call "
               "computes an SSD chunk step's gradient")
    log(f"[train] H0 ssd path {json.dumps(row)}")
    torch.cuda.empty_cache()
    return {"path": row, "worst": worst, "cases": n}


TRAIN_SMOKE = ("smollm-135m", "qwen3-1.7b", "qwen2-moe-a2.7b",
               "chameleon-34b", "hubert-xlarge", "zamba2-2.7b", "rwkv6-3b")
TRAIN_LOSS_TOL = 1e-5   # relative: the same fp32 loss, card against CPU
TRAIN_GRAD_TOL = 1e-4   # rel_err per leaf: fp32 sums in other orders
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                 "ssd_chunk_bwd")


def _train_batch(cfg, B: int, S: int, seed: int = 0) -> tuple:
    """Seeded (inputs, targets): token ids, or float frames for an
    encoder-only config (the audio stub)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    inputs = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
              if cfg.encoder_only else toks[:, :-1])
    return inputs, toks[:, 1:]


def _train_counts() -> dict:
    counts = _read_counts()
    return {k: counts[k] for k in TRAIN_KERNELS}


def train_launches(cfg, seq: int) -> dict:
    """The training kernels' launches in one ``loss_and_grads`` of a
    ``seq``-token batch, from the code: every attention layer's flash
    forward once, and again under remat's recompute, its backward once; for
    the hybrid, per mamba layer one SSD chunk forward a chunk (twice under
    remat) and one backward a chunk, and the shared block's attention once
    a period; RWKV-6 launches none."""
    twice = 2 if cfg.remat else 1
    if cfg.rwkv is not None:
        fa = ssd = 0
    elif cfg.ssm is not None:
        fa = cfg.n_layers // cfg.ssm.attn_every
        ssd = cfg.n_layers * -(-seq // min(cfg.ssm.chunk, seq))
    else:
        fa, ssd = cfg.n_layers, 0
    return {"flash_attention": twice * fa, "flash_attention_bwd": fa,
            "ssd_chunk": twice * ssd, "ssd_chunk_bwd": ssd}


def phase_train_smoke(device: str = "cuda") -> dict:
    """H1: the fp32 smoke models of the five transformer configs, the
    zamba2 hybrid and RWKV-6 on the card against the port on the CPU: loss
    (1e-5 relative) and every leaf's gradient (rel_err 1e-4), the card's
    attention through the flash kernel's forward (twice a layer: the pass
    and remat's recompute) and its backward (once a layer), the hybrid's
    SSD scan through the chunk kernel (twice a chunk) and its backward
    (once), as ``train_launches`` counts them. Then ``train()`` of the
    smollm and zamba2 smoke models on the card, 9 steps with save_every=5,
    crashed before step 8 (at step index 7): each run restores step 5 and
    ends at the uninterrupted run's losses. On the card the embedding's
    backward (an index_put with accumulate) adds with atomics, so two runs
    need not agree bitwise: the losses are held within TRAIN_LOSS_TOL."""
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
        counts = _train_counts()
        expect = train_launches(cfg, 40)
        if counts != expect:
            raise AssertionError(f"[train] H1 {arch}: launches {counts}, "
                                 f"expected {expect}")
        e_loss = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        e_aux = abs(float(got[1]["aux"]) - float(want[1]["aux"]))
        e_grad = max(rel_err(a.cpu(), b) for a, b in
                     zip(_leaves(got[2]), _leaves(want[2])) if b.any())
        finite = all(torch.isfinite(g).all() for g in _leaves(got[2]))
        if not (finite and e_loss <= TRAIN_LOSS_TOL
                and e_aux <= TRAIN_LOSS_TOL
                * max(abs(float(want[1]["aux"])), 1.0)
                and e_grad <= TRAIN_GRAD_TOL):
            raise AssertionError(f"[train] H1 {arch}: loss {e_loss:.3g}, aux "
                                 f"{e_aux:.3g}, grads {e_grad:.3g}, finite "
                                 f"{finite}")
        out[arch] = {"loss_rel_err": e_loss, "aux_abs_err": e_aux,
                     "grad_rel_err": e_grad, "launches": counts}
        log(f"[train] H1 {arch}: loss card {float(got[0]):.6f} cpu "
            f"{float(want[0]):.6f} (rel {e_loss:.2e}), aux "
            f"{float(got[1]['aux']):.6f}, worst grad rel_err {e_grad:.2e}, "
            f"launches {counts}")

    shape = ShapeSpec("h1", 32, 4, "train")
    ckpt = ROOT / "build" / "train_ckpt"
    for arch in ("smollm-135m", "zamba2-2.7b"):
        cfg = get_smoke_config(arch).with_(**fp32)
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
            raise AssertionError(f"[train] H1 {arch} crash-restart: {runs}")
        log(f"[train] H1 {arch} crash at step 7, restored step 5: losses "
            f"{[round(v, 6) for v in runs['crashed'].values()]} against "
            f"{[round(v, 6) for v in runs['plain'].values()]} (worst "
            f"relative {max(diffs):.2e}, bitwise equal: "
            f"{runs['crashed'] == runs['plain']})")
        key = "crash" if arch == "smollm-135m" else f"crash {arch}"
        out[key] = {"worst": max(diffs),
                    "bitwise": runs["crashed"] == runs["plain"]}
    return out


@contextmanager
def _plain_kernels():
    """``models.layers``' flash attention swapped for its plain version
    (``attention_ref``), and the SSD scan's chunk step for its own
    (``ssd_chunk_ref``); the gradient of each is torch's autograd."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref
    from repro_torch.models import layers
    saved = layers.flash_attention, ssd_ops.ssd_chunk
    layers.flash_attention, ssd_ops.ssd_chunk = attention_ref, ssd_chunk_ref
    try:
        yield
    finally:
        layers.flash_attention, ssd_ops.ssd_chunk = saved


def _matmul_params(cfg, params) -> int:
    """Parameters of the products a token passes through once (layer
    matrices, the hybrid's shared block once a period, an untied head; not
    the embedding gather, the norms, the depthwise conv or RWKV's mixing
    weights)."""
    if cfg.ssm is not None:
        mamba = params["mamba"]["in_proj"].numel() + \
            params["mamba"]["out_proj"].numel()
        shared = sum(t.numel() for t in _leaves(params["shared"])
                     if t.ndim >= 2)
        n = mamba + cfg.n_layers // cfg.ssm.attn_every * shared
    else:
        from repro_torch.training.tree import tree_flatten
        n = sum(t.numel() for path, t in tree_flatten(params["layers"])
                if t.ndim >= 3 and path[-1] != "mix")
    return n + (params["head"].numel() if "head" in params else 0)


def _model_flops(cfg, params, seq: int, batch: int) -> dict:
    """A training step's model FLOPs, without remat's recompute: 6 N T over
    the products' parameters (``_matmul_params``), plus three times the
    forward FLOPs of each sequence mixer: causal attention's two products
    (4 H D over the causal pairs, a layer or a period), the SSD scan's
    chunks (C.B^T once per batch, att . xb and the state in and out, a
    head), RWKV-6's chunked WKV (the pairwise decayed r.k and its product
    with v over the strictly causal pairs, the bonus, the state in and
    out)."""
    n_mm = _matmul_params(cfg, params)
    tokens = seq * batch
    mixer = 0
    if cfg.rwkv is not None:
        L = min(cfg.rwkv.chunk, seq)
        H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        strict = L * (L - 1) // 2
        per_chunk = batch * H * (5 * hd * strict + 3 * L * hd
                                 + 4 * L * hd * hd)
        mixer = cfg.n_layers * -(-seq // L) * per_chunk
    else:
        pairs = seq * (seq + 1) // 2
        n_attn = (cfg.n_layers // cfg.ssm.attn_every if cfg.ssm is not None
                  else cfg.n_layers)
        mixer = 4 * n_attn * batch * cfg.n_heads * cfg.head_dim * pairs
        if cfg.ssm is not None:
            s = cfg.ssm
            L = min(s.chunk, seq)
            nh = s.expand * cfg.d_model // s.head_dim
            cp = L * (L + 1) // 2
            per_chunk = batch * (2 * s.d_state * cp + nh * (
                2 * s.head_dim * cp + 4 * s.head_dim * s.d_state * L))
            mixer += cfg.n_layers * -(-seq // L) * per_chunk
    return {"matmul_params": n_mm, "model_flops": 6 * n_mm * tokens
            + 3 * mixer, "mixer_fwd_flops": mixer}


def phase_train_full(arch: str = "qwen3-1.7b", seq: int = 4096,
                     batch: int = 2, steps: int = 4, *, label: str = "H2",
                     parity: bool = True, parity_dtype: str | None = None,
                     profile: bool = True, device: str = "cuda") -> dict:
    """A full-width training cell (bf16, seeded random weights, fp32 AdamW
    moments, remat per layer or period, seq x batch of SyntheticLM
    tokens). H2: qwen3-1.7b (28 layers, d_model 2048, 16 / 8 heads of 128,
    d_ff 6144, vocab 151936, untied, qk-norm); H3: zamba2-2.7b (54 mamba
    layers, d_model 2560, 80 SSD heads of 64, the shared block every 6
    layers, 32 heads of 80); H4: rwkv6-3b (32 layers, d_model 2560, no
    port kernel on its path). With ``parity``, step 1's loss and every
    leaf's gradient through the kernels against the same with their plain
    versions under autograd on the card (``_plain_kernels``: loss within
    1e-3 relative, each gradient at cosine >= 0.999), on the cell's bf16
    weights or, with ``parity_dtype="float32"``, on the same model with
    fp32 weights and activations (loss within TRAIN_LOSS_TOL, cosine >=
    0.99999): zamba2-2.7b's bf16 gradient has a floor near 0.9985 under
    any perturbation, two plain attentions that round P differently
    included (PERF.md, the SSD backward's findings), so only fp32
    separates a faulty kernel from bf16 rounding there. Then 1 warm-up and
    ``steps`` timed steps of ``make_train_step`` (each fenced), the
    training kernels' launches counted from 0 over the timed steps (each
    ``train_launches`` a step), peak memory over them, and one more step
    under torch.profiler for the busy share. No checkpoint is written at
    this width. ``profile=False`` skips the profiled step (its busy share
    and device times are then None)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import tree_flatten

    cfg = get_config(arch)
    model = build_model(cfg)
    gen = lambda: torch.Generator(device=device).manual_seed(0)  # noqa: E731
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    first = data.next()
    inputs = torch.from_numpy(first["inputs"]).to(device)
    targets = torch.from_numpy(first["targets"]).to(device)

    marks = [("start", time.perf_counter())]
    e_loss, worst_cos, params = None, None, None
    if parity:
        pcfg = cfg if parity_dtype is None else cfg.with_(
            param_dtype=parity_dtype, compute_dtype=parity_dtype)
        loss_tol, cos_min = ((1e-3, 0.999) if parity_dtype is None
                             else (TRAIN_LOSS_TOL, 0.99999))
        pmodel = build_model(pcfg)
        pparams = pmodel.init(gen(), device=device)
        log(f"[train] {label} parity: {torch.cuda.memory_allocated() / 1e9:.2f}"
            " GB allocated with the parity weights")
        loss_k, _, grads_k = loss_and_grads(pmodel, pparams, inputs, targets)
        # the kernels' gradients wait in host memory while the plain pass
        # runs (the fp32 plain attention's scores alone take 4.3 GB a copy)
        grads_k = [(path, t.cpu()) for path, t in tree_flatten(grads_k)]
        torch.cuda.empty_cache()
        with _plain_kernels():
            loss_p, _, grads_p = loss_and_grads(pmodel, pparams, inputs,
                                                targets)
        e_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        cos = {"/".join(path): float(torch.nn.functional.cosine_similarity(
            a.to(device).float().flatten(), b.float().flatten(), dim=0))
            for (path, a), (_, b) in zip(grads_k, tree_flatten(grads_p))}
        worst = min(cos, key=cos.get)
        worst_cos = cos[worst]
        log(f"[train] {label} parity ({pcfg.param_dtype}): step-1 loss "
            f"kernels {float(loss_k):.6f}, plain {float(loss_p):.6f} (rel "
            f"{e_loss:.2e}); gradient cosine worst {cos[worst]:.7f} "
            f"({worst}), mean {sum(cos.values()) / len(cos):.7f} over "
            f"{len(cos)} leaves")
        if not (e_loss <= loss_tol and cos[worst] >= cos_min):
            raise AssertionError(f"[train] {label} parity: loss {e_loss:.3g}"
                                 f", cosine {cos[worst]:.7f} ({worst})")
        if pcfg is cfg:
            params = pparams
        del grads_k, grads_p, pparams
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(("parity", time.perf_counter()))
    if params is None:
        params = model.init(gen(), device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    flops = _model_flops(cfg, params, seq, batch)
    marks.append(("init", time.perf_counter()))

    _, step_fn = make_train_step(cfg, TrainConfig(), device=device)
    state = opt.init_state(params)
    state, metrics = step_fn(state, first)          # warm-up step
    fence(state["step"])
    marks.append(("warm-up", time.perf_counter()))
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
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k: n * steps for k, n in train_launches(cfg, seq).items()}
    if counts != expect:
        raise AssertionError(f"[train] {label} launches {counts}, expected "
                             f"{expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] {label} losses {losses}")
    marks.append(("timed", time.perf_counter()))
    prof = {"rows": [], "share": None, "wall_s": None}
    if profile:
        nxt = data.next()
        prof = _profiled(f"train-step {arch}", lambda: step_fn(state, nxt),
                         state["step"])
        marks.append(("profiled", time.perf_counter()))
    log(f"[time] {label} " + ", ".join(
        f"{name} {t - t0:.1f}s" for (_, t0), (name, t) in zip(marks,
                                                              marks[1:])))
    step_s = sum(times) / len(times)
    tokens = seq * batch

    def kernel_ms(names, calls):
        """Device ms a call of the kernels whose names hold one of
        ``names``, over ``calls`` calls in the profiled step."""
        if not profile:
            return None
        us = sum(r[0] for r in prof["rows"] if any(n in r[2] for n in names))
        return us / 1e3 / calls if calls else None

    per_step = train_launches(cfg, seq)
    ssd_calls = per_step["ssd_chunk"] + per_step["ssd_chunk_bwd"]
    row = {"arch": cfg.name, "seq": seq, "batch": batch,
           "params": n_params, **flops,
           "step_s": times, "mean_step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "model_flop_share": flops["model_flops"] / step_s
           / PEAK_FLOPS["bfloat16"],
           "peak_gb": peak / 1e9, "busy_share": prof["share"],
           "profiled_wall_s": prof["wall_s"], "losses": losses,
           "launches": counts, "parity_loss_rel": e_loss,
           "parity_worst_cos": worst_cos,
           "parity_dtype": (parity_dtype or cfg.param_dtype) if parity
           else None,
           # device time a call in the profiled step: the attention
           # backward's kernels, the forward's; the SSD backward's own two
           # kernels plus its share of C.B^T (ssd_cb_tc, launched by the
           # forward's and the backward's calls alike), and the forward's
           "bwd_step_device_ms": kernel_ms(("flash_bwd",),
                                           per_step["flash_attention_bwd"]),
           "fwd_step_device_ms": kernel_ms(("flash_tc",),
                                           per_step["flash_attention"]),
           "ssd_bwd_step_device_ms": None if not ssd_calls else
           kernel_ms(("ssd_bwd",), per_step["ssd_chunk_bwd"])
           + kernel_ms(("ssd_cb_tc",), ssd_calls),
           "ssd_fwd_step_device_ms": None if not ssd_calls else
           kernel_ms(("ssd_chunk_tc",), per_step["ssd_chunk"])
           + kernel_ms(("ssd_cb_tc",), ssd_calls)}
    # with remat's recompute: one more forward of the products and mixers
    row["remat_flops"] = 8 * flops["matmul_params"] * tokens \
        + 4 * flops["mixer_fwd_flops"]
    log(f"[train] {label} {cfg.name} seq {seq} x batch {batch}: step "
        f"{step_s:.4f}s ({', '.join(f'{t:.4f}' for t in times)}), "
        f"{row['tokens_per_s']:.0f} tok/s, model-FLOP share "
        f"{row['model_flop_share']:.4f} of 989 TFLOP/s, peak "
        f"{row['peak_gb']:.2f} GB, busy {prof['share']}, losses {losses}")
    log(f"[train] {label} {json.dumps(row)}")
    del state, params, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _leaf_cosines(grads_a, grads_b, device) -> dict:
    """Per leaf path, the cosine of two gradient trees' leaves (the first
    may wait on the host)."""
    import torch
    from repro_torch.training.tree import tree_flatten
    return {"/".join(path): float(torch.nn.functional.cosine_similarity(
        a.to(device).float().flatten(), b.to(device).float().flatten(),
        dim=0)) for (path, a), (_, b) in zip(tree_flatten(grads_a),
                                              tree_flatten(grads_b))}


def _h_opt():
    """H5 / H6's AdamW: one warm-up step, so the first steps run at the
    full lr (3e-4) and move the bf16 params by whole ulps."""
    from repro_torch.training.optimizer import AdamWConfig
    return AdamWConfig(warmup_steps=1)


def _update_agreement(p0, pa, pb) -> dict:
    """Two updates ``pa - p0`` and ``pb - p0`` of a param tree, in fp32:
    the leaves bitwise equal, the worst leaf's cosine (an equal leaf
    counts 1, a zero update against a nonzero one 0) and the whole
    tree's cosine."""
    import torch
    from repro_torch.training.tree import tree_flatten
    worst, leaf, equal, n = 1.0, "", 0, 0
    dot = na = nb = 0.0
    for (path, a0), (_, a), (_, b) in zip(tree_flatten(p0), tree_flatten(pa),
                                          tree_flatten(pb)):
        n += 1
        da, db = (a.float() - a0.float()).flatten(), \
            (b.float() - a0.float()).flatten()
        dot += float(da @ db)
        na += float(da @ da)
        nb += float(db @ db)
        if torch.equal(a, b):
            equal += 1
            continue
        c = float(torch.nn.functional.cosine_similarity(da, db, dim=0))
        if c < worst:
            worst, leaf = c, "/".join(path)
    return {"leaves": n, "bitwise": equal, "worst_cos": worst,
            "worst_leaf": leaf,
            "tree_cos": dot / max((na * nb) ** 0.5, 1e-30)}


def phase_train_sharded(arch: str = "qwen3-1.7b", seq: int = 4096,
                        batch: int = 2, device: str = "cuda") -> dict:
    """H5: ``build_train_step`` (launch/steps.py) for qwen3-1.7b over a
    one-rank NCCL mesh with ``seq_shard=True``, at 4096 x 2, on H2's
    seeded weights and first batch: step 1's loss within 1e-6 relative of
    ``make_train_step``'s and every gradient at cosine >= 0.99999 (and
    whether they are bitwise equal); then one warm-up of each and two
    timed steps each, alternating, on one state (a one-rank state's blocks
    are the whole tensors), with each step's peak memory. Both steps run
    AdamW with one warm-up step (``_h_opt``), so a step moves every parameter
    at the full lr: before the timed steps, one step of each from the same
    params and batch must give the same update (per leaf bitwise or at
    cosine >= 0.99999) and the same gradient norm (1e-6 relative)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import tree_flatten, tree_map

    cfg = get_config(arch)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in
                data.next().items()} for _ in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        init_ranks(1, 0, f"file://{tmp}/rendezvous", device=device)
        try:
            mesh1 = make_host_mesh(1, 1, device=device)
            step, _, _, _ = build_train_step(cfg, mesh1, opt_cfg=_h_opt(),
                                             seq_shard=True)
            params = model.init(torch.Generator(device=device).manual_seed(0),
                                device=device)
            first = batches[0]
            loss_s, _, grads_s = loss_and_grads(model, params,
                                                first["inputs"],
                                                first["targets"])
            grads_s = tree_map(lambda t: t.cpu(), grads_s)
            torch.cuda.empty_cache()
            _zero_counts()
            loss_m, _, grads_m = step.loss_and_grads(params, first["inputs"],
                                                     first["targets"])
            launches = _train_counts()
            e_loss = abs(float(loss_m) - float(loss_s)) / abs(float(loss_s))
            cos = _leaf_cosines(grads_s, grads_m, device)
            worst = min(cos, key=cos.get)
            bitwise = float(loss_m) == float(loss_s) and all(
                torch.equal(a.to(device), b) for (_, a), (_, b) in
                zip(tree_flatten(grads_s), tree_flatten(grads_m)))
            log(f"[train] H5 {arch} sharded step (1-rank NCCL mesh, "
                f"seq_shard): step-1 loss {float(loss_m):.6f} vs "
                f"make_train_step {float(loss_s):.6f} (rel {e_loss:.2e}); "
                f"gradient cosine worst {cos[worst]:.8f} ({worst}); bitwise "
                f"equal: {bitwise}; launches {launches}")
            if not (e_loss <= 1e-6 and cos[worst] >= 0.99999):
                raise AssertionError(f"[train] H5: loss {e_loss:.3g}, cosine "
                                     f"{cos[worst]:.8f} ({worst})")
            if device == "cuda" and min(launches["flash_attention"],
                                        launches["flash_attention_bwd"]) <= 0:
                raise AssertionError(f"[train] H5 launches {launches}")
            del grads_s, grads_m
            gc.collect()
            torch.cuda.empty_cache()
            _, single = make_train_step(cfg, TrainConfig(opt=_h_opt()),
                                        device=device)
            # one step of each from the same params: the same update
            p0 = tree_map(torch.clone, params)
            state = opt.init_state(tree_map(torch.clone, params))
            state, m_sh = step(state, first)
            other, m_one = single(opt.init_state(params), first)
            upd = _update_agreement(p0, state["params"], other["params"])
            norm_rel = abs(float(m_sh["grad_norm"]) - float(
                m_one["grad_norm"])) / float(m_one["grad_norm"])
            log(f"[train] H5 one AdamW step at lr {float(m_one['lr']):.2e} "
                f"from the same params: update bitwise equal on "
                f"{upd['bitwise']} of {upd['leaves']} leaves, worst cosine "
                f"{upd['worst_cos']:.8f} ({upd['worst_leaf']}); grad norm "
                f"{float(m_sh['grad_norm']):.6f} vs "
                f"{float(m_one['grad_norm']):.6f} (rel {norm_rel:.2e})")
            if not (upd["worst_cos"] >= 0.99999 and norm_rel <= 1e-6):
                raise AssertionError(f"[train] H5 update: cosine "
                                     f"{upd['worst_cos']:.8f}, grad norm "
                                     f"{norm_rel:.3g}")
            del other, p0, params
            gc.collect()
            torch.cuda.empty_cache()
            fns = {"sharded": step, "single": single}
            times = {"sharded": [], "single": []}
            peaks = {"sharded": 0.0, "single": 0.0}
            order = ("sharded", "single") * 3
            for i, which in enumerate(order):
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = fns[which](state, batches[i % 4 + 1])
                fence(state["step"])
                if i >= 2:                       # the first pair warms up
                    times[which].append(time.perf_counter() - t0)
                    peaks[which] = max(peaks[which],
                                       torch.cuda.max_memory_allocated()
                                       / 1e9)
                if not math.isfinite(float(metrics["loss"])):
                    raise AssertionError(f"[train] H5 loss {metrics}")
        finally:
            dist.destroy_process_group()
    row = {"arch": arch, "seq": seq, "batch": batch, "loss_rel": e_loss,
           "worst_cos": cos[worst], "worst_leaf": worst, "bitwise": bitwise,
           "update": upd, "norm_rel": norm_rel,
           "launches": launches, "step_s": times, "peak_gb": peaks}
    log(f"[train] H5 timed steps (order sharded, single, sharded, single "
        f"after one warm-up each): sharded {times['sharded']} s, single "
        f"{times['single']} s; peak {peaks['sharded']:.2f} / "
        f"{peaks['single']:.2f} GB")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return row


H6_LAYERS, H6_SEQ, H6_BATCH = 2, 1024, 2
# the two-step update's tree cosine against the single device's, H2's
# bf16 gate: Adam's step flips with the sign of a gradient element inside
# the bf16 noise (measured 0.99956 on the H100, the tied embedding's leaf
# alone 0.9954); skipping AdamW gives 0, a wrong m / v block far less
H6_UPDATE_COS = 0.999


def _train_gloo_rank(rank: int, arch: str) -> dict:
    """H6 on one of two gloo ranks sharing the card, a data 1 x model 2
    mesh: qwen3-1.7b at full width and H6_LAYERS layers, two sharded
    train steps (flash 2.4 / 4b at the local 8 / 4 heads) at the full lr
    (``_h_opt``), the gradients each step applied gathered. Rank 0 then
    runs the single-device loss and gradients and two single-device steps
    on the same params and batches, and replays ``apply_updates`` on one
    device with the gathered gradients."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import gather_tree, shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(1, 2, device="cuda")
    cfg = get_config(arch).with_(n_layers=H6_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    step, _, ssh, _ = build_train_step(cfg, mesh, opt_cfg=_h_opt(),
                                       seq_shard=True)
    specs = tree_map(lambda sh: sh.spec, ssh["params"])
    data = SyntheticLM(cfg.vocab_size, H6_SEQ, H6_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.next().items()} for _ in range(2)]
    # the gradients each step applies, gathered (every rank gathers)
    applied, run = [], step.loss_and_grads

    def recording(*args):
        res = run(*args)
        whole = gather_tree(res[2], specs, mesh)
        if rank == 0:
            applied.append(whole)
        return res
    step.loss_and_grads = recording
    state = opt.init_state(tree_map(torch.clone,
                                    shard_tree(params, specs, mesh)))
    _zero_counts()
    t0 = time.perf_counter()
    state, m1 = step(state, batches[0])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = _train_counts()
    state, m2 = step(state, batches[1])
    norms = [float(m1["grad_norm"]), float(m2["grad_norm"])]
    after = {k: gather_tree(state[k], specs, mesh) for k in ("params", "m",
                                                             "v")}
    out = {"loss": float(m1["loss"]), "launches": counts, "step_s": step_s,
           "local_heads": (step.plan.cfg_local.n_heads,
                           step.plan.cfg_local.n_kv_heads)}
    if rank == 0:
        p0 = tree_map(torch.clone, params)
        ref_loss, _, ref_grads = loss_and_grads(model, params,
                                                batches[0]["inputs"],
                                                batches[0]["targets"])
        ref_norm = float(opt.global_norm(ref_grads))
        grad_cos = _leaf_cosines(ref_grads, applied[0], "cuda")
        del ref_grads
        # the optimizer held to itself: one device, the same gradients
        replay = opt.init_state(tree_map(torch.clone, p0))
        norm_rel = 0.0
        for g, n in zip(applied, norms):
            replay, rm = opt.apply_updates(replay, g, _h_opt())
            norm_rel = max(norm_rel, abs(n - float(rm["grad_norm"]))
                           / float(rm["grad_norm"]))
        moment_err = max(
            float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
            for k in ("m", "v") for (_, a), (_, b) in
            zip(tree_flatten(after[k]), tree_flatten(replay[k])))
        pairs = list(zip(tree_flatten(after["params"]),
                         tree_flatten(replay["params"])))
        param_diff = sum(int(torch.sum(a != b)) for (_, a), (_, b) in pairs)
        n_params = sum(a.numel() for (_, a), _ in pairs)
        del replay, applied[:]
        # the single device's own two steps
        _, single = make_train_step(cfg, TrainConfig(opt=_h_opt()),
                                    device="cuda")
        one = opt.init_state(params)
        for b in batches:
            one, _ = single(one, b)
        out.update(ref_loss=float(ref_loss), grad_cos=grad_cos,
                   norm_rel_single=abs(norms[0] - ref_norm) / ref_norm,
                   norm_rel_replay=norm_rel, moment_err=moment_err,
                   param_diff=param_diff / n_params,
                   update=_update_agreement(p0, after["params"],
                                            one["params"]))
    return out


def phase_train_gloo(arch: str = "qwen3-1.7b") -> dict:
    """H6: qwen3-1.7b's sharded train step at TP = 2 as two gloo processes
    sharing the card (full width, H6_LAYERS layers, seq H6_SEQ x batch
    H6_BATCH) against the single-device step on the same params, two
    steps at the full lr (``_h_opt``). Gates: step 1's loss within 1e-3
    relative and every gradient at cosine >= 0.999 (H2's bf16 gate); the
    sharded optimizer against ``apply_updates`` on one device fed the
    gathered gradients (gradient norms within 1e-5 relative, m / v within
    1e-5 of their largest magnitude, at most 1e-4 of the bf16 params
    differing); the update of the two steps against the single device's
    own at a tree cosine >= H6_UPDATE_COS, and step 1's gradient norm
    against the single device's within 1e-2 relative (the cosine gate
    lets a leaf's bf16 gradient differ by up to sqrt(2 (1 - 0.999)), 4.5 %
    of its norm; measured 1.0e-3, the tied embedding's). Its times are the
    gloo transport's."""
    from repro_torch.launch.mesh import spawn_ranks
    ranks = spawn_ranks(_train_gloo_rank, 2, arch, device="cuda",
                        backend="gloo")
    r0 = ranks[0]
    e_loss = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    g_worst = min(r0["grad_cos"], key=r0["grad_cos"].get)
    upd = r0["update"]
    log(f"[train] H6 {arch} TP = 2 over two gloo ranks on the card "
        f"({H6_LAYERS} layers, {H6_SEQ} x {H6_BATCH}, local heads "
        f"{r0['local_heads']}): loss {r0['loss']:.6f} / rank 1 "
        f"{ranks[1]['loss']:.6f} vs single device {r0['ref_loss']:.6f} "
        f"(rel {e_loss:.2e}); gradient cosine worst "
        f"{r0['grad_cos'][g_worst]:.7f} ({g_worst}); grad norm vs single "
        f"device rel {r0['norm_rel_single']:.2e}; sharded AdamW vs one "
        f"device on the same gradients: norms rel "
        f"{r0['norm_rel_replay']:.2e}, m / v {r0['moment_err']:.2e}, params "
        f"differing {r0['param_diff']:.2e}; two-step update vs the single "
        f"device's: tree cosine {upd['tree_cos']:.7f}, worst leaf "
        f"{upd['worst_cos']:.7f} ({upd['worst_leaf']}), bitwise "
        f"{upd['bitwise']} of {upd['leaves']}; step 1 {r0['step_s']:.3f}s "
        f"(gloo transport); launches rank 0 {r0['launches']}, rank 1 "
        f"{ranks[1]['launches']}")
    if not (e_loss <= 1e-3 and r0["grad_cos"][g_worst] >= 0.999
            and ranks[1]["loss"] == r0["loss"]
            and r0["norm_rel_single"] <= 1e-2
            and r0["norm_rel_replay"] <= 1e-5 and r0["moment_err"] <= 1e-5
            and r0["param_diff"] <= 1e-4
            and upd["tree_cos"] >= H6_UPDATE_COS):
        raise AssertionError(
            f"[train] H6: loss {e_loss:.3g}, gradient cosine "
            f"{r0['grad_cos'][g_worst]:.7f}, norms {r0['norm_rel_single']:.3g}"
            f" / {r0['norm_rel_replay']:.3g}, m / v {r0['moment_err']:.3g}, "
            f"params {r0['param_diff']:.3g}, update {upd['tree_cos']:.7f}")
    for r in ranks:
        if min(r["launches"]["flash_attention"],
               r["launches"]["flash_attention_bwd"]) <= 0:
            raise AssertionError(f"[train] H6 launches {r['launches']}")
    return {"loss_rel": e_loss, "grad_cos": r0["grad_cos"][g_worst],
            "norm_rel_single": r0["norm_rel_single"],
            "norm_rel_replay": r0["norm_rel_replay"],
            "moment_err": r0["moment_err"], "param_diff": r0["param_diff"],
            "update": upd,
            "launches": [r["launches"] for r in ranks],
            "step_s": [r["step_s"] for r in ranks]}


def phase_training() -> dict:
    """Phase H: training through the flash kernel's and the SSD chunk
    kernel's backwards. H0 the two backward kernels, H1 the fp32 smoke
    models and two crash-restarts on the card, H2 qwen3-1.7b, H5 its
    sharded step over a one-rank mesh, H6 at TP = 2 over two gloo ranks,
    H3 zamba2-2.7b and H4 rwkv6-3b at full width."""
    out = {}
    for key, phase in (
            ("H0", phase_flash_bwd), ("H0 ssd", phase_ssd_bwd),
            ("H1", phase_train_smoke), ("H2", phase_train_full),
            ("H5", phase_train_sharded), ("R", phase_dryrun_train),
            ("H6", phase_train_gloo),
            ("H3", lambda: phase_train_full("zamba2-2.7b", label="H3",
                                            parity_dtype="float32")),
            # H4 unprofiled: its ~250k-kernel step took 80-98 s under the
            # profiler, the room phase T needs inside the time limit
            # one timed step: its ~16 s steps are the room phases P and R
            # take inside the time limit
            ("H4", lambda: phase_train_full(
                "rwkv6-3b", steps=1, label="H4", parity=False,
                profile=False))):
        t0 = time.perf_counter()
        out[key] = phase()
        log(f"[time] phase H {key}: {time.perf_counter() - t0:.1f}s")
    return out


PORT_KERNELS = ("gemm_tc", "splitk_reduce", "mm_output_stationary",
                "mm_weight_stationary", "quant_mm", "flash_tc", "flash_fwd",
                "flash_bwd", "decode_split", "decode_combine", "ssd_cb_tc",
                "ssd_chunk_tc", "ssd_bwd")


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
    eng._calls = _EagerCalls()   # the model's own prefill, chunk by chunk
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


def _host_start(flash):
    """``flash``, a plain attention of a chunk over its cache prefix
    (``attention_ref``'s signature), behind the wrapper's: a device start
    is read on the host and the cache cut to ``[0, start + Sq)`` (the
    gates' plain side runs eagerly)."""
    def run(q, k, v, *, causal=True, start=None):
        if start is None:
            return flash(q, k, v, causal=causal)
        end = int(start.reshape(())) + q.shape[1]
        return flash(q, k[:, :end], v[:, :end], causal=True)
    return run


def attention_gate(cfg, params, prompt, plain=None, *, check: bool = True
                   ) -> dict:
    """``_kernel_gate`` of the attention kernels: ``models.layers``' two
    attention calls swapped for ``plain`` (flash, decode; the plain versions
    unless given). This runs the kernels on the path's own operands:
    strided per-layer cache views, the model's head dim, the chunk's
    device start (flash's device-start entry over the whole cache layer)
    and the device length ``index + 1``."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers

    flash, decode = plain or (attention_ref, decode_attention_ref)
    return _kernel_gate(
        "attention-gate", cfg, params, prompt, layers,
        {"flash_attention": _host_start(flash), "decode_attention": decode},
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
    chunk, first = eng.prefill_chunk, {}

    def keep_logits(*a):
        logits = chunk(*a)
        first["logits"] = logits[0, -1].float()
        return logits

    eng.prefill_chunk = keep_logits
    if pin is not None:       # the tape sees eager calls only: prefill too
        eng._calls = _EagerCalls()
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
    seconds and the profiled busy share of each (the quantized paged
    cells' eager arms unprofiled since PR 27, to fit phases P and R in the
    time limit), the captured arm's graphs
    (count, capture seconds, pool bytes, replays) and each kernel's
    launches, which must be equal, as must the greedy tokens."""
    rows = {}
    for label, wq, kvq in FULL_PAIRS if paged else ():
        cap = paged[label]
        with _eager_loops():
            eager = _paged_arm(cfg, params, cap["prompts"], cap["new_tokens"],
                               label=f"{label} eager", mode="hetero-tensor",
                               weight_quant=wq, kv_quant=kvq,
                               profile=wq is None)
        rows[f"paged {label}"] = _pair_line(f"paged {label}", cap, eager)
    cap = engine["hetero-tensor/fast"]
    with _eager_loops():
        eager = _engine_arm(cfg, params, cap["prompt"], len(cap["tokens"]),
                            mode="hetero-tensor", fast=True,
                            label="hetero-tensor/fast eager", profile=True)
    rows[f"engine {cfg.name}"] = _pair_line(f"engine {cfg.name}", cap, eager)
    return rows


# ---------------------------------------- phase_graph_prefill (ROADMAP M2b) --

def _same_state(a: dict, b: dict) -> bool:
    """Whether two pools or caches hold bitwise the same tensors (a cache's
    ``index`` aside)."""
    import torch
    return all(torch.equal(a[k], b[k]) for k in a if k != "index")


def _replayed(call, device) -> bool:
    """Whether ``call`` replays a graph (a captured call after its first
    use); on the CPU, where a call is its body, True."""
    from repro_torch.core.sync import CapturedCall
    if isinstance(call, CapturedCall):
        return call.graph is not None
    return device.type != "cuda"


class _CallCheck:
    """Each call a batcher makes (``cb._call``: a prefill chunk, a verify
    round, its acceptance) first runs the model's own entry point (the
    batcher's paged prefill or verify, ``greedy_verify``) eagerly on a
    copy of the pool, on the same tokens, block table and start (a
    prefill's as the int it was before the calls), then the call on the
    pool: the logits (the accepted tokens and counts) and the pool after
    must be bitwise equal. The null block is left out: inactive lanes and
    the rows past a lane's budget write its slots together, in whichever
    order the scatter takes, and only such rows read it, so a verify's
    logits are compared on the rows whose position lies in a block of the
    lane's own. ``rows`` keeps (kind, length, replayed, logits equal, pool
    equal, argmax tokens equal) per call."""

    def __init__(self, cb):
        self.cb, self.inner, self.rows = cb, cb._call, []
        cb._call = self._call

    def _call(self, kind, length):
        import torch
        cb, call = self.cb, self.inner(kind, length)
        if kind == "accept":
            return partial(self._accept, call, length)
        fn = cb._prefill if kind == "prefill" else cb._verify

        def run(tokens, table, start):
            copy = {k: t.clone() for k, t in cb.kv.pool.items()}
            dev = [t.to(cb.device) for t in (tokens, table, start)]
            at = int(start) if kind == "prefill" else dev[2]
            want = fn(cb.params, dev[0], copy, block_table=dev[1],
                      start_index=at)[0]
            replayed = _replayed(call, cb.device)
            got = call(tokens, table, start)
            if kind == "verify":            # the rows in the lanes' blocks
                pos = start[:, None] + torch.arange(tokens.shape[1])
                own = table.gather(1, (pos // cb.block_size).clamp(
                    max=table.shape[1] - 1)) != 0
                own = own.to(cb.device)
                got_rows, want_rows = got[own], want[own]
            else:
                got_rows, want_rows = got, want
            self.rows.append((
                kind, length, replayed,
                bool(torch.equal(got_rows, want_rows)),
                _same_state({k: t[:, 1:] for k, t in copy.items()},
                            {k: t[:, 1:] for k, t in cb.kv.pool.items()}),
                bool(torch.equal(got_rows.argmax(-1),
                                 want_rows.argmax(-1)))))
            return got
        return run

    def _accept(self, call, length, drafts, logits):
        import torch
        from repro_torch.serving.sampler import greedy_verify
        want = greedy_verify(drafts.to(self.cb.device), logits)
        replayed = _replayed(call, self.cb.device)
        got = call(drafts, logits)
        same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        self.rows.append(("accept", length, replayed, same, True, same))
        return got

    def undo(self):
        self.cb._call = self.inner

    def summary(self, label: str) -> dict:
        rows = self.rows
        out = {"calls": len(rows), "replays": sum(r[2] for r in rows),
               "logits_bitwise": sum(r[3] for r in rows),
               "pool_bitwise": sum(r[4] for r in rows),
               "tokens_equal": sum(r[5] for r in rows),
               "order": [(r[0], r[1]) for r in rows]}
        if not rows or not all(r[2] and r[3] and r[4] and r[5]
                               for r in rows):
            raise AssertionError(f"[graph-prefill] {label}: a call was no "
                                 f"replay or differs from the eager entry "
                                 f"point: {rows}")
        return out


class _SlotCheck:
    """Each call an owner of a dense slot cache makes (``owner._call``: the
    dense batcher's prefill pieces and decode step, the draft lanes'
    prefill chunks and host-sync step) first runs the model's own entry
    point eagerly on a copy of the cache on the same inputs (a piece's
    slot and start as host ints: ``prefill_slot``'s eager form;
    ``decode_step`` over the staged positions), then the call on the
    cache: its outputs (logits; a step's next tokens and positions) and
    the cache after (its positions included, where a decode step writes
    them) must be bitwise equal. ``rows`` keeps (kind, chunk, replayed,
    outputs equal, cache equal) per call."""

    def __init__(self, owner):
        self.owner, self.inner, self.rows = owner, owner._call, []
        owner._call = self._call

    def _call(self, kind, chunk=None):
        call = self.inner(kind, chunk)
        return partial(self._run, kind, chunk, call)

    def _run(self, kind, chunk, call, *inputs):
        import torch
        o = self.owner
        dev = [t.to(o.device) for t in inputs]
        copy = {k: t.clone() for k, t in o.cache.items()}
        if kind == "prefill":
            want = o.model.prefill_slot(o.params, copy, dev[0], int(inputs[1]),
                                        int(inputs[2]))[0]
        else:
            logits, run = o.model.decode_step(o.params, dev[0],
                                              {**copy, "index": dev[1]})
            copy["index"] = run["index"].to(copy["index"].dtype)
            want = logits if kind == "decode" else (
                torch.argmax(logits[:, -1, :], dim=-1)[:, None],
                run["index"])
        replayed = _replayed(call, o.device)
        got = call(*inputs)
        same = all(torch.equal(a, b) for a, b in
                   zip(*(x if isinstance(x, tuple) else (x,)
                         for x in (got, want)), strict=True))
        state = _same_state(copy, o.cache) and (
            kind != "decode" or torch.equal(copy["index"], o.cache["index"]))
        self.rows.append((kind, chunk, replayed, same, state))
        return got

    def undo(self):
        self.owner._call = self.inner

    def summary(self, label: str) -> dict:
        rows = self.rows
        if not rows or not all(r[2] and r[3] and r[4] for r in rows):
            raise AssertionError(f"{label}: a call was no replay or differs "
                                 f"from the eager entry point: {rows}")
        return {"calls": len(rows),
                "by_kind": dict(Counter(r[0] for r in rows))}


def _order_differs(captured: list, replayed: list) -> list:
    """Pairs of lengths replayed in the other order than captured."""
    first = {c: i for i, c in reversed(list(enumerate(replayed)))}
    return [(a, b) for i, a in enumerate(captured) for b in captured[i + 1:]
            if a in first and b in first and first[b] < first[a]]


def _paged_prefill_check(cb, prompts, new_tokens: int, outputs: list,
                        label: str) -> dict:
    """phase_graph_prefill's paged cell on a batcher whose runs over
    ``prompts`` (timed tokens ``outputs``) captured its prefill calls: the
    prompts again in reverse order, so the chunk lengths replay in another
    order than their capture's (the shared pool), each call held bitwise
    to the eager entry point on a copy of the pool (``_CallCheck``), the
    tokens to ``outputs``; then prefill-only runs (one new token: no
    decode) alternating captured, eager, eager, captured, first tokens
    equal. Returns its record."""
    from repro_torch.core.sync import fence

    captured = [key[-1] for key in cb._calls if key[0] == "prefill"]
    check = _CallCheck(cb)
    reqs = _requests(prompts[::-1], new_tokens)
    try:
        cb.run(reqs)
    finally:
        check.undo()
    rec = check.summary(label)
    replayed = [n for kind, n in rec["order"] if kind == "prefill"]
    swapped = _order_differs(captured, replayed)
    tokens = [r.output for r in reqs][::-1]
    if tokens != outputs or not swapped:
        raise AssertionError(f"[graph-prefill] {label}: reversed prompts' "
                             f"tokens equal {tokens == outputs}; capture "
                             f"order {captured}, replay order {replayed}")
    walls, firsts = {"captured": [], "eager": []}, set()
    anchor = cb.kv.pool["k"]
    for arm in ("captured", "eager", "eager", "captured"):
        calls = cb._calls
        if arm == "eager":
            cb._calls = _EagerCalls()
        reqs = _requests(prompts, 1)
        fence(anchor)
        t0 = time.perf_counter()
        cb.run(reqs)
        fence(anchor)
        walls[arm].append(time.perf_counter() - t0)
        cb._calls = calls
        firsts.add(str([r.output for r in reqs]))
    if firsts != {str([o[:1] for o in outputs])}:
        raise AssertionError(f"[graph-prefill] {label}: first tokens of the "
                             f"alternating runs {firsts}")
    calls = _graph_info(cb)["calls"]
    rec.update(capture_order=captured, replay_order=replayed,
               swapped=swapped[:3], prefill_only_s=walls, graphs=calls)
    log(f"[graph-prefill] {label}: {rec['calls']} calls replayed, logits "
        f"and pool bitwise the eager entry point's, tokens equal; chunk "
        f"lengths captured {captured}, replayed {replayed} (e.g. "
        f"{swapped[:2]} swapped); graphs {calls['graphs']}, replays "
        f"{calls['replays']}, pool {calls['pool_bytes'] / 2 ** 20:.1f} MB, "
        f"capture {calls['capture_s']:.2f}s; prefill-only runs captured "
        f"{[round(w, 4) for w in walls['captured']]} s, eager "
        f"{[round(w, 4) for w in walls['eager']]} s")
    return rec


def _spec_prefill_check(cfg, params, prompts, new_tokens: int,
                        device="cuda") -> dict:
    """The spec arm (self-draft, k = 4, hetero-tensor, sync device) at full
    width: a first run captures its prefill and verify calls, a second
    holds every call bitwise to the eager entry point on a copy of the
    pool (the verify's logits, its argmax tokens and the pool) and its
    tokens to the first run's."""
    from repro_torch.serving.spec import SpecConfig

    cb, reqs = _serve(cfg, params, prompts, device=device,
                      engine_mode="hetero-tensor", sync="device", window=8,
                      decode_width=8, new_tokens=new_tokens,
                      spec=SpecConfig(k=4))
    cb.run(reqs)
    first = [r.output for r in reqs]
    check, drafts = _CallCheck(cb), _SlotCheck(cb.drafts)
    reqs = _requests(prompts, new_tokens)
    try:
        cb.run(reqs)
    finally:
        check.undo()
        drafts.undo()
    rec = check.summary("spec")
    rec["drafts"] = drafts.summary("[graph-prefill] spec draft lanes")
    verify = [r for r in check.rows if r[0] == "verify"]
    calls = _graph_info(cb)["calls"]
    if [r.output for r in reqs] != first or not verify:
        raise AssertionError(f"[graph-prefill] spec: tokens "
                             f"{[r.output for r in reqs]} against the first "
                             f"run's {first}, {len(verify)} verify calls")
    rec.update(verify_calls=len(verify), graphs=calls, stats=cb.stats())
    log(f"[graph-prefill] spec k=4 self-draft: {len(verify)} verify and "
        f"{rec['calls'] - len(verify)} prefill and accept replays, logits, "
        f"argmax tokens, accepted tokens and pool bitwise the eager entry "
        f"point's; draft lanes {rec['drafts']['by_kind']} replays bitwise "
        f"theirs (draft cache too); tokens equal to the "
        f"first run's; graphs {calls['graphs']}, pool "
        f"{calls['pool_bytes'] / 2 ** 20:.1f} MB, capture "
        f"{calls['capture_s']:.2f}s; stats {cb.stats()}")
    del cb
    gc.collect()
    return rec


def _spec_draft_check(cfg, params, prompts, new_tokens: int,
                      device="cuda") -> dict:
    """The spec arm under host sync (self-draft, k = 4, hetero-tensor,
    width 8) at full width: a first run captures the draft lanes' prefill
    chunks and their one decode step, and the batcher's prefill, verify
    and accept calls; a second holds each call bitwise to its eager entry
    point on a copy of the draft cache (``_SlotCheck``) or of the pool
    (``_CallCheck``), tokens equal to the first run's; then runs
    alternating captured, eager, eager, captured (every call of the
    batcher and of its draft lanes eager in ``_EagerCalls``) time the
    draft lanes' prefill and rounds, tokens equal. Last, one round's
    acceptance as it runs (staged drafts, the accept call, both results
    to the host) against the eager ``greedy_verify`` it replaces, on the
    last round's inputs, 50 calls a turn, turns c, e, e, c."""
    import torch
    from repro_torch.core.sync import fence, stage
    from repro_torch.serving.sampler import greedy_verify

    t_check = time.perf_counter()
    cb, reqs = _serve(cfg, params, prompts, device=device,
                      engine_mode="hetero-tensor", sync="host", window=8,
                      decode_width=8, new_tokens=new_tokens, spec=4)
    t0 = time.perf_counter()
    cb.run(reqs)
    first_s = time.perf_counter() - t0
    first = [r.output for r in reqs]
    check, drafts = _CallCheck(cb), _SlotCheck(cb.drafts)
    reqs = _requests(prompts, new_tokens)
    try:
        cb.run(reqs)
    finally:
        check.undo()
        drafts.undo()
    rec = {"calls": check.summary("spec host"),
           "drafts": drafts.summary("[graph-dense] spec host draft lanes")}
    if [r.output for r in reqs] != first:
        raise AssertionError(f"[graph-dense] spec host: checked tokens "
                             f"{[r.output for r in reqs]}, first {first}")
    anchor, times = cb.kv.pool["k"], {"prefill": 0.0, "draft": 0.0}
    make, last = cb._call, {}

    def timed(fn, key):
        def run(*a):
            fence(anchor)
            t0 = time.perf_counter()
            out = fn(*a)
            fence(anchor)
            times[key] += time.perf_counter() - t0
            return out
        return run

    def keep_accept(kind, length):
        call = make(kind, length)
        if kind != "accept":
            return call

        def run(staged, logits):
            last["inputs"] = (staged.numpy().copy(), logits.clone())
            return call(staged, logits)
        return run

    prefill, draft = cb.drafts.prefill, cb.drafts.draft
    cb.drafts.prefill = timed(prefill, "prefill")
    cb.drafts.draft = timed(draft, "draft")
    cb._call = keep_accept
    calls, dcalls = cb._calls, cb.drafts.calls
    arms = {"captured": [], "eager": []}
    try:
        for arm in ("captured", "eager", "eager", "captured"):
            if arm == "eager":
                cb._calls, cb.drafts.calls = _EagerCalls(), _EagerCalls()
            times.update(prefill=0.0, draft=0.0)
            reqs = _requests(prompts, new_tokens)
            try:
                cb.run(reqs)
            finally:
                cb._calls, cb.drafts.calls = calls, dcalls
            if [r.output for r in reqs] != first:
                raise AssertionError(f"[graph-dense] spec host {arm}: tokens "
                                     f"{[r.output for r in reqs]}, first "
                                     f"{first}")
            arms[arm].append(dict(times))
    finally:
        cb.drafts.prefill, cb.drafts.draft, cb._call = prefill, draft, make
    drafts_np, logits = last["inputs"]
    accept = cb._calls[cb.loop_key("accept", 5)]

    def captured_accept():
        e, n = accept(*stage(drafts_np, device=cb.device), logits)
        return e.cpu(), n.cpu()

    def eager_accept():
        e, n = greedy_verify(torch.as_tensor(drafts_np, device=cb.device),
                             logits)
        return e.cpu(), n.cpu()

    accept_us = {"captured": [], "eager": []}
    outs = set()
    for arm in ("captured", "eager", "eager", "captured"):
        fn = captured_accept if arm == "captured" else eager_accept
        outs.add(str([t.tolist() for t in fn()]))
        fence(anchor)
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        accept_us[arm].append((time.perf_counter() - t0) / 50 * 1e6)
    if len(outs) != 1:
        raise AssertionError(f"[graph-dense] spec host: accept outputs {outs}")
    info = _graph_info(cb)["calls"]
    rec.update(first_s=first_s, arms=arms, accept_us=accept_us, graphs=info,
               stats=cb.stats())
    log(f"[graph-dense] spec host k=4 self-draft: {rec['calls']['calls']} "
        f"batcher calls {dict(Counter(k for k, _ in rec['calls']['order']))} "
        f"and draft lanes {rec['drafts']['by_kind']} replayed bitwise the "
        f"eager entry point (outputs, pool, draft cache); tokens equal in "
        f"every run; calls' graphs {info['graphs']}, replays "
        f"{info['replays']}, pool {info['pool_bytes'] / 2 ** 20:.1f} MB, "
        f"first calls and captures {info['capture_s']:.2f}s (first run "
        f"{first_s:.2f}s); runs c, e, e, c: draft prefill s "
        + ", ".join(f"{a['prefill']:.4f}" for a in
                    (arms["captured"][0], *arms["eager"],
                     arms["captured"][1]))
        + "; draft rounds s " + ", ".join(
            f"{a['draft']:.4f}" for a in
            (arms["captured"][0], *arms["eager"], arms["captured"][1]))
        + "; a round's acceptance us captured / eager "
        + f"{[round(u, 1) for u in accept_us['captured']]} / "
        + f"{[round(u, 1) for u in accept_us['eager']]}; stats {cb.stats()}; "
        + f"check {time.perf_counter() - t_check:.1f}s")
    del cb
    gc.collect()
    return rec


def _engine_prefill_check(cfg, params, runs, label: str,
                          two_starts: bool = False, device="cuda") -> dict:
    """phase_graph_prefill's engine cell: one engine (hetero-tensor, fast
    sync, hetero strategy) over ``runs`` ((prompt, new tokens), sharing one
    cache), first to capture, then in reverse order with each chunk held
    bitwise to the model's own prefill on a copy of the cache (logits and
    cache), then with eager calls (tokens equal), then timed alternating
    captured, eager, eager, captured. ``n_compiles`` must be the distinct
    chunk lengths plus the captured decode loops; with ``two_starts`` a
    chunk length must replay at two starts."""
    import torch
    from repro_torch.core.engine import EngineStats, InferenceEngine

    eng = InferenceEngine(cfg, params, mode="hetero-tensor",
                          prefill_strategy="hetero", fast_sync=True,
                          device=device)
    lengths = {c for p, _ in runs for c, _ in eng._bucket_chunks(p.shape[1])}
    captured = [eng.generate(p, n)[0].tolist() for p, n in runs]
    compiles, compile_s = eng.stats.n_compiles, eng.stats.compile_s
    decode_graphs = eng.graph_stats()["graphs"]
    if compiles != len(lengths) + decode_graphs:
        raise AssertionError(f"[graph-prefill] {label}: n_compiles "
                             f"{compiles}, chunk lengths {sorted(lengths)}, "
                             f"decode graphs {decode_graphs}")
    inner, rows = eng.prefill_chunk, []

    def checked(cache, max_len, piece, start):
        copy = {k: t.clone() for k, t in cache.items()}
        want = eng._prefill(eng.params, piece, copy, start_index=start)[0]
        key = eng.call_key(piece.shape[1], piece.shape[0], max_len,
                           start == 0)
        replayed = eng._calls[key].graph is not None
        strict = eng.device.type == "cuda"    # no host sync in a replay
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = inner(cache, max_len, piece, start)
        finally:
            if strict:
                torch.cuda.set_sync_debug_mode("default")
        rows.append((piece.shape[1], start, replayed,
                     bool(torch.equal(got, want)), _same_state(copy, cache)))
        return got

    eng.prefill_chunk = checked
    try:
        checked_tokens = [eng.generate(p, n)[0].tolist()
                          for p, n in reversed(runs)][::-1]
    finally:
        eng.prefill_chunk = inner
    calls, eager_tokens = eng._calls, []
    eng._calls = _EagerCalls()
    try:
        eager_tokens = [eng.generate(p, n)[0].tolist() for p, n in runs]
    finally:
        eng._calls = calls
    if not all(r[2] and r[3] and r[4] for r in rows) \
            or not captured == checked_tokens == eager_tokens:
        raise AssertionError(f"[graph-prefill] {label}: chunks (length, "
                             f"start, replayed, logits, cache) {rows}; "
                             f"tokens captured {captured}, checked "
                             f"{checked_tokens}, eager {eager_tokens}")
    starts = {}
    for c, start, *_ in rows:
        starts.setdefault(c, set()).add(start)
    if two_starts and max(len(s) for s in starts.values()) < 2:
        raise AssertionError(f"[graph-prefill] {label}: no chunk length "
                             f"replayed at two starts: {starts}")
    prefill_s, launches = {"captured": [], "eager": []}, None
    for arm in ("captured", "eager", "eager", "captured"):
        eng.stats = EngineStats()
        if arm == "eager":
            eng._calls = _EagerCalls()
        _zero_counts()
        try:
            for p, n in runs:
                eng.generate(p, n)
        finally:
            eng._calls = calls
        prefill_s[arm].append(eng.stats.prefill_s)
        launches = launches or _read_counts()    # the first captured pass
    info = _graph_info(eng)["calls"]
    rec = {"chunks": rows, "starts": {c: sorted(s) for c, s in
                                      starts.items()},
           "n_compiles": compiles, "chunk_lengths": sorted(lengths),
           "decode_graphs": decode_graphs, "compile_s": compile_s,
           "prefill_s": prefill_s, "graphs": info, "tokens": captured,
           "launches": launches}
    log(f"[graph-prefill] {label}: {len(rows)} chunks replayed (length: "
        f"starts {rec['starts']}) with no host sync, logits and cache "
        f"bitwise the model's own prefill, tokens equal to eager prefill's; "
        f"n_compiles {compiles} = {len(lengths)} chunk lengths + "
        f"{decode_graphs} decode graph(s) (first calls and captures "
        f"{compile_s:.2f}s); graphs {info['graphs']}, replays "
        f"{info['replays']}, pool {info['pool_bytes'] / 2 ** 20:.1f} MB, "
        f"capture {info['capture_s']:.2f}s; prefill s captured "
        f"{[round(t, 4) for t in prefill_s['captured']]}, eager "
        f"{[round(t, 4) for t in prefill_s['eager']]}; launches a captured "
        f"pass {launches}")
    if device == "cuda" and not launches["flash_attention"]:
        raise AssertionError(f"[graph-prefill] {label}: no flash launch")
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def phase_graph_prefill(cfg, params, paged=None, seed: int = 4) -> dict:
    """M2b on the card at full width, bf16, seeded weights: the prefill and
    verify dispatches as CUDA graphs, one per chunk length, each held to
    the model's own entry point run eagerly on a copy of the pool or cache.
    For llama3-8b: the paged cells' records that phase_full's V5E
    hetero-tensor arms made with ``_paged_prefill_check`` (fp, int8 + int8
    KV, W4A16: ``paged``), the spec arm (``_spec_prefill_check``) and the
    engine on prompts 428 (one new token) and 300 (129), one cache, so the
    44-token chunk's graph serves starts 384 and 256; for zamba2-2.7b
    (``paged`` None) the engine on prompt 600 twice (chunks 512 and 88:
    the SSD chunk kernel and the flash kernel's device-start entry
    replayed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    if paged is not None:
        for label, *_ in FULL_PAIRS:
            out[f"paged {label}"] = paged[label]["graph_prefill"]
        out["spec"] = _spec_prefill_check(
            cfg, params, paged["fp"]["prompts"], 16)
        out["spec host"] = _spec_draft_check(
            cfg, params, paged["fp"]["prompts"], 16)
        p428, p300 = (rng.integers(0, cfg.vocab_size, (1, n))
                      for n in (428, 300))
        runs = [(p428, 1), (p300, 129)]
    else:
        p600 = rng.integers(0, cfg.vocab_size, (1, 600))
        runs = [(p600, 16), (p600, 16)]
    out[f"engine {cfg.name}"] = _engine_prefill_check(
        cfg, params, runs, f"engine {cfg.name}", two_starts=paged is not None)
    return out


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

    chunk, place = cb._prefill_chunk, cb._place

    def keep_logits(*a):
        last["logits"] = out = chunk(*a)
        return out

    def place_and_record(req, seq, first):
        timers["first_logits"][req.rid] = last["logits"][0, -1].float()
        return place(req, seq, first)

    admit, window = cb._admit, cb._decode_window
    cb._prefill_chunk = keep_logits
    cb._place = place_and_record
    cb._admit = timed(admit, "prefill")
    cb._decode_window = timed(window, "decode")

    def undo():
        cb._prefill_chunk, cb._place = chunk, place
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
    graph = torch.cuda.CUDAGraph()  # repolint-torch: disable=capture-hygiene -- times a kernel's launches without the host's cost; no loop of the port, so not core.sync's CapturedLoop
    with torch.cuda.graph(graph):  # repolint-torch: disable=capture-hygiene -- the capture of the same timing graph
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
            eng._calls = _EagerCalls()     # the eager prefill's overlap
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

    chunk, place, finish = (cb._prefill_chunk, cb._place,
                            cb._finish_admission)

    def keep_logits(piece, *a):
        fence(anchor)
        t0 = time.perf_counter()
        out = chunk(piece, *a)
        fence(anchor)
        dt = time.perf_counter() - t0
        rec["prefill"] += dt
        n_s = rec["prefill_by_len"].setdefault(int(piece.shape[1]), [0, 0.0])
        n_s[0] += 1
        n_s[1] += dt
        last["logits"] = out
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

    cb._prefill_chunk = keep_logits
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
    one batcher: "dense" (or "dense int8" / "dense w4a16": quantized
    weights), or paged "host" / "device" (hetero-tensor; host with the
    prefix cache). Returns the streams and the server's counts."""
    import torch
    from repro_torch.serving.ingress import (AsyncServer, arrival_times,
                                             open_loop_workload)
    from repro_torch.serving.scheduler import ContinuousBatcher, PagedBatcher
    from repro_torch.serving.telemetry import FakeClock
    from repro_torch.serving.trace import Tracer, counter_reconciliation
    clock = FakeClock()
    tracer = Tracer(clock) if traced else None
    if batcher.startswith("dense"):
        cb = ContinuousBatcher(cfg, params, max_batch=3, max_len=F0_MAX_LEN,
                               buckets=F0_POOL["buckets"], tracer=tracer,
                               weight_quant=(batcher.split() + [None])[1],
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
    if not batcher.startswith("dense"):
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
    the card's tokens equal the CPU's; so does the dense batcher with int8
    and W4A16 weights (its captured calls record the dequantization), held
    to the sequential reference on the quantized weights."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.quant import quantize_params
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
        dense_ref = {wq: [_dense_sequential(
            cfg, quantize_params(p, cfg, wq) if wq else p, x, m, device)
            for x, m in zip(prompts, budgets)]
            for wq in (None, "int8", "w4a16")}
        one = PagedBatcher(cfg, p, **{**F0_POOL, "decode_width": 1},
                           cache_dtype=torch.float32, device=device)
        reqs = [Request(rid=i, prompt=x, max_new_tokens=m)
                for i, (x, m) in enumerate(zip(prompts, budgets))]
        one.run(reqs)
        paged_ref = [r.output for r in reqs]
        for batcher, want in (("dense", dense_ref[None]),
                              ("dense int8", dense_ref["int8"]),
                              ("dense w4a16", dense_ref["w4a16"]),
                              ("host", paged_ref), ("device", paged_ref)):
            run = _f0_serve(cfg, p, batcher, device)
            log(f"[front-end] smoke {batcher} on {device}: preemptions "
                f"{run['preemptions']}, stats {run['stats']}")
            if run["tokens"] != want:
                raise AssertionError(
                    f"[front-end] smoke {batcher} on {device}: tokens "
                    f"{run['tokens']} differ from the sequential "
                    f"reference's {want}")
            if not batcher.startswith("dense") and run["preemptions"] < 1:
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
    for batcher in ("dense", "dense int8", "dense w4a16", "host", "device"):
        if len({str(got[batcher, d]) for d in devices}) != 1:
            raise AssertionError(f"[front-end] smoke {batcher}: card and "
                                 "CPU tokens differ")
    log(f"[front-end] smoke: dense (fp, int8 and W4A16 weights), paged host "
        f"and device (each preempted and resumed) give the sequential "
        f"reference's tokens on "
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
    MonotonicClock. A first run captures the batcher's calls (one per
    chunk length, one decode step); a second holds every replay bitwise to
    the eager entry point on a copy of the cache (``_SlotCheck``); then
    timed runs alternate captured, eager, eager, captured (``_EagerCalls``
    for the eager ones), tokens equal, prefill and decode seconds from
    fenced timers on the batcher's calls. The first captured timed run's
    first-token logits are held to the paged engine-less fp arm's (cosine
    >= 0.999), and its launches (a replay adds its capture's) are the
    kernels line's."""
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
    make = cb._call

    def timed_call(kind, chunk=None):
        call = make(kind, chunk)

        def run(*inputs):
            fence(anchor)
            t0 = time.perf_counter()
            out = call(*inputs)
            fence(anchor)
            rec[kind] += time.perf_counter() - t0
            if kind == "prefill":     # admissions go in rid order here
                if int(inputs[2]) == 0:
                    rec["first"].append(None)
                rec["first"][-1] = out[0, -1].float().clone()
            return out
        return run

    def serve():
        clock = MonotonicClock()
        server = AsyncServer(cb, clock=clock)
        fence(anchor)
        t0 = clock.now()
        handles = server.run_sync(open_loop_workload(
            prompts, [new] * len(prompts), [t0] * len(prompts)))
        fence(anchor)
        wall = clock.now() - t0
        if any(len(h.tokens) != new for h in handles):
            raise AssertionError(f"[front-end] F2: streams "
                                 f"{[len(h.tokens) for h in handles]}")
        return [h.tokens for h in handles], wall, server.stats()

    t0 = time.perf_counter()
    want, first_wall, _ = serve()            # each call's first use: capture
    first_s = time.perf_counter() - t0
    check = _SlotCheck(cb)
    try:
        checked_tokens, _, _ = serve()
    finally:
        check.undo()
    checked = check.summary("[graph-dense] F2")
    runs, tokens, calls = {"captured": [], "eager": []}, [checked_tokens], \
        cb._calls
    cb._call = timed_call
    try:
        for arm in ("captured", "eager", "eager", "captured"):
            if arm == "eager":
                cb._calls = _EagerCalls()
            rec.update(prefill=0.0, decode=0.0, first=[])
            counted = arm == "captured" and not runs["captured"]
            if counted:
                _zero_counts()
            try:
                toks, wall, stats = serve()
            finally:
                cb._calls = calls
            if counted:
                launches, firsts, first_stats = (_read_counts(),
                                                 rec["first"], stats)
            tokens.append(toks)
            tok = sum(len(t) for t in toks)
            runs[arm].append({"wall_s": wall, "tok_per_s": tok / wall,
                              "prefill_s": rec["prefill"],
                              "decode_s": rec["decode"]})
    finally:
        cb._call = make
    if any(t != want for t in tokens):
        raise AssertionError(f"[graph-dense] F2: tokens of the checked and "
                             f"alternating runs differ from the first "
                             f"run's: {tokens} against {want}")
    plain = full["fp"]["plain_first_logits"]
    cos = []
    for rid, a in enumerate(firsts):
        b = plain[rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"[front-end] F2 request {rid}: non-finite")
        cos.append(float(torch.nn.functional.cosine_similarity(a, b, dim=0)))
    same = sum(x == y for h, o in zip(want, full["fp"]["plain_outputs"])
               for x, y in zip(h, o))
    c0 = runs["captured"][0]
    tok = sum(len(t) for t in want)
    log(f"[front-end] F2 dense: {tok} tokens in {c0['wall_s']:.3f}s "
        f"({c0['tok_per_s']:.2f} tok/s), captured; prefill "
        f"{c0['prefill_s']:.3f}s, decode {c0['decode_s']:.3f}s; stats "
        f"{first_stats}; launches {launches}; first-token cos vs the paged "
        f"engine-less arm {[round(c, 6) for c in cos]}; tokens equal to its "
        f"{same}/{tok}")
    info = cb.graph_stats()
    by_kind = {kind: [c for key, c in cb._calls.items() if key[0] == kind]
               for kind in ("decode", "prefill")}
    capture_s = {kind: sum(getattr(c, "capture_s", 0.0) for c in cs)
                 for kind, cs in by_kind.items()}
    log(f"[graph-dense] F2: graphs {info['graphs']} decode + "
        f"{info['calls']['graphs']} prefill (chunk lengths "
        f"{sorted(key[1] for key in cb._calls if key[0] == 'prefill')}), "
        f"replays {info['replays']} + {info['calls']['replays']}, pool "
        f"{info['pool_bytes'] / 2 ** 20:.1f} + "
        f"{info['calls']['pool_bytes'] / 2 ** 20:.1f} MB, first calls and "
        f"captures {capture_s['decode']:.2f} + {capture_s['prefill']:.2f}s "
        f"(first run {first_s:.2f}s, wall {first_wall:.3f}s); "
        f"{checked['calls']} calls {checked['by_kind']} replayed bitwise the "
        f"eager entry point (outputs and cache); tokens of the checked and "
        f"alternating runs equal; runs c, e, e, c: tok/s "
        + ", ".join(f"{r['tok_per_s']:.2f}" for r in
                    (runs["captured"][0], *runs["eager"],
                     runs["captured"][1]))
        + "; prefill s " + ", ".join(
            f"{r['prefill_s']:.4f}" for r in
            (runs["captured"][0], *runs["eager"], runs["captured"][1]))
        + "; decode s " + ", ".join(
            f"{r['decode_s']:.4f}" for r in
            (runs["captured"][0], *runs["eager"], runs["captured"][1])))
    if len(cos) != len(prompts) or min(cos) < 0.999 or \
            (device == "cuda" and (launches["flash_attention"] <= 0
                                   or launches["decode_attention"] <= 0
                                   or info["graphs"] != 1)):
        raise AssertionError(f"[front-end] F2: cosines {cos}, launches "
                             f"{launches}, graphs {info}")
    return {"launches": launches, "tok_per_s": c0["tok_per_s"],
            "wall_s": c0["wall_s"], "prefill_s": c0["prefill_s"],
            "decode_s": c0["decode_s"], "cos": cos, "runs": runs,
            "graphs": {**info, "capture_s": capture_s}, "checked": checked}


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


# ------------------------------------------------------------- phase T --

# the reference's tests/test_tp_serving.py ARMS: PagedBatcher kwargs
TP_ARMS = {
    "host": dict(sync="host"),
    "device": dict(sync="device", window=3),
    "mixed": dict(sync="device", window=3, mixed_batch=True),
    "prefix_cache": dict(sync="host", prefix_cache=True),
    "spec_self": dict(sync="host", spec=2),
    "w4a16_kv_int8": dict(sync="device", window=3, weight_quant="w4a16",
                          kv_quant="int8"),
    "w_int8": dict(sync="host", weight_quant="int8"),
    "kv_int8": dict(sync="host", kv_quant="int8"),
}
# (label, PagedBatcher kwargs) of T1's llama3-8b pairs
TP_FULL_ARMS = (
    ("fp window", dict(sync="device")),
    ("host tick", dict(sync="host")),
    ("mixed", dict(sync="device", mixed_batch=True)),
    ("w4a16+kv8", dict(sync="device", weight_quant="w4a16",
                       kv_quant="int8")),
)
TP_COS = 0.999          # T2's first-token gate against T1's DeviceLayout


def _tp_smoke_model(device: str):
    """The fp32 llama3 smoke model on ``device``, seeded on the CPU (the
    same weights on every device and rank)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(7),
                                   device="cpu")
    return cfg, _to_device(params, device)


def _tp_smoke_serve(cfg, params, device, mesh=None, **kw):
    """One closed-loop serve of the smoke prompts (3 requests, 8 new tokens
    each, block 16, width 3): (tokens, stats, graphs), the pool drained."""
    import numpy as np
    from repro_torch.serving.scheduler import PagedBatcher
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 33)]
    cb = PagedBatcher(cfg, params, num_blocks=40, block_size=16,
                      max_blocks_per_seq=4, decode_width=3, buckets=(16, 32),
                      mesh=mesh, device=device, **kw)
    reqs = _requests(prompts, 8)
    cb.run(reqs)
    cb.kv.assert_drained()
    if not all(r.done and len(r.output) == 8 for r in reqs):
        raise AssertionError("a smoke request did not complete")
    return [r.output for r in reqs], cb.stats(), cb.graph_stats()


def _tp_cpu_rank(rank: int, arms) -> dict:
    """T0's TP = 2 run on one of two gloo CPU ranks: every arm's (tokens,
    stats)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(2)
    cfg, params = _tp_smoke_model("cpu")
    mesh = make_host_mesh(1, 2, device="cpu")
    return {arm: _tp_smoke_serve(cfg, params, "cpu", mesh,
                                 **TP_ARMS[arm])[:2] for arm in arms}


def _tp_t0(mesh1, device="cuda") -> dict:
    """T0: the eight arms on the card through DeviceLayout and through a
    MeshLayout over the one-rank NCCL group, and TP = 2 over gloo on two
    CPU ranks: the same tokens everywhere, pools drained, ``tp`` and the
    capture state as the layout says."""
    from repro_torch.launch.mesh import spawn_ranks
    cfg, params = _tp_smoke_model(device)
    card = device == "cuda"
    t0 = time.perf_counter()
    cpu = spawn_ranks(_tp_cpu_rank, 2, list(TP_ARMS), device="cpu")
    spawn_s = time.perf_counter() - t0
    out = {}
    for arm, kw in TP_ARMS.items():
        dev, dev_stats, _ = _tp_smoke_serve(cfg, params, device, **kw)
        one, one_stats, graphs = _tp_smoke_serve(cfg, params, device, mesh1,
                                                 **kw)
        if dev_stats["tp"] != 1 or one_stats["tp"] != 1 \
                or one_stats["captured"] is not card:
            raise AssertionError(f"[tp] T0 {arm}: stats {one_stats}")
        # the spec arm's verify is eager, and under host sync so is its
        # draft round: every other arm decodes through captured loops
        if card and "spec" not in kw and graphs["graphs"] < 1:
            raise AssertionError(f"[tp] T0 {arm}: no captured graph")
        for rank, res in enumerate(cpu):
            toks, stats = res[arm]
            if stats["tp"] != 2 or stats["captured"] is not False:
                raise AssertionError(f"[tp] T0 {arm} CPU rank {rank}: "
                                     f"stats {stats}")
            if toks != dev:
                raise AssertionError(f"[tp] T0 {arm}: CPU TP=2 rank {rank} "
                                     f"tokens {toks} != card {dev}")
        if one != dev:
            raise AssertionError(f"[tp] T0 {arm}: one-rank NCCL tokens "
                                 f"{one} != DeviceLayout {dev}")
        out[arm] = {"tokens": dev, "graphs": graphs}
        log(f"[tp] T0 {arm}: DeviceLayout = MeshLayout(1-rank NCCL, "
            f"captured, {graphs['graphs']} graph(s)) = TP=2 gloo CPU ranks; "
            f"tokens {dev}")
    log(f"[tp] T0: 8 arms equal on the card, the one-rank NCCL group and two "
        f"gloo CPU ranks (CPU spawn + run {spawn_s:.1f}s)")
    return out


def _tp_instrument(cb) -> dict:
    """``_instrument``'s timers, the host tick timed under "decode" too."""
    from repro_torch.core.sync import fence
    timers, _ = _instrument(cb)
    tick = cb._decode_tick

    def timed_tick(*a, **k):
        fence(cb.kv.pool["k"])
        t = time.perf_counter()
        out = tick(*a, **k)
        fence(cb.kv.pool["k"])
        timers["decode"] += time.perf_counter() - t
        return out

    cb._decode_tick = timed_tick
    return timers


def _tp_full_batcher(cfg, params, prompts, mesh, kw, device="cuda"):
    """A T1 batcher (block 32, width 8, window 8, 16 new tokens) after its
    first run over ``prompts``, which captures its loops; with its timers
    (``_instrument``, the tick timed too), first run's tokens and, on host
    ticks, each step's top-2 logit margin (``_tp_margins``)."""
    from repro_torch.core.sync import fence
    t0 = time.perf_counter()
    cb, reqs = _serve(cfg, params, prompts, device=device, engine_mode=None,
                      window=8, decode_width=8, new_tokens=16, mesh=mesh,
                      **kw)
    timers = _tp_instrument(cb)
    margins = _tp_margins(cb)
    cb.run(reqs)
    fence(cb.kv.pool["k"])
    return {"cb": cb, "timers": timers, "setup_s": time.perf_counter() - t0,
            "first": [r.output for r in reqs],
            "first_logits": dict(timers["first_logits"]),
            "margins": dict(margins)}


def _tp_timed_run(arm, prompts) -> dict:
    import torch
    from repro_torch.core.sync import fence
    cb, timers = arm["cb"], arm["timers"]
    timers.update(prefill=0.0, decode=0.0, first_logits={})
    reqs = _requests(prompts, 16)
    fence(cb.kv.pool["k"])
    card = cb.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cb.run(reqs)
    fence(cb.kv.pool["k"])
    wall = time.perf_counter() - t0
    cb.kv.assert_drained()
    tok = sum(len(r.output) for r in reqs)
    return {"wall_s": wall, "tok_per_s": tok / wall,
            "prefill_s": timers["prefill"], "decode_s": timers["decode"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if card
            else 0.0, "outputs": [r.output for r in reqs]}


def _tp_t1(cfg, params, mesh1, device="cuda") -> dict:
    """T1: llama3-8b at full width, DeviceLayout against MeshLayout over the
    one-rank NCCL group on each of TP_FULL_ARMS: bitwise-equal tokens, the
    mesh's loops captured with the collectives inside; timed runs in the
    order device, mesh, mesh, device."""
    import torch
    prompts = full_prompts(cfg)
    out = {}
    for label, kw in TP_FULL_ARMS:
        arms = {"device": _tp_full_batcher(cfg, params, prompts, None, kw,
                                           device),
                "mesh": _tp_full_batcher(cfg, params, prompts, mesh1, kw,
                                         device)}
        runs = {"device": [], "mesh": []}
        for which in ("device", "mesh", "mesh", "device"):
            runs[which].append(_tp_timed_run(arms[which], prompts))
        want = arms["device"]["first"]
        for which, rs in runs.items():
            for r in rs + [{"outputs": arms[which]["first"]}]:
                if r["outputs"] != want:
                    raise AssertionError(f"[tp] T1 {label}: {which} tokens "
                                         f"differ from DeviceLayout's")
        row = {"outputs": want}
        for which in ("device", "mesh"):
            cb = arms[which]["cb"]
            g = _graph_info(cb)
            rs = runs[which]
            row[which] = {
                "tok_per_s": [r["tok_per_s"] for r in rs],
                "prefill_s": [r["prefill_s"] for r in rs],
                "decode_s": [r["decode_s"] for r in rs],
                "peak_gb": max(r["peak_gb"] for r in rs),
                "setup_s": arms[which]["setup_s"], "graphs": g,
                "stats": cb.stats()}
            if device == "cuda" and g["graphs"] < 1:
                raise AssertionError(f"[tp] T1 {label} {which}: no graph")
            log(f"[tp] T1 {label} {which}: tok/s "
                + " / ".join(f"{r['tok_per_s']:.2f}" for r in rs)
                + ", prefill s " + " / ".join(f"{r['prefill_s']:.4f}"
                                              for r in rs)
                + ", decode s " + " / ".join(f"{r['decode_s']:.4f}"
                                             for r in rs)
                + f"; peak {row[which]['peak_gb']:.2f} GB (both batchers "
                f"held); setup {arms[which]['setup_s']:.1f}s; graphs "
                f"{g['graphs']}, capture {g['capture_s']:.2f}s, pool "
                f"{g['pool_bytes'] / 1e6:.1f} MB; stats {cb.stats()}")
        if row["mesh"]["stats"]["captured"] is not (device == "cuda"):
            raise AssertionError(f"[tp] T1 {label}: mesh loops not captured")
        if label == "fp window":
            row["first_logits"] = arms["device"]["first_logits"]
        if label == "host tick":
            row["margins"] = arms["device"]["margins"]
        log(f"[tp] T1 {label}: tokens bitwise equal, DeviceLayout and "
            "MeshLayout(1-rank NCCL), first and timed runs")
        out[label] = row
        del arms
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_t3(mesh1, device="cuda") -> dict:
    """T3: split-KV decode over the one-rank NCCL group at llama3-8b's decode
    shape (a [8, 4096, 8, 128] bf16 cache, 32 query heads) against the plain
    decode and kernel 2.5, cache writes bitwise; ``compressed_psum`` on the
    group against its arithmetic on the CPU."""
    import torch
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.split_kv import (
        local_shard, split_kv_decode_update_attend)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device=device).manual_seed(3)
    B, S, Hq, Hkv, D = 8, 4096, 32, 8, 128
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dt)

    q, kn, vn = randn(B, 1, Hq, D), randn(B, 1, Hkv, D), randn(B, 1, Hkv, D)
    kc, vc = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    tol = DTYPE_TOL["bfloat16"]
    rows = {}
    for pos in (0, 1, 1234, S - 1):
        ck, cv = local_shard(kc, mesh1).clone(), local_shard(vc, mesh1).clone()
        o, ck, cv = split_kv_decode_update_attend(
            q, kn, vn, ck, cv, torch.tensor(pos, device=device), mesh1)
        wk, wv = kc.clone(), vc.clone()
        wk[:, pos], wv[:, pos] = kn[:, 0], vn[:, 0]
        if not (torch.equal(ck, wk) and torch.equal(cv, wv)):
            raise AssertionError(f"[tp] T3 pos {pos}: cache writes differ")
        plain = decode_attention_ref(q[:, 0], wk, wv, pos + 1)
        kern = decode_attention(q[:, 0], wk, wv, pos + 1)
        e_plain = float((o[:, 0].float() - plain.float()).abs().max())
        e_kern = float((o[:, 0].float() - kern.float()).abs().max())
        if not (e_plain <= tol and e_kern <= tol):
            raise AssertionError(f"[tp] T3 pos {pos}: split-KV vs plain "
                                 f"{e_plain:.3g}, vs kernel 2.5 {e_kern:.3g} "
                                 f"> {tol}")
        rows[pos] = {"err_plain": e_plain, "err_kernel": e_kern}
    split_ms = kern_ms = plain_ms = float("nan")      # timed on the card
    if device == "cuda":
        pos = torch.tensor(S - 1, device=device)
        ck, cv = kc.clone(), vc.clone()
        split_ms = cuda_time_ms(lambda: split_kv_decode_update_attend(
            q, kn, vn, ck, cv, pos, mesh1))
        kern_ms = cuda_time_ms(lambda: decode_attention(q[:, 0], kc, vc, S))
        plain_ms = cuda_time_ms(
            lambda: decode_attention_ref(q[:, 0], kc, vc, S))
    x = torch.randn((4096, 1024), generator=g, device=device)
    got = compressed_psum(x, mesh1.get_group("model"))
    xc = x.cpu()
    amax = xc.abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    want = torch.clamp(torch.round(xc / scale), -127, 127) * scale
    if not torch.equal(got.cpu(), want):
        raise AssertionError("[tp] T3 compressed_psum differs from its CPU "
                             "arithmetic")
    log(f"[tp] T3 split-KV decode [8, 4096, 8, 128] bf16 over the 1-rank "
        f"NCCL group: max err vs plain / kernel 2.5 "
        + ", ".join(f"pos {p}: {r['err_plain']:.3g} / {r['err_kernel']:.3g}"
                    for p, r in rows.items())
        + f" (tol {tol}); cache writes bitwise; ms split-KV {split_ms:.4f}, "
        f"kernel 2.5 {kern_ms:.4f}, plain {plain_ms:.4f}; compressed_psum "
        "equal to its CPU arithmetic")
    return {"rows": rows, "split_kv_ms": split_ms, "kernel_ms": kern_ms,
            "plain_ms": plain_ms}


A2_SITES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head")
A2_M = (256, 8)         # a prefill chunk's rows, and decode width 8


def _tp_a2(cfg, params, device="cuda") -> dict:
    """A2: does a column half of a bf16 product round as those columns of
    the whole product? MeshLayout computes ``x @ w[:, s]`` where
    DeviceLayout computes ``(x @ w)[:, s]``. For each projection site of
    layer 0 (and the untied head), at M = 256 and M = 8, seeded inputs,
    both halves compared bitwise, with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    at PyTorch's default and off: one line per (setting, site, M) with the
    count of differing elements and the largest difference."""
    import torch
    lp = params["layers"]
    ws = {"wq": lp["attn"]["wq"][0], "wk": lp["attn"]["wk"][0],
          "wv": lp["attn"]["wv"][0], "wo": lp["attn"]["wo"][0],
          "w_gate": lp["ffn"]["w_gate"][0], "w_up": lp["ffn"]["w_up"][0],
          "w_down": lp["ffn"]["w_down"][0], "head": params["head"]}
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for setting in (default, False):
            flags.allow_bf16_reduced_precision_reduction = setting
            for site in A2_SITES:
                w = ws[site]
                n = w.shape[1] // 2
                halves = [w[:, i * n:(i + 1) * n].contiguous()
                          for i in range(2)]
                for M in A2_M:
                    g = torch.Generator(device=device).manual_seed(M)
                    x = torch.randn((M, w.shape[0]), generator=g,
                                    device=device).to(w.dtype)
                    whole = x @ w
                    diff, worst = 0, 0.0
                    for i, h in enumerate(halves):
                        part = x @ h
                        ref = whole[:, i * n:(i + 1) * n]
                        diff += int((part != ref).sum())
                        worst = max(worst, float(
                            (part.float() - ref.float()).abs().max()))
                    rows.append({"reduced_precision_reduction": setting,
                                 "site": site, "M": M, "K": w.shape[0],
                                 "N": w.shape[1], "differing": diff,
                                 "of": M * w.shape[1], "max_diff": worst})
                    log(f"[tp] A2 reduced-precision-reduction={setting} "
                        f"{site} M={M} K={w.shape[0]} N={w.shape[1]}: "
                        f"{diff} of {M * w.shape[1]} elements differ, "
                        f"largest {worst:.6g}")
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    off = [r for r in rows if r["reduced_precision_reduction"] is False]
    on = [r for r in rows if r["reduced_precision_reduction"] is default]
    log(f"[tp] A2 summary: flag default ({default}) "
        f"{sum(r['differing'] for r in on)} differing elements over "
        f"{len(on)} site shapes; flag off "
        f"{sum(r['differing'] for r in off)} over {len(off)}")
    return {"default": default, "rows": rows}


T4_BATCH, T4_PROMPT, T4_CACHE, T4_NEW = 8, 1024, 4096, 16


def _t4_run(prefill, decode, cache, toks) -> dict:
    """One prefill of ``toks`` into the zeroed ``cache``, then T4_NEW
    greedy decode steps: logits, tokens and the fenced times."""
    import torch
    from repro_torch.core.sync import fence
    for name in ("k", "v", "index"):
        cache[name].zero_()
    fence(cache["k"])
    t0 = time.perf_counter()
    logits, cache = prefill(toks, cache)
    fence(logits)
    prefill_s = time.perf_counter() - t0
    out, tokens = [logits], []
    t0 = time.perf_counter()
    for _ in range(T4_NEW):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tokens.append(tok)
        logits, cache = decode(tok, cache)
        out.append(logits)
    fence(logits)
    return {"logits": out, "tokens": torch.cat(tokens, 1),
            "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def _tp_t4(cfg, params, mesh1, device="cuda") -> dict:
    """T4: ``make_step_and_specs`` (launch/steps.py) for llama3-8b at full
    width and depth over the one-rank NCCL group: a prefill of 8 prompts
    of 1024 tokens into a 4096-token cache, then 16 greedy decode steps,
    in KV modes "head" (the decode kernel on the cache's heads) and "seq"
    (the split-KV decode on its sequence shard), against the unsharded
    model's ``prefill`` / ``decode_step`` on the same cache (in "seq" mode
    under ``split_kv_enabled``, the model's own split-KV path): the step
    plan skips a one-rank group's collectives (the split-KV combine's
    all-reduces still run), so tokens and logits must be bitwise equal.
    Times (each arm warmed up on a 64-token prompt first, then the model,
    then the step) and the launches of kernels 2.4 / 2.5 of the sharded
    run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import (shard_tensor, shard_tree,
                                                  split_kv_enabled)
    from repro_torch.launch.steps import make_step_and_specs
    from repro_torch.models import build_model
    from repro_torch.training.tree import tree_map
    model = build_model(cfg)
    dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=T4_CACHE,
                              global_batch=T4_BATCH)
    pre = dataclasses.replace(dec, kind="prefill")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (T4_BATCH, T4_PROMPT))).to(device)
    cache = model.init_cache(batch=T4_BATCH, max_len=T4_CACHE, device=device)
    out = {}
    for kv_mode in ("head", "seq"):
        pstep, (pargs, tok_arg, _), _ = make_step_and_specs(
            cfg, mesh1, pre, kv_mode=kv_mode)
        dstep, _, _ = make_step_and_specs(cfg, mesh1, dec, kv_mode=kv_mode)
        # one rank: every block is the whole tensor (views, no copy)
        local = shard_tree(params, tree_map(lambda a: a.spec, pargs), mesh1)
        split = dstep.use_split

        def plain_decode(tok, c):
            with split_kv_enabled(split):
                return model.decode_step(params, tok, c)

        arms = {"plain": (lambda t, c: model.prefill(params, t, c),
                          plain_decode, toks),
                "sharded": (lambda t, c: pstep(local, t, c),
                            lambda t, c: dstep(local, t, c),
                            shard_tensor(toks, tok_arg.spec, mesh1))}
        with torch.no_grad():
            for prefill, decode, t in arms.values():    # warm-ups
                logits, c = prefill(t[:, :64], cache)
                decode(logits[:, -1].argmax(-1, keepdim=True), c)
            plain = _t4_run(*arms["plain"][:2], cache, toks)
            _zero_counts()
            sharded = _t4_run(*arms["sharded"][:2], cache,
                              arms["sharded"][2])
            counts = _read_counts()
        same = (torch.equal(plain["tokens"], sharded["tokens"])
                and all(torch.equal(a, b) for a, b in
                        zip(plain["logits"], sharded["logits"])))
        row = {"kv_mode": dstep.kv_mode, "split": split,
               "bitwise": same,
               "prefill_s": sharded["prefill_s"],
               "decode_s": sharded["decode_s"],
               "plain_prefill_s": plain["prefill_s"],
               "plain_decode_s": plain["decode_s"],
               "launches": {k: counts[k] for k in ("flash_attention",
                                                   "decode_attention")}}
        log(f"[tp] T4 {kv_mode}: make_step_and_specs over the one-rank NCCL "
            f"mesh, {T4_BATCH} x {T4_PROMPT} prefill into {T4_CACHE}, "
            f"{T4_NEW} decode steps (split-KV {split}): tokens and logits "
            f"bitwise equal to the model's: {same}; prefill "
            f"{sharded['prefill_s']:.4f}s (model {plain['prefill_s']:.4f}s), "
            f"decode {sharded['decode_s']:.4f}s for {T4_NEW} steps (model "
            f"{plain['decode_s']:.4f}s); launches {row['launches']}")
        if not same:
            raise AssertionError(f"[tp] T4 {kv_mode}: the sharded step's "
                                 "tokens or logits differ from the model's")
        if device == "cuda" and (counts["flash_attention"] != cfg.n_layers
                                 or 
                                 counts["decode_attention"]
                                 != (0 if split
                                     else cfg.n_layers * T4_NEW)):
            raise AssertionError(f"[tp] T4 {kv_mode}: launches {counts}")
        out[kv_mode] = row
        del pstep, dstep, local, plain, sharded
        gc.collect()
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp(cfg, params, device="cuda") -> dict:
    """Phase T (the llama3 weights on the card): T0, T1, T3 and T4 over a
    one-rank NCCL group that this process joins and leaves (gloo with
    ``device="cpu"``, the CPU rehearsal), then A2's rounding table."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    with tempfile.TemporaryDirectory() as tmp:
        init_ranks(1, 0, f"file://{tmp}/rendezvous", device=device)
        try:
            mesh1 = make_host_mesh(1, 1, device=device)
            out = {}
            t0 = time.perf_counter()
            out["T0"] = _tp_t0(mesh1, device)
            log(f"[time] phase T T0: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            out["T1"] = _tp_t1(cfg, params, mesh1, device)
            log(f"[time] phase T T1: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            out["T3"] = _tp_t3(mesh1, device)
            log(f"[time] phase T T3: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            out["T4"] = _tp_t4(cfg, params, mesh1, device)
            log(f"[time] phase T T4: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            out["A2"] = _tp_a2(cfg, params, device)
            log(f"[time] phase T A2: {time.perf_counter() - t0:.1f}s")
        finally:
            dist.destroy_process_group()
    return out


def _tp_margins(cb) -> dict:
    """Per (rid, step), (the gap between the two largest logits, the
    largest) of the step that chose the request's token ``step`` (host
    ticks): recorded by wrapping the batcher's tick loop."""
    margins = {}
    make = cb._loop

    def loop_of(kind, chunk=None):
        loop = make(kind, chunk)
        if kind != "tick":
            return loop

        def run(*a):
            logits = loop(*a)
            top = logits[:, -1].float().topk(2, dim=-1).values.cpu()
            for i, lane in enumerate(cb.lanes):
                if lane is not None:
                    margins[lane.req.rid, len(lane.req.output)] = (
                        float(top[i, 0] - top[i, 1]), float(top[i, 0]))
            return logits
        return run

    cb._loop = loop_of
    return margins


def _tp_gloo_rank(rank: int, t0_tokens: dict, t1: dict, device: str,
                  make_model) -> dict:
    """T2 on one of two ranks sharing the card over gloo: the fp32 smoke
    model's host and device arms, then llama3-8b at full width (each rank
    builds the seeded full model, its batcher keeps the rank's slices, the
    rest is freed) on the host tick and the device window.
    ``make_model``: ``full_model`` (a smaller model in a CPU rehearsal)."""
    import torch
    from repro_torch.core.sync import fence
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device == "cuda"
    mesh = make_host_mesh(1, 2, device=device)
    out = {"smoke": {}}
    scfg, sparams = _tp_smoke_model(device)
    for arm in ("host", "device"):
        toks, stats, graphs = _tp_smoke_serve(scfg, sparams, device, mesh,
                                              **TP_ARMS[arm])
        if toks != t0_tokens[arm] or stats["captured"] is not False \
                or graphs["graphs"] != 0:
            raise AssertionError(f"[tp] T2 smoke {arm} rank {rank}: tokens "
                                 f"{toks} vs {t0_tokens[arm]}, {stats}, "
                                 f"{graphs}")
        out["smoke"][arm] = toks
    del scfg, sparams
    cfg, params = make_model()
    prompts = full_prompts(cfg)
    for label, kw in (("host tick", dict(sync="host")),
                      ("fp window", dict(sync="device"))):
        cb, reqs = _serve(cfg, params, prompts, device=device,
                          engine_mode=None, window=8, decode_width=8,
                          new_tokens=16, mesh=mesh, **kw)
        if label == "fp window":
            del params                  # the other rank's columns go
            gc.collect()
            torch.cuda.empty_cache()
        timers = _tp_instrument(cb)
        margins = _tp_margins(cb)
        fence(cb.kv.pool["k"])
        t0 = time.perf_counter()
        cb.run(reqs)
        fence(cb.kv.pool["k"])
        wall = time.perf_counter() - t0
        cb.kv.assert_drained()
        got = [r.output for r in reqs]
        want = t1[label]["outputs"]
        diff = [(rid, next((i for i, (a, b) in enumerate(zip(g_, w_))
                            if a != b), None))
                for rid, (g_, w_) in enumerate(zip(got, want))]
        diff = [(rid, step) for rid, step in diff if step is not None]
        row = {"wall_s": wall, "tokens": sum(len(o) for o in got),
               "outputs": got,
               "prefill_s": timers["prefill"], "decode_s": timers["decode"],
               "stats": cb.stats(), "graphs": cb.graph_stats(),
               "first_diff": [(rid, step, margins.get((rid, step)))
                              for rid, step in diff],
               "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if card else 0.0)}
        if label == "host tick":
            row["first_logits"] = {rid: lg.cpu() for rid, lg in
                                   timers["first_logits"].items()}
        out[label] = row
        del cb, reqs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


# T2's token gate: where a TP = 2 stream first differs from T1's, T1's top-2
# margin there is at most this many bf16 ulps of the top logit: A2's
# column-split rounding (one ulp at wq, wo, w_down, PERF.md §6, PR 26)
# compounded over the 32 layers
TP_MARGIN_ULPS = 4


def _tp_token_gate(ranks: list, t1: dict) -> list:
    """Each rank's first differing (request, step) against T1's
    DeviceLayout with T1's margin there (the rank's own where T1 has none);
    raises where a margin exceeds TP_MARGIN_ULPS ulps of the top logit, or
    is unknown."""
    t1_margins = dict(t1["host tick"].get("margins", {}))
    for rid, lg in t1["fp window"].get("first_logits", {}).items():
        top = lg.float().reshape(-1).topk(2).values      # the prefill's token
        t1_margins.setdefault((rid, 0), (float(top[0] - top[1]),
                                         float(top[0])))
    checked = []
    for rank, res in enumerate(ranks):
        for label in ("host tick", "fp window"):
            for rid, step, own in res[label]["first_diff"]:
                margin = t1_margins.get((rid, step)) or own
                if margin is None:
                    raise AssertionError(f"[tp] T2 rank {rank} {label}: "
                                         f"tokens differ at request {rid} "
                                         f"step {step}, no margin known")
                gap, top = margin
                limit = TP_MARGIN_ULPS * bf16_ulp(top)
                checked.append({"rank": rank, "label": label, "rid": rid,
                                "step": step, "margin": gap, "top": top,
                                "limit": limit})
                if gap > limit:
                    raise AssertionError(
                        f"[tp] T2 rank {rank} {label}: tokens differ at "
                        f"request {rid} step {step} where T1's top-2 margin "
                        f"{gap:.6f} (top logit {top:.4f}) exceeds "
                        f"{TP_MARGIN_ULPS} bf16 ulps ({limit:.6f})")
    log(f"[tp] T2 token gate: {len(checked)} first differences, each "
        f"within {TP_MARGIN_ULPS} bf16 ulps of its top logit: "
        + json.dumps(checked))
    return checked


def phase_tp_gloo(t0: dict, t1: dict, device="cuda",
                  make_model=None) -> dict:
    """T2: llama3-8b at full width, TP = 2 as two processes sharing the card
    over gloo (eager: gloo's collectives are not captured), host tick and
    device window; first-token cosine >= TP_COS against T1's DeviceLayout,
    tokens compared (a difference is logged with its first step and the
    host tick's logit margin there, and held to ``_tp_token_gate``), and the
    fp32 smoke model's tokens equal. Its times are the gloo transport's,
    not TP's speed."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t0_tokens = {arm: t0[arm]["tokens"] for arm in ("host", "device")}
    want = {label: {"outputs": t1[label]["outputs"]}
            for label in ("host tick", "fp window")}
    ref_logits = {rid: lg.cpu()
                  for rid, lg in t1["fp window"]["first_logits"].items()}
    ranks = spawn_ranks(_tp_gloo_rank, 2, t0_tokens, want, device,
                        make_model or full_model, device=device,
                        backend="gloo")
    for rank, res in enumerate(ranks):
        cos = {rid: float(torch.nn.functional.cosine_similarity(
            res["host tick"]["first_logits"][rid], ref_logits[rid], dim=0))
            for rid in ref_logits}
        res["cos"] = cos
        if min(cos.values()) < TP_COS:
            raise AssertionError(f"[tp] T2 rank {rank}: first-token cosine "
                                 f"{cos} < {TP_COS}")
        for label in ("host tick", "fp window"):
            r = res[label]
            log(f"[tp] T2 rank {rank} {label} (gloo transport, eager): "
                f"{r['tokens']} tokens in {r['wall_s']:.3f}s "
                f"({r['tokens'] / r['wall_s']:.2f} tok/s), prefill "
                f"{r['prefill_s']:.3f}s, decode {r['decode_s']:.3f}s; peak "
                f"{r['peak_gb']:.2f} GB; graphs {r['graphs']}; "
                + ("tokens equal T1's DeviceLayout" if not r["first_diff"]
                   else "tokens differ from T1's DeviceLayout at (request, "
                   f"step, host-tick logit margin) {r['first_diff']}"))
        log(f"[tp] T2 rank {rank}: first-token cosine vs T1 DeviceLayout "
            + ", ".join(f"{c:.6f}" for c in cos.values())
            + f"; smoke host / device tokens equal T0's")
    for label in ("host tick", "fp window"):
        if ranks[0][label]["outputs"] != ranks[1][label]["outputs"]:
            raise AssertionError(f"[tp] T2 {label}: the two ranks' streams "
                                 "differ")
    return {"ranks": ranks, "token_gate": _tp_token_gate(ranks, t1)}


# --------------------------------------------------------- phases P and R --

# P: llama3-8b through a two-stage pipeline, 4 microbatches of one
# 1024-token sequence (a causal prefill through every layer, no cache)
P_STAGES, P_MICRO, P_MB, P_SEQ = 2, 4, 1, 1024


def _pipeline_tokens(vocab: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(21)
    return torch.from_numpy(rng.integers(0, vocab, (P_MICRO, P_MB, P_SEQ)))


def _pipeline_rank(rank: int, device: str, make_model) -> dict:
    """P on one of two ranks sharing the card over gloo: the seeded full
    model (``make_model``, ``full_model`` on the card), this stage's 16
    layers kept and the rest freed, the microbatches' embeddings made on
    every rank; a warm-up forward, then a timed one with each tick's
    ``layer_fn`` fenced and timed, and its kernel launches."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.sync import fence
    from repro_torch.distributed.pipeline import make_pipeline_forward
    from repro_torch.models import transformer
    from repro_torch.training.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh(device, (P_STAGES,), mesh_dim_names=("stage",))
    cfg, params = make_model()
    per = cfg.n_layers // P_STAGES
    mine = tree_map(lambda a: a[rank * per:(rank + 1) * per].clone()[None],
                    params["layers"])
    with torch.no_grad():
        x = transformer._embed(params, _pipeline_tokens(
            cfg.vocab_size).to(device), cfg)
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    busy = []

    def layer_fn(lp, h):
        fence(h)
        t = time.perf_counter()
        y = transformer.stage_forward(lp, h, cfg)
        fence(y)
        busy.append((t, time.perf_counter() - t))
        return y

    fwd = make_pipeline_forward(layer_fn, P_STAGES, P_MICRO, mesh)
    with torch.no_grad():
        fwd(mine, x)                                     # warm-up
        busy.clear()
        _zero_counts()
        fence(x)
        t0 = time.perf_counter()
        out = fwd(mine, x)
        fence(out)
        wall = time.perf_counter() - t0
    return {"out": out.cpu(), "launches": _read_counts(), "wall_s": wall,
            "ticks": [(t - t0, d) for t, d in busy],
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else 0.0)}


def phase_pipeline(device="cuda", make_model=None) -> dict:
    """P: llama3-8b at full width and depth, bf16, through
    ``make_pipeline_forward`` as two stages of 16 layers in two gloo
    processes sharing the card (``_pipeline_rank``), 4 microbatches of 1 x
    1024 tokens; then this process runs the same 32 layers serially on the
    same microbatches (``transformer.stage_forward``, one microbatch at a
    time). Gates: both ranks' outputs bitwise equal to the serial forward,
    finite, and flash attention launched on each rank (16 layers x 4
    microbatches). Logs each rank's tick times and its measured bubble
    (the share of the timed forward outside ``layer_fn``: the pipeline's
    idle ticks and the gloo hand-offs) beside ``pipeline_stats``'."""
    import torch
    from repro_torch.distributed.pipeline import pipeline_stats
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer
    make_model = make_model or full_model
    ranks = spawn_ranks(_pipeline_rank, P_STAGES, device, make_model,
                        device=device, backend="gloo")
    cfg, params = make_model()
    with torch.no_grad():
        x = transformer._embed(params, _pipeline_tokens(
            cfg.vocab_size).to(device), cfg)
        serial = torch.stack([transformer.stage_forward(params["layers"],
                                                        x[m], cfg)
                              for m in range(P_MICRO)]).cpu()
    del params, x
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    stats = pipeline_stats(P_MICRO, P_STAGES)
    want_flash = cfg.n_layers // P_STAGES * P_MICRO
    rows = []
    for rank, res in enumerate(ranks):
        same = torch.equal(res["out"], serial)
        busy = sum(d for _, d in res["ticks"])
        row = {"rank": rank, "bitwise": same, "wall_s": res["wall_s"],
               "busy_s": busy, "bubble": 1.0 - busy / res["wall_s"],
               "ticks": res["ticks"], "peak_gb": res["peak_gb"],
               "launches": {k: n for k, n in res["launches"].items() if n}}
        rows.append(row)
        log(f"[pipeline] P rank {rank} (stage {rank}, layers "
            f"{rank * cfg.n_layers // P_STAGES}.."
            f"{(rank + 1) * cfg.n_layers // P_STAGES - 1}): outputs bitwise "
            f"equal to the serial {cfg.n_layers}-layer forward: {same}; forward "
            f"{res['wall_s']:.4f}s, layer_fn {busy:.4f}s, measured bubble "
            f"{row['bubble']:.3f} (GPipe's {stats['bubble_fraction']:.3f} "
            f"over {stats['ticks']} ticks); ticks (start s, layer_fn s) "
            + ", ".join(f"({t:.4f}, {d:.4f})" for t, d in res["ticks"])
            + f"; launches {row['launches']}; peak {res['peak_gb']:.2f} GB")
        if not (same and torch.isfinite(res["out"]).all()):
            raise AssertionError(f"[pipeline] P rank {rank}: outputs differ "
                                 "from the serial forward")
        if device == "cuda" and res["launches"]["flash_attention"] \
                != want_flash:
            raise AssertionError(f"[pipeline] P rank {rank}: flash "
                                 f"launches {res['launches']}, want "
                                 f"{want_flash}")
    return {"ranks": rows, "stats": stats,
            "launches": [r["launches"].get("flash_attention", 0)
                         for r in rows]}


# R: the dry run against the card. The predicted per-rank peak (arguments
# plus the trace's temp) within this share of the card's
R_PEAK_TOL = 0.25


def _real_args(example_args, values: dict):
    """``example_args``' tree with each leaf taken from ``values`` (a
    tree of the same keys; a rank of a one-rank mesh holds whole
    tensors), checked against its local shape and dtype."""
    from repro_torch.launch.steps import ExampleArg
    if isinstance(example_args, ExampleArg):
        if tuple(values.shape) != tuple(example_args.local_shape) \
                or values.dtype != example_args.dtype:
            raise AssertionError(f"[dryrun] R: argument {tuple(values.shape)}"
                                 f" {values.dtype} for {example_args}")
        return values
    if isinstance(example_args, dict):
        return {k: _real_args(v, values[k]) for k, v in example_args.items()}
    return type(example_args)(_real_args(a, v)
                              for a, v in zip(example_args, values))


def phase_dryrun_cell(label: str, arch: str, shape_name: str, shape_spec,
                      step, example_args, real_args, *, need=()) -> dict:
    """R, one cell over a one-rank fake process group: ``launch/dryrun.py``
    traces ``step`` on fake CUDA tensors of ``example_args``, then the
    same step runs once on the card on ``real_args`` under the same count
    (``roofline/count.py``), then once more uncounted and timed. Gates:
    FLOPs and bytes accessed equal exactly, each kernel operator's calls
    equal its wrapper's real launches (nonzero for each of ``need``), the
    predicted per-rank peak (arguments + temp) within R_PEAK_TOL of the
    card's (arguments + ``max_memory_allocated`` beyond what was allocated
    before the call). Logs ``analyze_cell``'s H100 bound beside the
    measured step time."""
    import tempfile
    import torch
    from repro_torch.core.characteristics import H100
    from repro_torch.kernels.build import COUNTED
    from repro_torch.launch.dryrun import trace_call
    from repro_torch.roofline.analysis import analyze_cell
    from repro_torch.roofline.count import count_call
    t0 = time.perf_counter()
    rec = trace_call(step, example_args, device="cuda")
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    out, real = count_call(step, *real_args)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in COUNTED if w.launches}
    peak_step = torch.cuda.max_memory_allocated() - base
    del out
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*real_args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del out
    gc.collect()
    mem = rec["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = real["memory"]["argument_size_in_bytes"] + peak_step
    rec.update(arch=arch, shape=shape_name, mesh="rank1", ok=True,
               n_devices=1, counted_by="trace", shape_spec=shape_spec)
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, f"{arch}__{shape_name}__rank1.json").write_text(
            json.dumps(rec))
        cell = analyze_cell(arch, shape_name, mesh="rank1", out_dir=tmp,
                            spec=H100)
    row = {"label": label, "flops": rec["cost"]["flops"],
           "real_flops": real["cost"]["flops"],
           "bytes": rec["cost"]["bytes accessed"],
           "real_bytes": real["cost"]["bytes accessed"],
           "kernel_calls": rec["kernel_calls"],
           "real_kernel_calls": real["kernel_calls"], "launches": launches,
           "kernel_flops": rec["kernel_flops"],
           "predicted_peak_gb": predicted / 1e9,
           "measured_peak_gb": measured / 1e9,
           "predicted_temp_gb": mem["temp_size_in_bytes"] / 1e9,
           "measured_temp_gb": peak_step / 1e9,
           "trace_s": trace_s, "step_s": step_s,
           "bound_s": cell.bound_time_s, "dominant": cell.dominant,
           "compute_s": cell.compute_s, "memory_s": cell.memory_s,
           "collective_s": cell.collective_s,
           "useful_ratio": cell.useful_ratio,
           "roofline_fraction": cell.roofline_fraction,
           "bound_over_measured": cell.bound_time_s / step_s}
    log(f"[dryrun] R {label}: trace {trace_s:.1f}s on fake CUDA tensors; "
        f"FLOPs trace / card {row['flops']:.6e} / {row['real_flops']:.6e}, "
        f"bytes accessed {row['bytes']:.6e} / {row['real_bytes']:.6e}; "
        f"kernel calls {rec['kernel_calls']}, card launches {launches}; "
        f"peak predicted {row['predicted_peak_gb']:.3f} GB (temp "
        f"{row['predicted_temp_gb']:.3f}) vs card {row['measured_peak_gb']:.3f}"
        f" GB (temp {row['measured_temp_gb']:.3f})")
    log(f"[dryrun] R {label}: H100 roofline {cell.dominant}-bound, bound "
        f"{cell.bound_time_s:.6f}s (compute {cell.compute_s:.6f}, memory "
        f"{cell.memory_s:.6f}, collective {cell.collective_s:.6f}) vs "
        f"measured step {step_s:.6f}s: bound / measured "
        f"{row['bound_over_measured']:.4f}; analyze_cell roofline fraction "
        f"{cell.roofline_fraction:.4f}, useful ratio "
        f"{cell.useful_ratio:.4f}")
    if rec["cost"] != real["cost"]:
        raise AssertionError(f"[dryrun] R {label}: cost {rec['cost']} "
                             f"traced, {real['cost']} on the card")
    if not (rec["kernel_calls"] == real["kernel_calls"] == launches) \
            or any(not launches.get(k) for k in need):
        raise AssertionError(f"[dryrun] R {label}: kernel calls "
                             f"{rec['kernel_calls']} traced, "
                             f"{real['kernel_calls']} counted, launches "
                             f"{launches}")
    if abs(predicted - measured) > R_PEAK_TOL * measured:
        raise AssertionError(f"[dryrun] R {label}: peak predicted "
                             f"{predicted / 1e9:.3f} GB, card "
                             f"{measured / 1e9:.3f} GB")
    return row


def phase_dryrun_serve(cfg, params) -> dict:
    """R's serve cell (phase T's weights on the card): T4's llama3-8b
    prefill step, 8 prompts of 1024 tokens into a 4096-token cache, KV
    "head", over a one-rank fake process group."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_step_and_specs
    from repro_torch.models import build_model
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=T4_CACHE,
                                global_batch=T4_BATCH, kind="prefill")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (T4_BATCH, T4_PROMPT))).to("cuda")
    cache = build_model(cfg).init_cache(batch=T4_BATCH, max_len=T4_CACHE,
                                        device="cuda")
    with fake_group(1):
        mesh = make_host_mesh(1, 1, device="cpu")
        step, (pargs, tok_arg, cargs), _ = make_step_and_specs(
            cfg, mesh, shape, kv_mode="head")
        tok_arg = tok_arg._replace(shape=(T4_BATCH, T4_PROMPT),
                                   local_shape=(T4_BATCH, T4_PROMPT),
                                   dtype=toks.dtype)
        args = (pargs, tok_arg, cargs)
        row = phase_dryrun_cell(
            "serve llama3-8b prefill 8 x 1024 into 4096", "llama3-8b",
            "prefill_1k_into_4k",
            {"seq_len": T4_PROMPT, "global_batch": T4_BATCH,
             "kind": "prefill"}, step, args,
            _real_args(args, (params, toks, cache)),
            need=("flash_attention",))
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_dryrun_train(arch: str = "qwen3-1.7b", seq: int = 4096,
                       batch: int = 2) -> dict:
    """R's train cell beside H5: qwen3-1.7b's ``make_step_and_specs``
    train step at 4096 x 2 (H5's seeded weights and first batch, AdamW
    state) over a one-rank fake process group."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_step_and_specs
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    cfg = get_config(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch)
    batch0 = {k: torch.from_numpy(v).to("cuda") for k, v in
              SyntheticLM(cfg.vocab_size, seq, batch, seed=0).next().items()}
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = opt.init_state(params)
    with fake_group(1):
        mesh = make_host_mesh(1, 1, device="cpu")
        step, args, _ = make_step_and_specs(cfg, mesh, shape)
        row = phase_dryrun_cell(
            f"train {arch} {seq} x {batch}", arch, "train_4k",
            {"seq_len": seq, "global_batch": batch, "kind": "train"}, step,
            args, _real_args(args, (state, batch0)),
            need=("flash_attention", "flash_attention_bwd"))
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return row


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
    t0 = time.perf_counter()
    phase_lint(card)
    log(f"[time] phase_lint: {time.perf_counter() - t0:.1f}s ({card})")
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
    prefill_graphs = timed(phase_graph_prefill, cfg, params, full)
    streams = timed(phase_two_streams, cfg, params)
    arms = timed(phase_serving_arms, cfg, params, full)
    front = timed(phase_front_end, cfg, params, full)
    tp = timed(phase_tp, cfg, params)
    tp["R"] = timed(phase_dryrun_serve, cfg, params)
    del cfg, params                  # the llama3 weights leave the card
    gc.collect()                     # (each graph went with its owner)
    torch.cuda.empty_cache()
    tp["T2"] = timed(phase_tp_gloo, tp["T0"], tp["T1"])
    pipe = timed(phase_pipeline)
    hcfg, hparams = hybrid_model()
    hybrid = timed(phase_engine_hybrid, hcfg, hparams,
                   tables[("zamba2-2.7b", None)])
    graphs.update(timed(phase_graph_decode, hcfg, hparams, None, hybrid))
    prefill_graphs.update(timed(phase_graph_prefill, hcfg, hparams))
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

    def train_launches_of(name):
        """The kernel's launches in the timed steps of H2 and H3."""
        got = {f"{k} {training[k]['arch']}": training[k]["launches"][name]
               for k in ("H2", "H3")}
        return {k: n for k, n in got.items() if n}

    def sharded_launches_of(name):
        """The kernel's launches in the sharded steps: T4's prefill and
        decode (per KV mode), H5's one-rank train step, H6's two ranks."""
        got = {f"T4 {mode}": tp["T4"][mode]["launches"].get(name, 0)
               for mode in ("head", "seq")}
        got["H5"] = training["H5"]["launches"].get(name, 0)
        for r, counts in enumerate(training["H6"]["launches"]):
            got[f"H6 rank {r}"] = counts.get(name, 0)
        return {k: n for k, n in got.items() if n}

    for i, name in ((3, "flash_attention"), (4, "decode_attention")):
        kernels["kernels"][i]["sharded_launches"] = sharded_launches_of(name)
        if not kernels["kernels"][i]["sharded_launches"]:
            raise AssertionError(f"{name} never launched in a sharded step")
    kernels["kernels"][3]["training_launches"] = train_launches_of(
        "flash_attention")
    kernels["kernels"][3]["pipeline_launches"] = {
        f"P rank {r}": n for r, n in enumerate(pipe["launches"])}
    kernels["kernels"][5]["training_launches"] = train_launches_of(
        "ssd_chunk")
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
        "device_ms": training["H2"]["bwd_step_device_ms"],
        "training_launches": train_launches_of("flash_attention_bwd"),
        "sharded_launches": sharded_launches_of("flash_attention_bwd"),
        "zamba2_row": {
            k: training["H0"]["path_zamba2"][k]
            for k in ("shape", "causal", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms", "max_abs_err", "rel_err")},
        "zamba2_device_ms": training["H3"]["bwd_step_device_ms"]})
    ssd_bwd = training["H0 ssd"]["path"]
    kernels["kernels"].append({
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "none: not a TPU kernel (the reference's training "
                    "differentiates src/repro/models/mamba2.py:66 "
                    "ssd_chunked with JAX autodiff)",
        "tpu_kernel": False,
        "launches": training["H3"]["launches"]["ssd_chunk_bwd"],
        **{k: ssd_bwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_note", "shape", "dtype",
                                   "bound_split_tf32_ms",
                                   "bound_split_tf32_by", "rel_err")},
        "kernel_ms": ssd_bwd["ms"],
        "device_ms": training["H3"]["ssd_bwd_step_device_ms"]})
    dryrun = {"R serve": tp["R"], "R train": training["R"]}
    for i, name in ((3, "flash_attention"), (6, "flash_attention_bwd")):
        kernels["kernels"][i]["dryrun_launches"] = {
            k: r["launches"][name] for k, r in dryrun.items()
            if r["launches"].get(name)}
    kernels["kernels"][3]["device_start_rows"] = attn["device_start"]
    # the device-start entry's launches in the captured engine passes
    kernels["kernels"][3]["device_start_launches"] = {
        cell: rec["launches"]["flash_attention"]
        for cell, rec in prefill_graphs.items() if cell.startswith("engine")}
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
        + "; captured / eager prefill s (alternating) "
        + ", ".join(f"{k} {min(r['prefill_only_s']['captured']):.4f} / "
                    f"{min(r['prefill_only_s']['eager']):.4f}"
                    if "prefill_only_s" in r else
                    f"{k} {min(r['prefill_s']['captured']):.4f} / "
                    f"{min(r['prefill_s']['eager']):.4f}"
                    for k, r in prefill_graphs.items()
                    if k not in ("spec", "spec host"))
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
        + "; zamba2-2.7b step "
        + f"{training['H3']['mean_step_s']:.4f}s ("
        + f"{training['H3']['tokens_per_s']:.0f} tok/s, model-FLOP share "
        + f"{training['H3']['model_flop_share']:.4f}, peak "
        + f"{training['H3']['peak_gb']:.2f} GB), SSD backward "
        + f"{training['H3']['ssd_bwd_step_device_ms']:.3f} ms device a call"
        + "; rwkv6-3b step "
        + f"{training['H4']['mean_step_s']:.4f}s ("
        + f"{training['H4']['tokens_per_s']:.0f} tok/s, peak "
        + f"{training['H4']['peak_gb']:.2f} GB)"
        + "; tp: T1 DeviceLayout / one-rank NCCL MeshLayout tok/s "
        + ", ".join(f"{k} {sum(v['device']['tok_per_s']) / 2:.2f} / "
                    f"{sum(v['mesh']['tok_per_s']) / 2:.2f}"
                    for k, v in tp["T1"].items())
        + "; T2 two gloo ranks on the card (transport) host tick "
        + f"{tp['T2']['ranks'][0]['host tick']['wall_s']:.2f}s, first-token "
        + f"cosine min {min(tp['T2']['ranks'][0]['cos'].values()):.6f}"
        + "; sharded steps: T4 prefill / 16 decode s head "
        + f"{tp['T4']['head']['prefill_s']:.4f} / "
        + f"{tp['T4']['head']['decode_s']:.4f}, seq "
        + f"{tp['T4']['seq']['prefill_s']:.4f} / "
        + f"{tp['T4']['seq']['decode_s']:.4f}; H5 qwen3-1.7b sharded / "
        + "single step s "
        + f"{sum(training['H5']['step_s']['sharded']) / 2:.4f} / "
        + f"{sum(training['H5']['step_s']['single']) / 2:.4f} (bitwise "
        + f"{training['H5']['bitwise']}); H6 TP = 2 gloo gradient cosine "
        + f"{training['H6']['grad_cos']:.6f}, two-step update cosine "
        + f"{training['H6']['update']['tree_cos']:.6f}"
        + "; pipeline P (2 gloo stages) forward s "
        + " / ".join(f"{r['wall_s']:.4f}" for r in pipe["ranks"])
        + ", bubble " + " / ".join(f"{r['bubble']:.3f}"
                                   for r in pipe["ranks"])
        + f" (GPipe {pipe['stats']['bubble_fraction']:.3f}); dry run R "
        + ", ".join(f"{k} bound / measured {r['bound_over_measured']:.4f}"
                    f" ({r['dominant']})" for k, r in
                    (("serve", tp["R"]), ("train", training["R"])))
        + f"; total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
