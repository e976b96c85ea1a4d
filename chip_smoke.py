#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them or outside a checkout of the repository. Phases, each raising
on failure:

  1. card and build: the card's name and power limit (nvidia-smi), then
     every CUDA source of the port built with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, over the
     conformance shapes and the serving path's own shapes, in fp32, bf16
     and fp16, both stationary orders and strided operands, within the
     reference's DTYPE_TOL; kernel, plain and library timings with CUDA
     events;
  3. token identity on the card: the fp32 llama3 smoke model served by
     PagedBatcher under every engine mode and both sync arms, and by the
     port on the CPU, gives the same greedy tokens;
  4. the slice at full width: llama3-8b (32 layers, bf16, seeded random
     weights) served through PagedBatcher(engine_mode="hetero-tensor",
     sync="device", window=8), against the engine_mode=None arm on the same
     weights and prompts.

The line before the last is the kernels JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
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
# a 128-token chunk, w_gate's at a 256-token chunk (plan: weight strategy)
PATH_CASES = (
    ("path_wq_m128", 128, 4096, 2048),
    ("path_wgate_m256", 256, 4096, 7168),
)
DTYPE_TOL = {"float32": 2e-6, "bfloat16": 2e-2, "float16": 4e-3}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    a32, b32 = a.float(), b.float()
    return float((a32 - b32).abs().max() / (b32.abs().max() + 1e-9))


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
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    return card


# ------------------------------------------------------------------ phase 2 --

def _pad(t, mult=128):
    import torch.nn.functional as F
    r0, r1 = (-t.shape[0]) % mult, (-t.shape[1]) % mult
    return F.pad(t, (0, r1, 0, r0)) if (r0 or r1) else t


def phase_kernels() -> dict:
    """Every case x dtype x stationary order, plain and strided operands."""
    import torch
    from repro_torch.configs import dtype_of
    from repro_torch.core.characteristics import mxu_matmul_time_us
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.kernels.hetero_matmul.ref import matmul_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    n_checks = 0
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
                direct = ops.mxu_matmul(xp, wp, stationary=st)[:M, :N]
                exchanged = ops.mxu_matmul(wp.T, xp.T, stationary=st).T[:M, :N]
                torch.cuda.synchronize()
                for form, y in (("direct", direct), ("exchanged", exchanged)):
                    e = rel_err(y, ref)
                    n_checks += 1
                    key = (dname, st)
                    worst[key] = max(worst.get(key, 0.0), e)
                    if not e <= tol:
                        raise AssertionError(
                            f"hetero_matmul {name} {dname} {st} {form}: "
                            f"rel_err {e:.3g} > {tol}")
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
        row = {
            "case": name, "M": M, "K": K, "N": N, "dtype": "bfloat16",
            "exchanged": exch,
            "max_abs_err": float((y.float() - ref.float()).abs().max()),
            "ms": cuda_time_ms(lambda: ops.mxu_matmul(a, b)),
            "weight_stationary_ms": cuda_time_ms(
                lambda: ops.mxu_matmul(a, b, stationary="weight")),
            "plain_ms": cuda_time_ms(lambda: matmul_ref(x, w)),
            "library_ms": cuda_time_ms(lambda: torch.matmul(x, w)),
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


# ------------------------------------------------------------------ phase 3 --

def _smoke_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 70, 130, 200)]


def _serve(cfg, params, prompts, *, device, engine_mode, sync, window,
           decode_width, new_tokens):
    from repro_torch.serving.scheduler import PagedBatcher, Request
    max_len = max(len(p) for p in prompts) + new_tokens + 8
    per_req = -(-max_len // 32)
    cb = PagedBatcher(cfg, params, num_blocks=1 + len(prompts) * per_req,
                      block_size=32, max_blocks_per_seq=per_req,
                      decode_width=decode_width, sync=sync, window=window,
                      engine_mode=engine_mode, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    return cb, reqs


def phase_tokens() -> int:
    """fp32 smoke model: every engine mode x sync arm gives the same greedy
    tokens, on the card and on the CPU. Returns the GEMM launches."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.hetero_matmul import ops
    from repro_torch.models.transformer import init_params

    cfg = get_smoke_config("llama3-8b").with_(param_dtype="float32",
                                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
    cpu_params = _to_device(params, "cpu")
    prompts = _smoke_prompts(cfg.vocab_size)
    outputs, launches = {}, 0
    arms = [("cuda", m, s) for m in (None, "xla", "mxu", "hetero-tensor")
            for s in ("host", "device")] + [("cpu", "hetero-tensor", "device")]
    for device, mode, sync in arms:
        cb, reqs = _serve(cfg, params if device == "cuda" else cpu_params,
                          prompts, device=device, engine_mode=mode, sync=sync,
                          window=4, decode_width=4, new_tokens=12)
        ops.mxu_matmul.launches = 0
        cb.run(reqs)
        n = ops.mxu_matmul.launches
        cb.kv.assert_drained()
        arm = f"{device}/{mode}/{sync}"
        outputs[arm] = [r.output for r in reqs]
        log(f"[tokens] {arm}: {cb.stats()} gemm_launches={n}")
        # mxu sends every prefill matmul to the kernel; hetero-tensor sends
        # what its plan does not keep xla_only (under sync host the
        # reference's 50 us T_sync keeps every smoke-size site there)
        expect = device == "cuda" and (mode == "mxu" or (
            mode == "hetero-tensor" and any(
                d.strategy != "xla_only"
                for d in cb.ctx.plan.decisions.values())))
        if (n > 0) != expect:
            raise AssertionError(f"{arm}: {n} GEMM launches, expected "
                                 f"{'some' if expect else 'none'}")
        if (device, mode, sync) == ("cuda", "hetero-tensor", "device") \
                and n == 0:
            raise AssertionError(f"{arm}: the GEMM kernel was never launched")
        launches += n
    first = next(iter(outputs.values()))
    for arm, out in outputs.items():
        if out != first:
            raise AssertionError(f"[tokens] {arm} differs: {out} vs {first}")
        if any(len(o) != 12 for o in out):
            raise AssertionError(f"[tokens] {arm}: wrong token counts")
    log(f"[tokens] {len(outputs)} arms token-identical; request 0: {first[0]}")
    return launches


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------------------------------------ phase 4 --

def phase_full(prompt_len: int = 300, new_tokens: int = 16,
               n_requests: int = 4) -> dict:
    """llama3-8b at full width: the hetero-tensor arm and the engine-less
    arm on the same seeded weights and prompts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import fence
    from repro_torch.kernels.hetero_matmul import ops
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
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(8, prompt_len)).astype(np.int32)
               for _ in range(n_requests)]
    log(f"[full] prompt lengths {[len(p) for p in prompts]}, "
        f"{new_tokens} new tokens each")
    arms = {}
    for mode in ("hetero-tensor", None):
        cb, reqs = _serve(cfg, params, prompts, device="cuda",
                          engine_mode=mode, sync="device", window=8,
                          decode_width=8, new_tokens=new_tokens)
        timers = _instrument(cb)
        torch.cuda.reset_peak_memory_stats()
        fence(params["embed"])
        ops.mxu_matmul.launches = 0
        t0 = time.perf_counter()
        cb.run(reqs)
        fence(params["embed"])
        wall = time.perf_counter() - t0
        launches = ops.mxu_matmul.launches
        cb.kv.assert_drained()
        tok = sum(len(r.output) for r in reqs)
        arm = {
            "engine_mode": mode, "wall_s": wall, "tokens": tok,
            "tok_per_s": tok / wall, "prefill_s": timers["prefill"],
            "decode_s": timers["decode"], "stats": cb.stats(),
            "gemm_launches": launches, "outputs": [r.output for r in reqs],
            "first_logits": timers["first_logits"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pool_bytes": cb.kv.pool_bytes(),
        }
        if cb.ctx is not None:
            plan = cb.ctx.plan
            arm["strategies"] = dict(Counter(d.strategy
                                             for d in plan.decisions.values()))
            arm["decisions_m256"] = {
                s: f"{d.strategy}:{d.n_split}" for (s, m), d in
                plan.decisions.items() if m == 256}
        arms[mode] = arm
        log(f"[full] engine={mode}: {tok} tokens in {wall:.3f}s "
            f"({tok / wall:.1f} tok/s); prefill {timers['prefill']:.3f}s, "
            f"decode {timers['decode']:.3f}s; {cb.stats()}; gemm_launches="
            f"{launches}; peak {arm['peak_mem_gb']:.2f} GB; pool "
            f"{arm['pool_bytes'] / 1e9:.3f} GB")
        if "strategies" in arm:
            log(f"[full] plan strategies {arm['strategies']}; at M=256 "
                f"{arm['decisions_m256']}")
        for r in reqs:
            if len(r.output) != new_tokens:
                raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
    het, base = arms["hetero-tensor"], arms[None]
    if het["gemm_launches"] <= 0:
        raise AssertionError("hetero-tensor arm never launched the GEMM")
    for rid in range(n_requests):
        a = het["first_logits"][rid]
        b = base["first_logits"][rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"request {rid}: non-finite logits")
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        log(f"[full] request {rid}: first-token logits cos {cos:.6f}, "
            f"rel_err {rel_err(a, b):.3g}")
        if cos < 0.99:
            raise AssertionError(f"request {rid}: cosine {cos:.4f} < 0.99")
    same = sum(x == y for o1, o2 in zip(het["outputs"], base["outputs"])
               for x, y in zip(o1, o2))
    total = sum(len(o) for o in het["outputs"])
    log(f"[full] identical tokens hetero-tensor vs engine=None: "
        f"{same}/{total} ({same / total:.3f})")
    _profile(cfg, params, prompts, new_tokens)
    return het


def _profile(cfg, params, prompts, new_tokens: int) -> None:
    """One more hetero-tensor run under torch.profiler (after the timed
    arms, so its overhead touches no reported time): device time by kernel
    and the device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sync import fence

    cb, reqs = _serve(cfg, params, prompts, device="cuda",
                      engine_mode="hetero-tensor", sync="device", window=8,
                      decode_width=8, new_tokens=new_tokens)
    fence(params["embed"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.run(reqs)
        fence(params["embed"])
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
        log("[profile] torch.profiler saw no device time")
        return
    log(f"[profile] hetero-tensor run: wall {wall:.3f}s (profiled), device "
        f"busy {busy:.3f}s ({busy / wall:.3f} of wall)")
    for us, n, key in rows[:12]:
        log(f"[profile] {us / 1e3:10.2f} ms {n:7d}x  {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _instrument(cb) -> dict:
    """Wrap the batcher's admission and decode dispatches with device-synced
    wall timers, and keep each request's first-token logits (the last
    prefill chunk's logits when the request takes its lane)."""
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

    cb._prefill = keep_logits
    cb._place = place_and_record
    cb._admit = timed(cb._admit, "prefill")
    cb._decode_window = timed(cb._decode_window, "decode")
    return timers


# ---------------------------------------------------------------------- main --

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
    t_start = time.perf_counter()

    card = phase_card_and_build()
    kern = phase_kernels()
    phase_tokens()
    full = phase_full()

    wg = next(r for r in kern["timings"] if r["case"] == "path_wgate_m256")
    kernels = {"kernels": [{
        "name": "hetero_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hetero_matmul.cu",
        "replaces": "src/repro/kernels/hetero_matmul/kernel.py:78",
        "launches": full["gemm_launches"],
        "max_abs_err": wg["max_abs_err"],
        "ms": wg["ms"],
        "kernel_ms": wg["ms"],
        "plain_ms": wg["plain_ms"],
        "bound_ms": wg["bound_ms"],
        "bound_by": wg["bound_by"],
        "library_ms": wg["library_ms"],
        "shape": [wg["M"], wg["K"], wg["N"]],
        "dtype": wg["dtype"],
    }]}
    log(f"[summary] card {card}; tok/s {full['tok_per_s']:.2f}; total "
        f"{time.perf_counter() - t_start:.1f}s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
