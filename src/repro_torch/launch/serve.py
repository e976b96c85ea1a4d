"""Serving launcher of the port:

    python -m repro_torch.launch.serve --arch llama3-8b --mode hetero-tensor \\
        --strategy hetero
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --engine-mode hetero-tensor --sync device --window 8
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --engine-mode hetero-tensor --sync device --mixed-batch
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --engine-mode hetero-tensor --sync device --spec-k 4
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --engine-mode hetero-tensor --prefix-cache --shared-prefix 256 \\
        --requests 8 --decode-width 4
    python -m repro_torch.launch.serve --arch llama3-8b --batched
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --engine-mode hetero-tensor --sync device --open-loop \\
        --priority-mix 0.5 --trace-out trace.json --metrics-out run.prom \\
        --plan-drift
    python -m repro_torch.launch.serve --arch llama3-8b --batched --paged \\
        --sync device --tp 1 [--open-loop --priority-mix 0.5]

Without ``--batched`` it runs the single-request HeteroInfer engine
(``InferenceEngine.generate`` on one seeded prompt of ``--prompt-len``
tokens) and prints its prefill and decode tok/s, for every generating
family: dense, MoE (``--arch qwen2-moe-a2.7b``, ``dbrx-132b``), VLM
(``chameleon-34b``), the Mamba2 hybrid (``zamba2-2.7b``) and RWKV-6
(``rwkv6-3b``). With ``--batched`` it serves seeded synthetic prompts
through the async ingress (serving/ingress.py), over the dense
``ContinuousBatcher`` (4 slots) or, with ``--paged``, ``PagedBatcher``
(attention-family models only: dense, MoE, VLM; the hybrid and RWKV have no
paged KV cache, and the batcher refuses them), timed on a
``MonotonicClock``, and prints tok/s, TTFT / TPOT / queue delay
p50/p95/p99, goodput and the dispatch counts. The encoder-only
``hubert-xlarge`` has no prefill or decode step and is refused;
``--weight-quant`` covers the dense family only. Weights are random and
seeded. Runs on the card unless ``--device cpu`` is given (use ``--smoke``
there).

Engine options:

  --mode M          engine mode: xla, mxu, hetero-layer, hetero-tensor
  --strategy S      prefill strategy: online-prepare, padding, pipe, hetero
  --no-fast-sync    host-driven decode, one host round-trip per token

Paged batcher options:

  --sync device     fused-window decode: one host round-trip per --window
                    decode steps instead of per token (fast sync, §4.3)
  --sync host       per-token host-synced decode (the baseline arm)
  --engine-mode M   solver-planned prefill: prefill matmuls run the
                    PartitionSolver plan through HeteroCtx (§4.1/4.2)
  --mixed-batch     stage-parallel mixed batching: each step fuses one
                    prefill chunk of the admitting request into the decode
                    dispatch of the running lanes
  --max-prefill-chunk N
                    cap on prefill tokens fused per step (--mixed-batch)
  --spec-k K        speculative decoding: K drafts a round, one batched
                    K+1-position verify dispatch of the target a round
  --spec-draft M    the draft's config name (e.g. smollm-135m); omit for
                    self-speculation (the target drafts for itself)
  --prefix-cache    automatic prefix caching: finished requests retire full
                    KV blocks into a content-hash cache, admissions share
                    matching blocks and prefill only the uncached suffix
                    (with --shared-prefix; --decode-width below --requests
                    staggers the closes, so later admissions hit)
  --shared-prefix L every request starts with the same L-token prefix
  --weight-quant F  serve int8 or packed-int4 (w4a16) weights
  --kv-quant int8   int8 KV pool with per-slot scales
  --stats           print the server's stats() counter dict

Batched serving always runs through the async ingress: every request is
stamped on the clock, in closed loop (all requests arrive at t=0, the
default) or open loop:

  --open-loop       requests arrive on a seeded schedule
  --arrival P       arrival process: poisson or burst (on-off, same rate)
  --rate R          mean arrival rate, requests/second
  --arrival-seed N  seed of the arrival schedule
  --slo-ms MS       TTFT SLO: goodput counts only requests under it
  --priority-mix F  fraction of requests submitted LOW priority; blocked
                    high-priority arrivals may preempt their lanes (paged)
  --watermark N     admission backpressure: defer while admitting would
                    leave fewer than N free+cached blocks (paged)
  --trace-out PATH  write the run's Chrome trace-event JSON
  --metrics-out PATH
                    write a Prometheus-style text snapshot of the run
  --plan-drift      print the plan-vs-measured drift table (predicted V5E
                    us against the traced dispatch time per (site, M,
                    strategy); needs --engine-mode for decision tags)

Tensor parallelism:

  --tp N            serve over N ranks, one process each, head-wise
                    tensor-parallel over a 1 x N ("data", "model") mesh
                    (serving/layout.py): each rank holds its column slices
                    of the weights and its KV heads of the pool, and runs
                    the same batcher bookkeeping. NCCL on the card (rank r
                    on card r; N may not exceed the cards there), gloo with
                    --device cpu. Greedy streams equal the single-device
                    batcher's; rank 0 reports, and every rank's streams are
                    compared at the end. --tp 1 serves over a one-rank NCCL
                    group, its decode loops CUDA graphs with the
                    collectives inside. Batched paged serving only;
                    excludes --engine-mode. With --open-loop and more
                    than one rank, rank 0 admits for the group on its
                    clock and broadcasts each tick's decisions; the other
                    ranks apply them (serving/ingress.py::TickBroadcast).
                    A closed loop admits alike on every rank.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="hetero-tensor",
                    choices=["xla", "mxu", "hetero-layer", "hetero-tensor"])
    ap.add_argument("--strategy", default="hetero",
                    choices=["online-prepare", "padding", "pipe", "hetero"])
    ap.add_argument("--no-fast-sync", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="use the paged (block-table) KV cache batcher")
    ap.add_argument("--block-size", type=int, default=32,
                    help="tokens per KV block")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="pool size in blocks; 0 = sized from --requests")
    ap.add_argument("--decode-width", type=int, default=8,
                    help="decode lanes")
    ap.add_argument("--sync", default="host", choices=["host", "device"],
                    help="per-token host-synced decode vs windows of "
                         "--window steps per host round-trip")
    ap.add_argument("--window", type=int, default=8,
                    help="decode steps per window (--sync device)")
    ap.add_argument("--engine-mode", default=None,
                    choices=["xla", "mxu", "hetero-layer", "hetero-tensor"],
                    help="route prefill matmuls through the HeteroCtx in "
                         "this mode")
    ap.add_argument("--mixed-batch", action="store_true",
                    help="stage-parallel mixed batching: fuse admission "
                         "prefill chunks into decode dispatches")
    ap.add_argument("--max-prefill-chunk", type=int, default=None,
                    metavar="N",
                    help="max prefill tokens fused per scheduler step "
                         "(--mixed-batch; default: the largest bucket)")
    ap.add_argument("--spec-k", type=int, default=None, metavar="K",
                    help="speculative decoding: K drafts per round")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="draft model config name (--spec-k; default: the "
                         "target drafts for itself)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching of full KV blocks")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="LEN",
                    help="give every request the same LEN-token prefix")
    ap.add_argument("--weight-quant", default=None,
                    choices=["int8", "w4a16"],
                    help="serve quantized weights: int8 or packed-int4 "
                         "(W4A16) codes with per-output-channel scales")
    ap.add_argument("--kv-quant", default=None, choices=["int8"],
                    help="quantize the paged KV pool to int8 codes with "
                         "per-token-slot scales")
    ap.add_argument("--eos-id", type=int, default=None, help="stop token id")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=300)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--stats", action="store_true",
                    help="print the server's stats() counter dict")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(batched mode)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus-style text snapshot of the "
                         "run's counters, gauges and histograms (batched)")
    ap.add_argument("--plan-drift", action="store_true",
                    help="print the solver's plan-vs-measured drift table "
                         "(needs --engine-mode for decision tags)")
    ap.add_argument("--open-loop", action="store_true",
                    help="requests arrive on a seeded schedule "
                         "(--arrival / --rate) instead of all at t=0")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "burst"],
                    help="arrival process (--open-loop)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrival rate, requests/s (--open-loop)")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="seed of the arrival schedule (--open-loop)")
    ap.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                    help="TTFT SLO in ms: goodput counts only requests "
                         "whose first token lands under it")
    ap.add_argument("--priority-mix", type=float, default=0.0, metavar="F",
                    help="fraction of requests submitted LOW priority "
                         "(preemptible by blocked high-priority arrivals; "
                         "paged mode)")
    ap.add_argument("--watermark", type=int, default=0,
                    help="defer admission while it would leave fewer than "
                         "N free+cached blocks (paged mode)")
    ap.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel width: N ranks, weights and the "
                         "paged pool sharded head-wise (paged batcher)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if (args.sync == "device" or args.engine_mode or args.eos_id is not None
            or args.weight_quant or args.kv_quant or args.mixed_batch
            or args.spec_k is not None or args.prefix_cache) \
            and not (args.batched and args.paged):
        ap.error("--sync device / --engine-mode / --eos-id / --weight-quant "
                 "/ --kv-quant / --mixed-batch / --spec-k / --prefix-cache "
                 "apply to the paged batcher: add --batched --paged")
    if args.shared_prefix and not args.batched:
        ap.error("--shared-prefix shapes the batched workload: add "
                 "--batched")
    if args.prompt_len <= 8:
        ap.error("--prompt-len must be above 8")
    if args.max_prefill_chunk is not None and not args.mixed_batch:
        ap.error("--max-prefill-chunk applies to --mixed-batch")
    if args.spec_draft is not None and args.spec_k is None:
        ap.error("--spec-draft applies to --spec-k")
    if args.spec_k is not None and args.mixed_batch:
        ap.error("--spec-k and --mixed-batch are mutually exclusive")
    if args.shared_prefix >= args.prompt_len - 8:
        ap.error("--shared-prefix must leave at least 8 tokens of "
                 "per-request tail below --prompt-len")
    if args.open_loop and not args.batched:
        ap.error("--open-loop applies to the batched servers: add --batched")
    if (args.priority_mix or args.watermark) \
            and not (args.batched and args.paged):
        ap.error("--priority-mix / --watermark apply to the paged batcher: "
                 "add --batched --paged")
    if not 0.0 <= args.priority_mix <= 1.0:
        ap.error("--priority-mix must be in [0, 1]")
    if (args.trace_out or args.metrics_out or args.plan_drift) \
            and not args.batched:
        ap.error("--trace-out / --metrics-out / --plan-drift trace the "
                 "batched servers: add --batched")
    if args.tp is not None:
        _check_tp(ap, args)

    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        ap.error(f"{args.arch} is encoder-only: it has no prefill or decode "
                 "step to generate with")
    if args.tp is not None:
        _run_tp(cfg, args)
        return
    rng = np.random.default_rng(0)
    if not args.batched:
        _run_engine(cfg, args, rng)
        return

    _run_batched(cfg, args, rng)


def _check_tp(ap, args) -> None:
    if not (args.batched and args.paged):
        ap.error("--tp applies to the paged batcher: add --batched --paged")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.engine_mode:
        ap.error("--tp and --engine-mode are mutually exclusive: the hetero "
                 "engine and the device mesh are separate axes")
    if torch.device(args.device).type == "cuda":
        cards = torch.cuda.device_count()
        if args.tp > cards:
            ap.error(f"--tp {args.tp} needs {args.tp} cards (one NCCL rank "
                     f"each), {cards} visible")


def _run_tp(cfg, args) -> None:
    """``--tp N``: N ranks serve the same seeded workload; rank 0 reports,
    and the ranks' streams must agree."""
    from repro_torch.launch.mesh import spawn_ranks

    streams = spawn_ranks(_serve_rank, args.tp, cfg, args,
                          device=args.device)
    for rank, got in enumerate(streams[1:], start=1):
        if got != streams[0]:
            raise SystemExit(f"rank {rank}'s token streams differ from "
                             "rank 0's")
    print(f"  tp: {args.tp} ranks, streams equal on every rank")


def _serve_rank(rank, cfg, args):
    from repro_torch.launch.mesh import make_host_mesh
    if torch.device(args.device).type == "cpu":    # the ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // args.tp))
    mesh = make_host_mesh(1, args.tp, device=args.device)
    return _run_batched(cfg, args, np.random.default_rng(0), mesh=mesh,
                        lead=rank == 0)


def _quiet(*_args, **_kw) -> None:
    pass


def draw_workload(rng, vocab: int, n: int, prompt_len: int,
                  shared_prefix: int = 0, priority_mix: float = 0.0):
    """The batched launcher's seeded workload from ``rng``: ``n`` prompts,
    each the same ``shared_prefix`` tokens then 8 .. ``prompt_len -
    shared_prefix`` random ones, and a priority each (0, low, with
    probability ``priority_mix``, else 1)."""
    shared = rng.integers(0, vocab, shared_prefix).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, vocab, rng.integers(8, prompt_len - shared_prefix)
    ).astype(np.int32)]) for _ in range(n)]
    prios = [0 if rng.random() < priority_mix else 1 for _ in range(n)]
    return prompts, prios


def _run_batched(cfg, args, rng, *, mesh=None, lead: bool = True) -> list:
    """The batched servers on seeded prompts through the async ingress, on
    a MonotonicClock: all serving time flows through the clock, and the
    run is fenced at both ends. ``mesh``: tensor-parallel serving (one
    rank of ``--tp``); only the ``lead`` rank prints the report and writes
    the trace and metrics files. Returns the requests' token streams."""
    from repro_torch.core.sync import fence
    from repro_torch.serving.ingress import (AsyncServer, arrival_times,
                                             open_loop_workload)
    from repro_torch.serving.scheduler import ContinuousBatcher, PagedBatcher
    from repro_torch.serving.spec import SpecConfig
    from repro_torch.serving.telemetry import MonotonicClock
    from repro_torch.serving.trace import Tracer

    say = print if lead else _quiet
    max_len = args.prompt_len + args.new_tokens + 8
    clock = MonotonicClock()
    tracing = bool(args.trace_out or args.metrics_out or args.plan_drift)
    tracer = Tracer(clock) if tracing else None
    if args.paged:
        blocks_per_req = -(-max_len // args.block_size)
        num_blocks = args.max_blocks or 1 + args.requests * blocks_per_req
        spec = (SpecConfig(k=args.spec_k, draft=args.spec_draft,
                           smoke=args.smoke)
                if args.spec_k is not None else None)
        cb = PagedBatcher(cfg, num_blocks=num_blocks,
                          block_size=args.block_size,
                          max_blocks_per_seq=blocks_per_req,
                          decode_width=args.decode_width, sync=args.sync,
                          window=args.window, engine_mode=args.engine_mode,
                          eos_id=args.eos_id, mixed_batch=args.mixed_batch,
                          max_prefill_chunk_per_step=args.max_prefill_chunk,
                          spec=spec, prefix_cache=args.prefix_cache,
                          weight_quant=args.weight_quant,
                          kv_quant=args.kv_quant, device=args.device,
                          mesh=mesh, tracer=tracer)
        anchor = cb.kv.pool["k"]
        label = (f"paged (bs={args.block_size}, blocks={num_blocks}, "
                 f"W={args.decode_width}, sync={args.sync}"
                 + (f", window={args.window}" if args.sync == "device"
                    else "")
                 + (f", engine={args.engine_mode}" if args.engine_mode
                    else "")
                 + (", mixed" if args.mixed_batch else "")
                 + (", prefix-cache" if args.prefix_cache else "")
                 + (f", spec k={args.spec_k} "
                    f"draft={args.spec_draft or 'self'}" if spec else "")
                 + (f", weights={args.weight_quant}" if args.weight_quant
                    else "")
                 + (f", kv={args.kv_quant}" if args.kv_quant else "")
                 + (f", tp={cb.layout.tp} "
                    f"{'captured' if cb.stats()['captured'] else 'eager'}"
                    if mesh is not None else "")
                 + f", device={cb.device})")
    else:
        cb = ContinuousBatcher(cfg, max_batch=4, max_len=max_len,
                               tracer=tracer, device=args.device)
        anchor = cb.cache["k"]
        label = f"batched (slots=4, device={cb.device})"
    prompts, prios = draw_workload(rng, cfg.vocab_size, args.requests,
                                   args.prompt_len, args.shared_prefix,
                                   args.priority_mix)
    sync = None
    if args.open_loop and mesh is not None and args.tp > 1:
        # a closed loop admits alike on every rank (every arrival at t0);
        # an open one admits on rank 0's clock for the group
        from repro_torch.serving.ingress import TickBroadcast
        sync = TickBroadcast(mesh.get_group("model"))
    server = AsyncServer(cb, clock=clock, admit_watermark=args.watermark,
                         tick_sync=sync)
    if args.open_loop:
        t_arr = arrival_times(args.arrival, args.rate, args.requests,
                              args.arrival_seed)
    else:
        t_arr = np.zeros(args.requests)        # closed loop: all at t=0
    fence(anchor)
    t0 = clock.now()
    handles = server.run_sync(open_loop_workload(
        prompts, [args.new_tokens] * args.requests, t0 + t_arr, prios))
    fence(anchor)
    dt = clock.now() - t0
    tok = sum(len(h.tokens) for h in handles)
    loop = (f"open-loop {args.arrival}@{args.rate}/s" if args.open_loop
            else "closed-loop")
    say(f"{label}: {loop}, {args.requests} reqs, {tok} tokens in "
        f"{dt:.2f}s ({tok / dt:.1f} tok/s, peak concurrency "
        f"{cb.peak_active})")
    rep = server.report(slo_ms=args.slo_ms)
    for m in ("ttft_ms", "tpot_ms", "queue_delay_ms"):
        st = rep[m]
        if st["n"]:
            say(f"  {m.removesuffix('_ms')}: p50 {st['p50']:.1f} ms, "
                f"p95 {st['p95']:.1f} ms, p99 {st['p99']:.1f} ms "
                f"(n={st['n']})")
    good = rep["goodput_req_s"]
    say(f"  goodput: {good:.2f} req/s"
        + (f" under TTFT SLO {args.slo_ms:.0f} ms "
           f"({100 * rep['slo_attainment']:.0f}% attainment)"
           if args.slo_ms is not None else " (no SLO given)")
        + (f", {rep['preemptions']} preemptions"
           if rep["preemptions"] else ""))
    if args.paged:
        say(f"  decode: {cb.decode_dispatches} host dispatches for "
            f"{cb.decode_steps} decoded tokens "
            f"({cb.decode_steps / max(cb.decode_dispatches, 1):.1f} "
            f"tokens/dispatch)")
        say(f"  prefill: {cb.prefill_dispatches} standalone dispatches, "
            f"{cb.fused_steps} chunks fused into decode dispatches "
            f"({cb.total_dispatches} host dispatches total)")
        s = cb.stats()
        if spec is not None:
            say(f"  spec: {s['verify_dispatches']} verify dispatches, "
                f"acceptance {s['acceptance_rate']:.2f} "
                f"({s['accepted_tokens']}/{s['drafted_tokens']} drafts, "
                f"draft={s['draft_model']})")
        if args.prefix_cache:
            say(f"  prefix-cache: {s['prefix_hits']} hit admissions, "
                f"{s['prefix_tokens_reused']} prompt tokens reused, "
                f"{s['cached_blocks']} blocks retained, {s['evictions']} "
                f"evictions, {s['cow_copies']} CoW copies")
    if args.stats:
        say(f"  stats: {server.stats()}")
    if tracer is not None and lead:
        if args.trace_out:
            tracer.save_chrome(args.trace_out)
            say(f"  trace: {tracer.n_events} events "
                f"({tracer.dropped} dropped) -> {args.trace_out}")
        if args.metrics_out:
            tracer.save_prometheus(args.metrics_out)
            say(f"  metrics: -> {args.metrics_out}")
        if args.plan_drift:
            say(tracer.drift.format_table())
    return [h.tokens for h in handles]


def _run_engine(cfg, args, rng) -> None:
    """The single-request engine on one seeded prompt."""
    from repro_torch.core.engine import InferenceEngine

    eng = InferenceEngine(cfg, mode=args.mode, prefill_strategy=args.strategy,
                          fast_sync=not args.no_fast_sync, device=args.device)
    prompt = rng.integers(0, cfg.vocab_size,
                          (1, args.prompt_len)).astype(np.int64)
    toks = eng.generate(prompt, args.new_tokens)
    print(f"mode={args.mode} strategy={args.strategy} "
          f"fast_sync={not args.no_fast_sync} out={tuple(toks.shape)} "
          f"device={eng.device} {eng.stats.tokens_per_s()}")


if __name__ == "__main__":
    main()
