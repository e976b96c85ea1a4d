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

Without ``--batched`` it runs the single-request HeteroInfer engine
(``InferenceEngine.generate`` on one seeded prompt of ``--prompt-len``
tokens) and prints its prefill and decode tok/s, for the dense models and
the Mamba2 hybrid (``--arch zamba2-2.7b``); with ``--batched --paged`` it
drives ``PagedBatcher.run`` on seeded synthetic prompts and prints tok/s
and the dispatch counts (dense models only: the hybrid has no paged KV
cache, and the batcher refuses it). Weights are random and seeded. Runs on the card
unless ``--device cpu`` is given (use ``--smoke`` there).

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
  --stats           print the scheduler's stats() counter dict

The dense continuous batcher (``--batched`` alone), the async ingress,
tensor parallelism, tracing and the other serving options of
``repro.launch.serve`` are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


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
                    help="print the scheduler's stats() counter dict")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.batched and not args.paged:
        ap.error("only the paged batcher is ported: add --paged")
    if (args.sync == "device" or args.engine_mode or args.eos_id is not None
            or args.weight_quant or args.kv_quant or args.mixed_batch
            or args.spec_k is not None or args.prefix_cache
            or args.shared_prefix) and not args.batched:
        ap.error("--sync device / --engine-mode / --eos-id / --weight-quant "
                 "/ --kv-quant / --mixed-batch / --spec-k / --prefix-cache / "
                 "--shared-prefix apply to the paged batcher: add --batched "
                 "--paged")
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

    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    if not args.batched:
        _run_engine(cfg, args, rng)
        return

    from repro_torch.core.sync import fence
    from repro_torch.serving.scheduler import PagedBatcher, Request
    from repro_torch.serving.spec import SpecConfig

    max_len = args.prompt_len + args.new_tokens + 8
    blocks_per_req = -(-max_len // args.block_size)
    num_blocks = args.max_blocks or 1 + args.requests * blocks_per_req
    spec = (SpecConfig(k=args.spec_k, draft=args.spec_draft,
                       smoke=args.smoke) if args.spec_k is not None else None)
    cb = PagedBatcher(cfg, num_blocks=num_blocks, block_size=args.block_size,
                      max_blocks_per_seq=blocks_per_req,
                      decode_width=args.decode_width, sync=args.sync,
                      window=args.window, engine_mode=args.engine_mode,
                      eos_id=args.eos_id, mixed_batch=args.mixed_batch,
                      max_prefill_chunk_per_step=args.max_prefill_chunk,
                      spec=spec, prefix_cache=args.prefix_cache,
                      weight_quant=args.weight_quant,
                      kv_quant=args.kv_quant, device=args.device)
    shared = rng.integers(0, cfg.vocab_size,
                          args.shared_prefix).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, rng.integers(8, args.prompt_len
                                        - args.shared_prefix)
    ).astype(np.int32)]) for _ in range(args.requests)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=args.new_tokens)
            for i, p in enumerate(prompts)]
    fence(cb.kv.pool["k"])
    t0 = time.perf_counter()  # repolint: disable=determinism -- the launcher reports wall-clock tok/s of a real run; nothing reads it back
    cb.run(reqs)
    fence(cb.kv.pool["k"])
    dt = time.perf_counter() - t0  # repolint: disable=determinism -- end of the same wall-clock measurement
    tok = sum(len(r.output) for r in reqs)
    label = (f"paged (bs={args.block_size}, blocks={num_blocks}, "
             f"W={args.decode_width}, sync={args.sync}"
             + (f", window={args.window}" if args.sync == "device" else "")
             + (f", engine={args.engine_mode}" if args.engine_mode else "")
             + (", mixed" if args.mixed_batch else "")
             + (", prefix-cache" if args.prefix_cache else "")
             + (f", spec k={args.spec_k} draft={args.spec_draft or 'self'}"
                if spec else "")
             + (f", weights={args.weight_quant}" if args.weight_quant else "")
             + (f", kv={args.kv_quant}" if args.kv_quant else "")
             + f", device={cb.device})")
    print(f"{label}: {args.requests} reqs, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s, peak concurrency {cb.peak_active})")
    print(f"  decode: {cb.decode_dispatches} host dispatches for "
          f"{cb.decode_steps} decoded tokens "
          f"({cb.decode_steps / max(cb.decode_dispatches, 1):.1f} "
          f"tokens/dispatch)")
    print(f"  prefill: {cb.prefill_dispatches} standalone dispatches, "
          f"{cb.fused_steps} chunks fused into decode dispatches "
          f"({cb.total_dispatches} host dispatches total)")
    s = cb.stats()
    if spec is not None:
        print(f"  spec: {s['verify_dispatches']} verify dispatches, "
              f"acceptance {s['acceptance_rate']:.2f} "
              f"({s['accepted_tokens']}/{s['drafted_tokens']} drafts, "
              f"draft={s['draft_model']})")
    if args.prefix_cache:
        print(f"  prefix-cache: {s['prefix_hits']} hit admissions, "
              f"{s['prefix_tokens_reused']} prompt tokens reused, "
              f"{s['cached_blocks']} blocks retained, {s['evictions']} "
              f"evictions, {s['cow_copies']} CoW copies")
    if args.stats:
        print(f"  stats: {s}")


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
