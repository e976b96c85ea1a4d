"""Speculative decoding: draft on the flexible path, verify K+1 tokens per
target dispatch on the solver-planned path, roll the paged KV cache back to
the accepted prefix.

  * **Draft** — a small model (``SpecConfig.draft``, e.g. ``smollm-135m``,
    or the target itself) greedily proposes K tokens a round.
    :class:`DraftLanes` holds the per-lane draft caches (one batched dense
    cache, per-lane write cursors); its K+1 steps are one captured loop on
    the card under ``sync='device'`` (``core/sync.py::slot_decode_loop``,
    the counterpart of the reference's ``generate_on_device`` scan) and
    K+1 eager steps under ``sync='host'``. Its per-lane decode attends
    through plain torch (``layers.slot_attention``): kernel 2.5 takes one
    length for the whole batch; its prompt prefill goes through the flash
    kernel (``transformer.prefill_slot``).
  * **Verify** — ONE target dispatch (``transformer.paged_verify``) scores
    the K+1 positions through a ``HeteroCtx`` resolving the solver's
    VERIFY decisions; ``sampler.greedy_verify`` accepts losslessly. In a
    ``PagedBatcher`` the dispatch is its layout's ``paged_verify``
    (serving/layout.py): under tensor parallelism each rank verifies on
    its slices, while the draft lanes keep the full draft params on every
    rank and run with no collective.
  * **Rollback** — ``PagedKVCache.truncate_to`` returns whole blocks past
    the accepted prefix; the draft lanes reset their cursors.

:class:`SpecDecoder` is the single-stream engine (one request, one lane);
``PagedBatcher(spec=...)`` runs the same round across its decode lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Optional

import numpy as np
import torch

from ..configs import dtype_of
from ..core.sync import (graph_pool, loop_stats, make_call, slot_decode_loop,
                         stage, traced_dispatch)
from ..device import resolve_device
from ..models import build_model
from .paged_cache import PagedKVCache
from .sampler import greedy_verify
from .trace import NULL_TRACER


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding settings: ``draft`` is a config name of
    ``repro_torch.configs`` (resolved with ``get_smoke_config`` when
    ``smoke``), a ``ModelConfig``, or None for self-speculation; ``k`` the
    drafts a round (up to k+1 tokens a target dispatch). Only greedy
    verification is implemented, the arm whose stream is provably the
    non-speculative greedy stream."""
    k: int = 4
    draft: Any = None                # name | ModelConfig | None (self-draft)
    smoke: bool = False              # name resolution: smoke-scale configs

    def resolve_draft(self, target_cfg):
        """The draft's ModelConfig, the pairing validated."""
        if self.k < 1:
            raise ValueError(f"speculation length k must be >= 1, got {self.k}")
        d = self.draft
        if isinstance(d, str):
            from ..configs import get_config, get_smoke_config
            d = get_smoke_config(d) if self.smoke else get_config(d)
        elif d is None:
            d = target_cfg
        if d.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft {d.name} (vocab {d.vocab_size}) and target "
                f"{target_cfg.name} (vocab {target_cfg.vocab_size}) must "
                "share one token space for speculative decoding")
        if d.encoder_only or d.rwkv is not None or d.ssm is not None:
            raise ValueError(f"draft {d.name}: drafting needs a decoder "
                             "attention-family model")
        return d


class DraftLanes:
    """Per-lane draft caches behind one batched dense KV cache on
    ``device``: lane b owns slot b of a ``[lanes, max_len]`` cache and a
    host write cursor. Prompts prefill bucket-chunked into their slot; a
    draft round runs k+1 greedy steps (the pending token, then each draft
    including the k-th, so a fully accepted round leaves no hole); rollback
    is a cursor reset (stale slots past it are masked and rewritten before
    a later query reads them). ``dispatches`` counts every draft-model
    dispatch, prefill chunks included; a live ``tracer`` records each
    (``draft_prefill_chunk``, ``spec_draft``)."""

    def __init__(self, cfg, params, *, lanes: int, max_len: int,
                 buckets=(64, 128, 256), sync: str = "host", dtype=None,
                 device="cuda", tracer=None):
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.W = lanes
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        self.sync = sync
        dtype = dtype if dtype is not None else dtype_of(cfg.compute_dtype)
        self.cache = self.model.init_cache(batch=lanes, max_len=max_len,
                                           dtype=dtype, device=self.device)
        self.cache["index"] = torch.zeros((lanes,), dtype=torch.int32,
                                          device=self.device)
        self.idx = np.zeros((lanes,), np.int32)   # per-lane write cursors
        self.dispatches = 0
        self.loops: dict[int, object] = {}        # steps -> captured round

    def prefill(self, lane: int, prompt: np.ndarray) -> None:
        """Bucket-chunked prompt prefill into ``lane``'s slot."""
        from .scheduler import bucket_chunks   # deferred: avoids a cycle
        idx = 0
        for c in bucket_chunks(len(prompt), self.buckets):
            piece = torch.as_tensor(np.asarray(prompt[idx: idx + c],
                                               np.int64), device=self.device)
            with traced_dispatch(self.tracer, "draft_prefill_chunk",
                                 self.cache["k"], track="draft",
                                 args={"lane": lane, "chunk": c,
                                       "start": idx}):
                self.model.prefill_slot(self.params, self.cache, piece, lane,
                                        idx)
            self.dispatches += 1
            self.tracer.count("draft_dispatches")
            idx += c
        self.idx[lane] = len(prompt)

    def draft(self, last: np.ndarray, k: int) -> np.ndarray:
        """One round: feed each lane's pending token (``last`` [W, 1]) and
        roll k+1 greedy steps forward. Returns drafts [W, k] (the k+1-th
        prediction is dropped: that step writes the k-th draft's KV).
        Inactive lanes draft garbage that the caller ignores."""
        tok, index = stage(last, self.idx, device=self.device)
        if self.sync == "device" and k + 1 not in self.loops:
            self.loops[k + 1] = slot_decode_loop(self.model, self.params,
                                                 self.cache, k + 1)
        with traced_dispatch(self.tracer, "spec_draft", self.cache["k"],
                             track="draft", args={"k": k, "sync": self.sync,
                                                  "lanes": self.W}):
            if self.sync == "device":
                toks, _ = self.loops[k + 1](tok, index)
                self.dispatches += 1
                self.tracer.count("draft_dispatches")
            else:
                cache = {**self.cache, "index": index.to(self.device)}
                tok, outs = tok.to(self.device), []
                for _ in range(k + 1):
                    logits, cache = self.model.decode_step(self.params, tok,
                                                           cache)
                    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                    outs.append(tok[:, 0])
                    self.dispatches += 1
                    self.tracer.count("draft_dispatches")
                toks = torch.stack(outs, dim=1)
        self.idx = self.idx + np.int32(k + 1)
        return toks[:, :k].cpu().numpy()

    def rollback(self, lane: int, n_tokens: int) -> None:
        """Reset ``lane``'s cursor to the accepted token count."""
        self.idx[lane] = n_tokens


class SpecDecoder:
    """Single-stream speculative decoding over the paged KV pool on
    ``device`` (the card unless ``"cpu"`` is asked for): the prompt
    prefills through the (optional) solver-planned ``HeteroCtx``, then
    rounds of draft → ``paged_verify`` (one target dispatch) →
    ``greedy_verify`` → ``truncate_to`` until the budget (or ``eos_id``).
    The tokens are the target's greedy tokens; drafting only changes how
    many target dispatches they cost. On the card each prefill chunk length
    and the verify round are captured calls (``core/sync.py::make_call``)
    sharing one memory pool."""

    def __init__(self, cfg, params=None, *, spec: SpecConfig = SpecConfig(),
                 draft_params=None, max_len: int = 512,
                 buckets=(64, 128, 256), engine_mode: Optional[str] = None,
                 sync: str = "host", eos_id: Optional[int] = None,
                 cache_dtype=None, seed: int = 0, device="cuda"):
        if sync not in ("host", "device"):
            raise ValueError(f"sync must be 'host' or 'device', got {sync!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        if self.model.paged_verify is None:
            raise ValueError(f"{cfg.name}: speculative decoding requires an "
                             "attention-family target model")
        self.params = params if params is not None else self.model.init(
            torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        self.spec = spec
        self.eos_id = eos_id
        self.buckets = tuple(sorted(buckets))
        self.max_len = max_len
        block_size = 32
        dtype = (cache_dtype if cache_dtype is not None
                 else dtype_of(cfg.compute_dtype))
        self.kv = PagedKVCache(cfg,
                               num_blocks=1 + -(-(max_len + spec.k)
                                                // block_size),
                               block_size=block_size, dtype=dtype,
                               device=self.device)
        self.draft_cfg = draft_cfg = spec.resolve_draft(cfg)
        if draft_params is None:
            draft_params = (self.params if draft_cfg is cfg else
                            build_model(draft_cfg).init(
                                torch.Generator(device=self.device
                                                ).manual_seed(seed + 1),
                                device=self.device))
        self.drafts = DraftLanes(draft_cfg, draft_params, lanes=1,
                                 max_len=max_len + spec.k + 1,
                                 buckets=self.buckets, sync=sync,
                                 dtype=(torch.float32
                                        if dtype == torch.float32 else None),
                                 device=self.device)
        if engine_mode is not None:
            from ..core.engine import build_hetero_ctx
            self.ctx = build_hetero_ctx(
                cfg, engine_mode,
                sync_mode="fast" if sync == "device" else "host",
                verify_ks=((spec.k, 1),))
            vctx = self.ctx.for_verify(spec.k, 1)
        else:
            self.ctx = vctx = None
        self._prefill = partial(self.model.paged_prefill, hetero_ctx=self.ctx)
        self._verify = partial(self.model.paged_verify, hetero_ctx=vctx)
        # (kind, length) -> captured prefill or verify call, one shared pool
        self._calls: dict[tuple, object] = {}
        self._pool = graph_pool(self.device)
        self.rounds = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.prefill_dispatches = 0
        self.verify_dispatches = 0
        self.emitted_tokens = 0

    def stats(self) -> dict:
        """Counter snapshot, the reference's keys."""
        return {
            "spec_k": self.spec.k,
            "draft_model": self.draft_cfg.name,
            "rounds": self.rounds,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": (self.accepted_tokens /
                                max(self.drafted_tokens, 1)),
            "prefill_dispatches": self.prefill_dispatches,
            "verify_dispatches": self.verify_dispatches,
            "draft_dispatches": self.drafts.dispatches,
            "target_dispatches": (self.prefill_dispatches +
                                  self.verify_dispatches),
            "emitted_tokens": self.emitted_tokens,
        }

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def graph_stats(self) -> dict:
        """The draft lanes' decode graphs, and under ``calls`` the prefill
        and verify graphs (pool bytes: their one shared pool's); none on
        the CPU."""
        return {**loop_stats(self.drafts.loops.values()),
                "calls": loop_stats(self._calls.values())}

    def _call(self, kind: str, length: int):
        """``kind``'s ('prefill' per chunk length, 'verify' per K + 1)
        captured call over the pool, on staged tokens [1, length], block
        table [1, NBmax] and start (a 0-dim one, or [1] for verify); its
        logits hold until the next call."""
        key = (kind, length)
        if key not in self._calls:
            fn = self._prefill if kind == "prefill" else self._verify

            def body(tokens, table, start):
                return fn(self.params, tokens, self.kv.pool,
                          block_table=table, start_index=start)[0]

            self._calls[key] = make_call(body, self.device, pool=self._pool)
        return self._calls[key]

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 16
                 ) -> list[int]:
        """Greedy-generate ``max_new_tokens`` tokens after ``prompt`` ([S]).
        Returns the emitted token list."""
        from .scheduler import bucket_chunks   # deferred: avoids a cycle
        S = len(prompt)
        if S + max_new_tokens + self.spec.k > self.max_len:
            raise ValueError(f"prompt {S} + budget {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        seq = self.kv.open_sequence(prompt_tokens=S,
                                    total_tokens=S + max_new_tokens)
        idx, logits = 0, None
        for c in bucket_chunks(S, self.buckets):
            logits = self._call("prefill", c)(*stage(
                np.asarray(prompt[idx: idx + c])[None], seq.table[None], idx,
                device=self.device))
            self.prefill_dispatches += 1
            idx += c
        seq.length = S
        self.drafts.prefill(0, np.asarray(prompt))

        k = self.spec.k
        out = [int(torch.argmax(logits[0, -1]))]
        budget = max_new_tokens - 1
        if self.eos_id is not None and out[0] == self.eos_id:
            budget = 0
        while budget > 0:
            # rows past the remaining budget are never emitted: growth stays
            # inside the reservation, writes past it sink in the null block
            self.kv.grow_to(seq, seq.length + min(k + 1, budget))
            last = np.asarray([[out[-1]]], np.int64)
            drafts = self.drafts.draft(last, k)                  # [1, k]
            tokens = np.concatenate([last, drafts], axis=1)      # [1, k+1]
            # the table, every round
            logits = self._call("verify", k + 1)(*stage(
                tokens, seq.table[None], [seq.length], device=self.device))
            self.verify_dispatches += 1
            emitted, n_emit = greedy_verify(self._tensor(drafts), logits)
            n = int(n_emit[0])
            round_budget = budget
            toks = [int(t) for t in emitted[0, :min(n, budget)].tolist()]
            if self.eos_id is not None and self.eos_id in toks:
                toks = toks[: toks.index(self.eos_id) + 1]
                budget = len(toks)                       # exhausted below
            self.rounds += 1
            # the acceptance rate counts only budget-covered drafts and
            # acceptances that emitted
            self.drafted_tokens += min(k, round_budget)
            self.accepted_tokens += min(n - 1, len(toks))
            out.extend(toks)
            budget -= len(toks)
            new_len = seq.length + len(toks)
            self.kv.truncate_to(seq, new_len)            # paged rollback
            seq.length = new_len
            self.drafts.rollback(0, new_len)             # draft rollback
        self.emitted_tokens += len(out)
        self.kv.close_sequence(seq)
        return out
