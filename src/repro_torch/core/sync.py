"""Fast synchronization (paper §4.3) on the card.

The paper's problem: a host-driver sync between kernels (clFinish, ~400 us)
dwarfs decode kernels. The reference keeps a whole loop of decode steps in
one device program (a jitted ``lax.scan``) and reads back to the host once
at its end. The port captures the same loops as CUDA graphs: one replay
runs every launch of the loop, with no Python between them.

  * ``fence`` — the port's ONE ``torch.cuda.synchronize`` site; grepping
    for ``fence(`` lists every planned sync point.
  * ``CapturedLoop`` — a loop body captured as one CUDA graph over static
    input buffers (warmed up once on a side stream, then captured); a call
    copies its inputs in and replays. ``make_loop`` gives one on the card
    and the body itself on the CPU, so both devices run the same staging;
    also the body itself where the caller says the body cannot be captured
    (a tensor-parallel layout over gloo, whose collectives a graph cannot
    record).
  * ``make_call`` / ``CapturedCall`` — a one-shot dispatch (a prefill
    chunk, a verify round: the reference's other jitted calls, one graph
    per chunk length) captured at its first call on that call's inputs,
    whose warm-up is that first call, and replayed on every later one;
    all of one owner's calls share one private memory pool
    (``graph_pool``). On the CPU the body itself; eager on the card where
    the caller's backend cannot be captured.
  * ``decode_loop`` — the single-request engine's loops over its dense
    cache. ``generate_on_device`` (fast sync) runs all ``n_steps`` greedy
    steps in one replay, the position and the tokens kept on the device;
    ``generate_host_loop`` (the baseline) replays one step per token and
    waits for it, carrying its token to the host and back (the clFinish
    analogue, the per-token cost the paper measures).
  * ``paged_window_loop`` — the batcher's fused WINDOW of batched paged
    decode steps (the ``model``'s, or a layout's ``PagedSteps``) with no
    host read inside it, so the scheduler pays one
    host round-trip per window instead of per token; ``paged_step_loop``
    its host-synced tick's one step. Finished lanes are masked, as the
    reference's ``_masked_step`` does: a lane whose budget ran out or that
    hit EOS gets the null block table and length 0, so its writes sink into
    the pool's null block.
  * ``paged_mixed_window_loop`` / ``paged_mixed_step_loop`` — the window
    and the tick carrying one prefill chunk of an admitting request (mixed
    batching: step 0 is the model's ``mixed_step``), one loop per chunk
    length; ``slot_decode_loop`` — speculative decoding's draft round,
    k + 1 greedy steps over a dense cache with per-slot indices.
  * ``generate_on_device_eager``, ``generate_host_loop_eager`` and
    ``paged_decode_window_eager`` — the plain versions, issued step by step:
    the graphs' bodies, what the CPU runs, and the yardstick the card's
    captured loops are held to.
  * ``traced_dispatch`` / ``window_replay`` — the tracer's dispatch span
    and a window's ``fused_window`` span (the tracer duck-typed: core never
    imports serving). With a live tracer each closes after ``fence``, so on
    the card it times the work, not only its issue; with the tracer off
    neither adds an event or a fence.
  * ``measure_dispatch_overhead`` — the median cost of one trivial launch
    plus a sync on this device, the solver's T_sync in host mode.
"""
from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from functools import lru_cache, partial

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import launch_counts
from ..serving.sampler import SamplerConfig, sample


def fence(*values):
    """Block until the device has finished the work queued so far, and
    return ``values`` unchanged (the single value un-tupled)."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in values):
        torch.cuda.synchronize()
    return values[0] if len(values) == 1 else values


@contextmanager
def _fenced(span, *anchors):
    with span:
        yield
        fence(*anchors)


def traced_dispatch(tracer, kind: str, anchor, **kw):
    """``tracer.dispatch(kind, **kw)`` around work queued on ``anchor``'s
    device, closed after ``fence(anchor)``: the span's duration is the
    dispatch's issue and its device time. With the tracer off, its no-op
    context (no event, no fence)."""
    if not tracer.enabled:
        return tracer.dispatch(kind)
    return _fenced(tracer.dispatch(kind, **kw), anchor)


def window_replay(loop, inputs, *, n_steps: int, mixed: bool = False,
                  tracer=None):
    """One call of a batcher's window ``loop`` on ``inputs`` (a replay of
    its graph on the card). With ``tracer`` (None when tracing is off) the
    call runs inside a ``fused_window`` span that closes after its outputs
    are fenced, so the trace shows the replay, the one host round-trip of
    the window, inside the scheduler's dispatch span."""
    if tracer is None:
        return loop(*inputs)
    with tracer.span("fused_window", track="decode", cat="sync",
                     args={"n_steps": int(n_steps), "mixed": mixed}):
        out = loop(*inputs)
        fence(*(out if isinstance(out, tuple) else (out,)))
    return out


# ------------------------------------------------------------ graph runner --

class CapturedLoop:
    """``body(*inputs)`` captured as one CUDA graph over static copies of
    ``inputs``, which keep the values given here.

    Construction runs ``body`` once on a side stream, so that every
    first-use cost (building and binding a kernel, its shared-memory
    attribute, the launch plans, cuBLAS's handles) is paid outside the
    capture; that warm-up really runs, so ``body`` must be harmless on these
    inputs. It then captures ``body`` into a private memory pool
    (``pool_bytes`` is what the capture reserved). ``generator``, where
    given, is registered with the graph, so each replay draws new numbers
    from it; its state is put back after the warm-up, so the first replay
    draws from where an eager run would.

    Under tensor parallelism over NCCL the body's collectives are recorded
    too; the warm-up issues the first of them (which sets up the
    communicator) before the capture.

    A call copies its inputs into the static buffers (without waiting for
    the host: the batcher stages its inputs in page-locked memory),
    replays, and returns the static outputs, which the next replay
    overwrites. The wrappers count launches in Python, which a replay does
    not run: the launches the capture recorded are taken off the counters
    (nothing ran) and added back on every replay (``launches``).

    ``pool``: the private memory pool to capture into (a
    ``torch.cuda.graph_pool_handle`` shared with other graphs), else the
    graph's own; ``keep_warm``: keep the warm-up's outputs as
    ``warm_outputs`` (a :class:`CapturedCall`'s first call)."""

    def __init__(self, body, inputs, *, generator=None, pool=None,
                 keep_warm: bool = False):
        self.inputs = tuple(t.clone() for t in inputs)
        self.replays = 0
        self.pool = pool
        state = generator.get_state() if generator is not None else None
        warm = self._warm_up(body)
        self.warm_outputs = warm if keep_warm else None
        if state is not None:
            generator.set_state(state)
        before = launch_counts()
        self.outputs, self.graph, self.pool_bytes = self._record(body,
                                                                 generator)
        self.launches = {w: n - before.get(w, 0)
                         for w, n in launch_counts().items()
                         if n != before.get(w, 0)}
        for w, n in self.launches.items():
            w.launches -= n

    def _warm_up(self, body):
        """``body`` run once on the static inputs on the device's graph
        stream; its outputs, marked as used on the current stream (the
        caller's)."""
        device = self.inputs[0].device
        main = torch.cuda.current_stream(device)
        side = graph_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = body(*self.inputs)
        main.wait_stream(side)
        for t in out if isinstance(out, tuple) else (out,):
            t.record_stream(main)
        return out

    def _record(self, body, generator):
        """(static outputs, graph, pool bytes) of one capture of ``body`` on
        the device's graph stream, into ``self.pool`` where given, else a
        pool of its own. One stream for every capture: a pool's free blocks
        are kept by stream, so graphs that share a pool reuse each other's
        temporaries only when captured on one stream. The garbage collector
        does not run during the capture: a graph that it destroyed there
        (one dropped in a reference cycle) would invalidate the capture. Nor
        does it run before it, as
        ``torch.cuda.graph`` may have it do: a full collection costs a
        large process a tenth of a second or more, and every request shape
        of an engine or a batcher captures its own calls; the allocator's
        cache is emptied first, so the pool's bytes are what the capture
        reserved."""
        device = self.inputs[0].device
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        fence(self.inputs[0])
        torch.cuda.empty_cache()          # what capture reserves shows alone
        reserved = torch.cuda.memory_reserved(device)
        main = torch.cuda.current_stream(device)
        stream = graph_stream(device)
        stream.wait_stream(main)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(*(() if self.pool is None
                                      else (self.pool,)))
                try:
                    outputs = body(*self.inputs)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(stream)
        return outputs, graph, torch.cuda.memory_reserved(device) - reserved

    def __call__(self, *inputs):
        for static, value in zip(self.inputs, inputs, strict=True):
            static.copy_(value, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for w, n in self.launches.items():
            w.launches += n
        return self.outputs


def make_loop(body, inputs, *, generator=None, capture: bool = True):
    """``body`` as a :class:`CapturedLoop` on ``inputs``' CUDA device; on
    the CPU, ``body`` itself, called eagerly with each call's inputs. On
    the card with ``capture`` False, ``body`` called eagerly on each call's
    inputs copied to the card (the callers stage them in host memory, as
    for a graph's buffers)."""
    if not inputs[0].is_cuda:
        return body
    if capture:
        return CapturedLoop(body, inputs, generator=generator)
    return partial(_eager_on, body, inputs[0].device)


def _eager_on(body, device, *inputs):
    return body(*(t.to(device, non_blocking=True) for t in inputs))


class CapturedCall(CapturedLoop):
    """A one-shot dispatch (a prefill chunk, a verify round) as a CUDA
    graph, captured at its first call on that call's inputs: the
    :class:`CapturedLoop` set up then warms up on them, so its warm-up IS
    the first call (its outputs are that call's, and the cache or pool it
    writes ends as after one eager call: the capture runs nothing), and
    every later call copies its inputs into the static buffers and replays.
    The capture goes into ``pool``, the private memory pool that all of
    one owner's calls share (``graph_pool``): a call's static outputs stay
    referenced by its graph, its temporaries are reused by the others, so
    a call's outputs hold only until the next call of ANY graph of the
    pool; copy what must outlive it."""

    def __init__(self, body, device, pool):
        self.body, self.device, self.pool = body, device, pool
        self.graph, self.replays, self.pool_bytes = None, 0, 0

    def __call__(self, *inputs):
        if self.graph is not None:
            return super().__call__(*inputs)
        super().__init__(self.body, tuple(t.to(self.device) for t in inputs),
                         pool=self.pool, keep_warm=True)
        out, self.warm_outputs = self.warm_outputs, None
        return out


def graph_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream on which every graph of CUDA ``device`` is warmed up and
    captured: one per device, made at its first use."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _graph_stream(index)


@lru_cache(maxsize=None)
def _graph_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(device=index)


def graph_pool(device):
    """One private memory pool for an owner's captured calls on ``device``
    (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


def make_call(body, device, *, pool=None, capture: bool = True):
    """``body``, a one-shot dispatch on staged inputs (tokens, a 0-dim
    start or ``[B]`` starts, a block table: ``stage``'s host tensors), as
    a :class:`CapturedCall` on the card, captured into ``pool`` at its
    first call; on the CPU ``body`` itself, called eagerly with each
    call's inputs; on the card with ``capture`` False (a layout whose
    collectives a graph cannot record), ``body`` called eagerly on each
    call's inputs copied to the card. The caller's backend decides
    ``capture``: a capture that fails raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return body
    if capture:
        return CapturedCall(body, device, pool)
    return partial(_eager_on, body, device)


def stage(*arrays, device) -> list:
    """Host arrays as int64 tensors for a loop's inputs: page-locked when
    ``device`` is the card, so that copying them into a graph's buffers
    does not wait for the host."""
    staged = [torch.from_numpy(np.asarray(a, np.int64)) for a in arrays]
    if torch.device(device).type == "cuda":
        staged = [t.pin_memory() for t in staged]
    return staged


def loop_stats(loops) -> dict:
    """Graphs captured among ``loops`` (decode loops, or captured calls:
    then their shared pool's bytes), their replays and pool bytes."""
    graphs = [lp for lp in loops
              if isinstance(lp, CapturedLoop) and lp.graph is not None]
    return {"graphs": len(graphs),
            "replays": sum(lp.replays for lp in graphs),
            "pool_bytes": sum(lp.pool_bytes for lp in graphs)}


# ------------------------------------------------------------ plain loops --

def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]


def greedy_step(model, params, token, cache):
    """One greedy decode step: (next token [B, 1], cache)."""
    logits, cache = model.decode_step(params, token, cache)
    return _greedy(logits), cache


def generate_on_device_eager(model, params, first_token, cache,
                             n_steps: int):
    """Plain fast sync: ``n_steps`` greedy decode steps issued one by one,
    with no host read inside the loop. first_token: [B, 1]; ``cache
    ["index"]`` a device scalar. Returns (tokens [B, n_steps], cache)."""
    token, toks = first_token, []
    for _ in range(n_steps):
        token, cache = greedy_step(model, params, token, cache)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1), cache


def generate_host_loop_eager(model, params, first_token, cache,
                             n_steps: int):
    """Plain host sync: each step issued, waited for (``fence``) and its
    token brought to the host and back. Returns (tokens [B, n_steps],
    cache)."""
    token, toks = first_token, []
    for _ in range(n_steps):
        nxt, cache = greedy_step(model, params, token, cache)
        token = fence(nxt).cpu().to(first_token.device)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1), cache


def _masked_step(run, token, lengths, remaining, block_tables, *, sampler,
                 eos_id, generator):
    """One masked batched decode step of a window. ``run(token, tables,
    lengths)`` is the step's body (a paged decode step, or a mixed step);
    finished lanes get the null table and length 0, so their writes sink
    into the null block. Returns (next tokens [W], active [W], lengths,
    remaining)."""
    active = remaining > 0
    logits = run(token, torch.where(active[:, None], block_tables, 0),
                 torch.where(active, lengths, 0))
    if sampler is None or sampler.temperature <= 0.0:
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
    else:
        nxt = sample(logits[:, -1, :], generator, sampler)
    nxt = torch.where(active, nxt, token[:, 0])
    new_remaining = torch.where(active, remaining - 1, 0)
    if eos_id is not None:
        new_remaining = torch.where(active & (nxt == eos_id), 0,
                                    new_remaining)
    return nxt, active, lengths + active.long(), new_remaining


def paged_decode_window_eager(model, params, last_token, pool, block_tables,
                              lengths, remaining, n_steps: int, *,
                              sampler: SamplerConfig | None = None,
                              eos_id=None, generator=None,
                              prefill_tokens=None, prefill_table=None,
                              prefill_start=0, mixed_step_fn=None):
    """``n_steps`` masked batched decode steps issued one by one, with no
    host read.

    last_token: [W, 1] each lane's latest token; block_tables: [W, NBmax]
    (pre-grown on the host to cover the window's writes); lengths: [W] write
    positions; remaining: [W] steps each lane may still emit (0 = inactive).
    Greedy when ``sampler`` is None or temperature 0, else draws from
    ``generator``. Returns (tokens [W, n_steps], valid [W, n_steps] bool,
    pool, final lengths [W], final remaining [W]), all on the device.

    With ``prefill_tokens`` ([1, C]), ``prefill_table`` ([1, NBmax]) and
    ``prefill_start`` (an int or a 0-dim tensor) the window carries one
    prefill chunk of an admitting request: step 0 is ``mixed_step_fn``
    (the model's ``mixed_step``, its chunk through the batcher's
    HeteroCtx), the other ``n_steps - 1`` steps plain decode, and the
    return gains the chunk's last-token logits third: (tokens, valid,
    prefill logits [1, 1, V], pool, lengths, remaining).
    """
    def decode(token, tables, lens):
        return model.paged_decode_step(params, token, pool,
                                       block_tables=tables, lengths=lens)[0]

    pre_logits = []

    def mixed(token, tables, lens):
        logits, pre, _ = mixed_step_fn(
            params, token, prefill_tokens, pool, decode_tables=tables,
            decode_lengths=lens, prefill_table=prefill_table,
            prefill_start=prefill_start)
        pre_logits.append(pre)
        return logits

    token = last_token
    toks, valids = [], []
    for step in range(n_steps):
        run = mixed if step == 0 and prefill_tokens is not None else decode
        nxt, active, lengths, remaining = _masked_step(
            run, token, lengths, remaining, block_tables, sampler=sampler,
            eos_id=eos_id, generator=generator)
        token = nxt[:, None]
        toks.append(nxt)
        valids.append(active)
    toks, valid = torch.stack(toks, dim=1), torch.stack(valids, dim=1)
    if prefill_tokens is None:
        return toks, valid, pool, lengths, remaining
    return toks, valid, pre_logits[0], pool, lengths, remaining


# ------------------------------------------------------- the engine's loops --

def decode_loop(model, params, cache, n_steps: int, *,
                host_sync: bool = False):
    """The single-request engine's decode loop over ``cache`` (see
    :func:`make_loop`): ``loop(token [B, 1], index)`` returns (tokens
    [B, n_steps], index + n_steps) under fast sync, (next token [B, 1],
    index + 1) under host sync. On the card it is captured here on token 0
    at position 0, so make it before anything is prefilled into ``cache``:
    the warm-up writes the cache from position 0, which the prefill then
    writes over (a Mamba2 or RWKV prefill from position 0 starts from zero
    states)."""
    device = cache["index"].device
    # every state of a cache is [layers, batch, ...]
    batch = next(t for name, t in cache.items() if name != "index").shape[1]
    token = torch.zeros((batch, 1), dtype=torch.long, device=device)
    index = torch.zeros((), dtype=torch.int32, device=device)

    def body(token, index):
        run = {**cache, "index": index}
        if host_sync:
            out, run = greedy_step(model, params, token, run)
        else:
            out, run = generate_on_device_eager(model, params, token, run,
                                                n_steps)
        return out, run["index"]

    return make_loop(body, (token, index))


def generate_on_device(loop, first_token, cache):
    """Fast sync: the whole decode loop in one call of ``loop``, a
    :func:`decode_loop` over ``cache`` (on the card one graph replay, no
    host read inside). Returns (tokens [B, n_steps], cache), both on the
    device."""
    toks, index = loop(first_token, cache["index"])
    return toks.clone(), {**cache, "index": index.clone()}


def generate_host_loop(loop, first_token, cache, n_steps: int):
    """Baseline: one call of ``loop``, a host-sync :func:`decode_loop`,
    per token; each waits for the device (``fence``) and brings its token
    to the host and back. Returns (tokens [B, n_steps], cache)."""
    token, index, toks = first_token, cache["index"], []
    for _ in range(n_steps):
        nxt, index = loop(token, index)
        token = fence(nxt).cpu().to(first_token.device)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1), {**cache, "index": index.clone()}


# ------------------------------------------------------ the batcher's loops --

def paged_window_loop(model, params, pool, width: int, max_blocks: int,
                      n_steps: int, *, sampler: SamplerConfig | None = None,
                      eos_id=None, generator=None, capture: bool = True):
    """The batcher's fused window over ``pool`` (see :func:`make_loop`):
    ``loop(last [W, 1], tables [W, NBmax], lengths [W], remaining [W])``
    runs :func:`paged_decode_window_eager`'s ``n_steps`` steps and returns
    tokens [W, n_steps] with -1 where a lane emitted nothing, so the host
    reads a window back in one copy. Captured on all-zero inputs: every
    lane inactive, every write in the null block."""
    zeros = _zeros(pool["k"].device)
    sampled = sampler is not None and sampler.temperature > 0.0

    def body(last, tables, lengths, remaining):
        toks, valid, _, _, _ = paged_decode_window_eager(
            model, params, last, pool, tables, lengths, remaining, n_steps,
            sampler=sampler, eos_id=eos_id, generator=generator)
        return torch.where(valid, toks, -1)

    return make_loop(body, (zeros(width, 1), zeros(width, max_blocks),
                            zeros(width), zeros(width)),
                     generator=generator if sampled else None,
                     capture=capture)


def paged_step_loop(model, params, pool, width: int, max_blocks: int, *,
                    capture: bool = True):
    """The host-synced tick's one batched paged decode step over ``pool``
    (see :func:`make_loop`): ``loop(last [W, 1], tables [W, NBmax], lengths
    [W])`` returns logits [W, 1, V]; sampling stays with the caller.
    Captured on all-zero inputs, as :func:`paged_window_loop`."""
    zeros = _zeros(pool["k"].device)

    def body(last, tables, lengths):
        logits, _ = model.paged_decode_step(params, last, pool,
                                            block_tables=tables,
                                            lengths=lengths)
        return logits

    return make_loop(body, (zeros(width, 1), zeros(width, max_blocks),
                            zeros(width)), capture=capture)


def paged_mixed_window_loop(model, params, pool, width: int,
                            max_blocks: int, n_steps: int, chunk: int, *,
                            mixed_step_fn, sampler: SamplerConfig | None = None,
                            eos_id=None, generator=None, capture: bool = True):
    """The batcher's window carrying one prefill chunk of ``chunk`` tokens
    (see :func:`make_loop`): ``loop(last, tables, lengths, remaining,
    chunk_tokens [1, C], chunk_table [1, NBmax], start)``, ``start`` a
    0-dim tensor, runs :func:`paged_decode_window_eager`'s mixed window and
    returns (tokens [W, n_steps] with -1 where a lane emitted nothing, the
    chunk's last-token logits [1, 1, V]). One loop per chunk length (the
    admission buckets bound them). Captured on all-zero inputs: every lane
    inactive and the chunk at the null table, every write in the null
    block."""
    zeros = _zeros(pool["k"].device)
    sampled = sampler is not None and sampler.temperature > 0.0

    def body(last, tables, lengths, remaining, tokens, table, start):
        toks, valid, pre, _, _, _ = paged_decode_window_eager(
            model, params, last, pool, tables, lengths, remaining, n_steps,
            sampler=sampler, eos_id=eos_id, generator=generator,
            prefill_tokens=tokens, prefill_table=table, prefill_start=start,
            mixed_step_fn=mixed_step_fn)
        return torch.where(valid, toks, -1), pre

    return make_loop(body, (zeros(width, 1), zeros(width, max_blocks),
                            zeros(width), zeros(width), zeros(1, chunk),
                            zeros(1, max_blocks), zeros()),
                     generator=generator if sampled else None,
                     capture=capture)


def paged_mixed_step_loop(model, params, pool, width: int, max_blocks: int,
                          chunk: int, *, mixed_step_fn,
                          capture: bool = True):
    """The host-synced tick carrying one prefill chunk of ``chunk`` tokens
    (see :func:`make_loop`): ``loop(last, tables, lengths, chunk_tokens,
    chunk_table, start)`` returns (decode logits [W, 1, V], the chunk's
    last-token logits [1, 1, V]) of one ``mixed_step``; sampling stays
    with the caller. Captured on all-zero inputs, as
    :func:`paged_mixed_window_loop`."""
    zeros = _zeros(pool["k"].device)

    def body(last, tables, lengths, tokens, table, start):
        logits, pre, _ = mixed_step_fn(
            params, last, tokens, pool, decode_tables=tables,
            decode_lengths=lengths, prefill_table=table,
            prefill_start=start)
        return logits, pre

    return make_loop(body, (zeros(width, 1), zeros(width, max_blocks),
                            zeros(width), zeros(1, chunk),
                            zeros(1, max_blocks), zeros()), capture=capture)


def slot_decode_loop(model, params, cache, n_steps: int):
    """The draft lanes' round (see :func:`make_loop`): ``loop(token [W, 1],
    index [W])`` runs ``n_steps`` greedy decode steps over the dense
    ``cache`` with per-slot indices and returns (tokens [W, n_steps],
    index + n_steps). Captured with every lane at the cache's last slot,
    which no lane's valid position reaches, so the warm-up overwrites
    nothing a lane reads (the per-slot write clamps there)."""
    device = cache["k"].device
    width, last = cache["k"].shape[1], cache["k"].shape[2] - 1
    token = torch.zeros((width, 1), dtype=torch.long, device=device)
    index = torch.full((width,), last, dtype=torch.int32, device=device)

    def body(token, index):
        toks, run = generate_on_device_eager(
            model, params, token, {**cache, "index": index}, n_steps)
        return toks, run["index"]

    return make_loop(body, (token, index))


def _zeros(device):
    return lambda *shape: torch.zeros(shape, dtype=torch.long, device=device)


def measure_dispatch_overhead(n: int = 50, device="cuda") -> float:
    """Median microseconds of one trivial launch plus ``fence`` on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    x = torch.zeros((8,), dtype=torch.float32, device=resolve_device(device))
    fence(x + 1)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()  # repolint: disable=determinism -- measures real per-dispatch wall overhead (the solver's T_sync input); a virtual clock would measure nothing
        fence(x + 1)
        ts.append(time.perf_counter() - t0)  # repolint: disable=determinism -- second half of the same real-wall-time measurement
    ts.sort()
    return ts[len(ts) // 2] * 1e6
