"""decode_roofline (kernels of the decode step): the least time the card's
memory needs for the decode windows of the measured part of the window
(each step reads every weight once, each active lane its cache at its true
length once, and writes each new position once; work/counts.py) over
their fenced time, in percent.

A tick's tokens stream inside its tick span, after its decode window:
those are the window's tokens. Counted for dense models only: a mixture of
experts' step reads the experts its tokens route to, which no span
reports."""


def read(run):
    if run.config.get("num_experts"):
        return None
    sh = run.shape
    windows = run.spans_named("fused_window")
    ticks = run.spans_named("tick")
    seconds = nbytes = 0.0
    for w in windows:
        tick = next((t for t in ticks if t.start <= w.start and w.end <= t.end),
                    None)
        if tick is None:
            continue
        seconds += w.seconds
        nbytes += w.args["n_steps"] * sh.weight_bytes_step(run.lanes)
        nbytes += sum(sh.decode_token_bytes(r.prompt_len + j - 1)
                      for r, j in run.decode_tokens(w.end, tick.end))
    if not seconds:
        return None
    return 100.0 * nbytes / (seconds * run.peaks["hbm_byte_s"])
