"""prefill_ms_per_ktok (captured calls): fenced prefill-chunk dispatch
time per thousand prompt tokens, from the tracer's prefill_chunk spans."""


def read(run):
    spans = run.spans_named("prefill_chunk")
    tokens = sum(s.args["chunk"] for s in spans)
    if not tokens:
        return None
    return sum(s.seconds for s in spans) * 1e3 / tokens * 1e3
