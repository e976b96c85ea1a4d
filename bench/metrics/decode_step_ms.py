"""decode_step_ms (captured windows): fenced fused_window time per decode
step, from the tracer's fused_window spans."""


def read(run):
    spans = run.spans_named("fused_window")
    steps = sum(s.args["n_steps"] for s in spans)
    return sum(s.seconds for s in spans) * 1e3 / steps if steps else None
