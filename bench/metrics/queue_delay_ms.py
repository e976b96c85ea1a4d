"""queue_delay_ms (ingress): the mean of admit minus send, in
milliseconds, over the requests the server admitted in the window, from
its Telemetry stamps."""


def read(run):
    a, b = run.span_window
    delays = [(r.admit - r.enqueue) * 1e3 for r in run.window.served
              if r.admit is not None and a <= r.admit < b]
    return sum(delays) / len(delays) if delays else None
