"""tpot_p95_ms: the 95th percentile, over every request that finished in
the window, of (last token - first token) / (tokens - 1)."""
from benchkit.loop import percentile, tpots_ms


def read(run):
    return percentile(tpots_ms(run.window), 95)
