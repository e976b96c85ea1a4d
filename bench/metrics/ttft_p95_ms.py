"""ttft_p95_ms: the 95th percentile, over every request whose first token
came in the window, of first token minus send time."""
from benchkit.loop import percentile, ttfts_ms


def read(run):
    return percentile(ttfts_ms(run.window), 95)
