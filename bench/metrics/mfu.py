"""mfu (model step): the model FLOPs of the work streamed in the measured
part of the window (work/counts.py, at each token's true position) over
that part's seconds times the card's bf16 peak, in percent."""


def read(run):
    a, b = run.span_window
    if b <= a:
        return None
    return 100.0 * run.flops_between(a, b) / ((b - a)
                                               * run.peaks["bf16_flop_s"])
