"""decode_occupancy (scheduler): decode tokens the batcher produced in the
window over the lane-steps its decode windows ran (dispatches x steps a
window x lanes), in percent, from its stats() across the window."""


def read(run):
    s0, s1 = run.window.stats_open, run.window.stats_close
    steps = (s1["decode_dispatches"] - s0["decode_dispatches"]) \
        * run.window_steps * run.lanes
    if steps <= 0:
        return None
    return 100.0 * (s1["decode_steps"] - s0["decode_steps"]) / steps
