"""device_idle_share (device): the share of the profiled sub-window in
which no kernel, copy or fill ran on the card, in percent
(torch.profiler's CUPTI trace)."""


def read(run):
    if run.device is None:
        return None
    return 100.0 * run.device["idle_share"]
