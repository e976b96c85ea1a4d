"""setup_s: seconds from the process's start to the window's opening
(kernels loaded, weights made, every shape captured, the loop filled)."""


def read(run):
    return run.setup_s
