"""Seconds from the process's start to the window's start: imports, the
weight draw, registering the plan (its kernels built or loaded and every
bucket prepared), one call per bucket and the gateway's warm-up."""


def read(run):
    return run.setup_s
