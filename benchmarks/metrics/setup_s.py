"""Seconds from the process's start to the window's first request:
imports, the kernels' build or load, the inputs, the warm-up."""


def read(run):
    return run.setup_s
