"""The card's idle share over the traced stretch: 100 (1 - the union of
its kernel, copy and memset intervals over the stretch's length)."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100 * (1 - trace.busy_s / trace.window_s)
