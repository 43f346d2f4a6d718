"""Mean time of the program's ``canny`` span in the traced stretch of the
lane_hough deployment: its own clock from the entry of ``ops.edges.canny``
to its return, the Gaussian, the gradients, the NMS and the hysteresis
queued.

The program's spans are laid onto the trace as ``program_spans.lay``
lays them, with ``canny`` as the entry: one a request, each inside the
harness's ``launch`` span of its request. Nothing is read (``None``) for
another configuration, without the recorder, off the card, or where the
spans do not pair.
"""

from benchmarks.program_spans import Laid, mean, recorded

CONFIG, ENTRY = "lane_hough", "canny"


def lay(run):
    trace = run.trace
    if run.cfg["name"] != CONFIG or trace is None or not trace.spans:
        return None
    spans = recorded()
    if spans is None:
        return None
    entries = sorted((t0, t1) for name, t0, t1, _ in spans if name == ENTRY)
    launches = [(s, t) for s, t, name in trace.spans if name == "launch"]
    if not entries or len(entries) != len(launches):
        return None
    lo = max(s - t0 / 1e3 for (s, _), (t0, _) in zip(launches, entries))
    hi = min(t - t1 / 1e3 for (_, t), (_, t1) in zip(launches, entries))
    if lo > hi:
        return None
    shift = (lo + hi) / 2
    return Laid(sorted((t0 / 1e3 + shift, t1 / 1e3 + shift, name)
                       for name, t0, t1, _ in spans), ENTRY)


def read(run):
    laid = lay(run)
    return None if laid is None else mean([t - s for s, t in laid.entries])
