"""The program's own spans in the traced stretch of a ``--trace 1`` run,
laid onto the trace's clock, for the metrics that read them.

The program records its spans (``zignal_tpu_torch.profiling.RECORDER``:
the entry, the wrapper's stages, the launch) on the host clock while a
profiler session runs, and starts a fresh log with each session, so the
log holds the stretch's spans alone. Each of the harness's ``launch``
spans encloses one call of the cell's entry, on the same clock: the two
pair in order, and the shift that puts every entry span inside its
``launch`` span, as ``trace.py`` laid it, lays every program span onto
the trace. Nothing is laid (``None``) where the program records no spans
(a program without the recorder, or with a log that dropped spans), where
the trace could not be aligned (a CPU run), or where the spans do not
pair.
"""

from __future__ import annotations

# the entry of each configuration's requests, as the program names its span
ENTRY = {"filter_fusion": "filter_chain", "north_star": "resize_blur_oklab"}


def recorded():
    """The program's span log, ``(name, start ns, end ns, thread)``; None
    where the program keeps none or dropped some."""
    try:
        from zignal_tpu_torch.profiling import RECORDER

        spans, dropped = list(RECORDER.spans), RECORDER.dropped
    except (ImportError, AttributeError, TypeError):
        return None
    return spans if spans and not dropped else None


class Laid:
    """The program's spans on the trace's clock: ``spans`` as (start us,
    end us, name), sorted, and ``entries``, the entry spans among them."""

    def __init__(self, spans, entry: str):
        self.spans = spans
        self.entries = [(s, t) for s, t, name in spans if name == entry]

    def inside_entries(self, names) -> list:
        """Durations (us) of the spans named in ``names`` that lie inside
        an entry span."""
        out, k = [], 0
        for s, t, name in self.spans:
            while k < len(self.entries) and self.entries[k][1] < s:
                k += 1
            if (name in names and k < len(self.entries)
                    and self.entries[k][0] <= s and t <= self.entries[k][1]):
                out.append(t - s)
        return out


def lay(run, config: str):
    """The program's spans of ``run``'s traced stretch, laid (``Laid``);
    None for another configuration than ``config`` or where nothing can
    be laid. Never raises."""
    trace = run.trace
    if run.cfg["name"] != config or trace is None or not trace.spans:
        return None
    spans = recorded()
    if spans is None:
        return None
    entry = ENTRY[config]
    entries = sorted((t0, t1) for name, t0, t1, _ in spans if name == entry)
    launches = [(s, t) for s, t, name in trace.spans if name == "launch"]
    if not entries or len(entries) != len(launches):
        return None
    lo = max(s - t0 / 1e3 for (s, _), (t0, _) in zip(launches, entries))
    hi = min(t - t1 / 1e3 for (_, t), (_, t1) in zip(launches, entries))
    if lo > hi:
        return None
    shift = (lo + hi) / 2
    return Laid(sorted((t0 / 1e3 + shift, t1 / 1e3 + shift, name)
                       for name, t0, t1, _ in spans), entry)


def mean(values):
    return sum(values) / len(values) if values else None


def idle_under_spans_pct(run, laid: Laid):
    """100 x the card's idle time in the stretch that lies under an open
    program span, over the stretch's length."""
    trace = run.trace
    if laid is None or trace.window_s <= 0 or not trace.ops:
        return None
    gaps, end = [], trace.t0
    for s, t, _, _ in trace.ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if trace.t1 > end:
        gaps.append((end, trace.t1))
    covered, k = [], 0  # the union of the program's spans
    for s, t, _ in laid.spans:
        if covered and s <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], t)
        else:
            covered.append([s, t])
    idle = 0.0
    for s, t in gaps:
        while k < len(covered) and covered[k][1] <= s:
            k += 1
        j = k
        while j < len(covered) and covered[j][0] < t:
            idle += min(t, covered[j][1]) - max(s, covered[j][0])
            j += 1
    return 100 * idle / 1e6 / trace.window_s
