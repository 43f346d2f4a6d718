"""The program's device spans in the traced stretch of a ``--trace 1``
run, for the ``device_us.*`` metrics.

While a profiler session runs, the program times a stage on the card by
two CUDA events on its stream, one before the stage's first queued work
and one after its last, and at the session's stop logs the stage as the
span ``<stage>@device`` beside its host spans, on the same host clock
(``program_spans.recorded``). A device span's duration is the card's
own, so it is read without laying the spans onto the trace. Nothing is
read (``None``) for another configuration, off the card, where the log
holds no such span or dropped some, or where the stage's spans do not
pair one to one with the configuration's entry spans (a program that
records no device spans).
"""

from __future__ import annotations

from benchmarks import program_spans

SUFFIX = "@device"  # the program's suffix of a device span's name


def device_us(run, config: str, entry: str, stage: str):
    """Mean duration (us) of the stretch's ``<stage>@device`` spans of
    ``config``'s requests, each of which opens one ``entry`` span."""
    trace = run.trace
    if run.cfg["name"] != config or trace is None or not trace.ops:
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    name = stage + SUFFIX
    durations = [(t1 - t0) / 1e3 for n, t0, t1, _ in spans if n == name]
    entries = sum(n == entry for n, _, _, _ in spans)
    if not durations or len(durations) != entries:
        return None
    return program_spans.mean(durations)
