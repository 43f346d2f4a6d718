"""The traced stretch of a ``--trace 1`` run: torch.profiler over a short
stretch of requests after the window, as the process's only profiler
session (kernel events have been seen to drop out of a session opened
long after a process's first one; a stretch with none is taken again).

Only the card's activity is traced (CUPTI: kernels, copies and the CUDA
runtime calls). Tracing the host's operators too made the host the
bottleneck: on the H100 it raised a north-star request's host time from
101 to 158 us and the card's idle share from 6 to 46 %. The harness's own
spans (launch, wait) are kept on the host clock and laid onto the
trace's clock by the one ``cudaEventSynchronize`` that each wait makes.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
from collections import defaultdict

# the device's own activity in a chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime call inside each of the harness's "wait" spans
WAIT_CALL = "cudaEventSynchronize"
TOP = 10


def _union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _align(events, spans) -> list:
    """The harness's spans ``(name, start ns, end ns)`` on the trace's
    clock, in microseconds, sorted by start; [] where the trace's wait
    calls do not pair one to one with the spans' waits."""
    calls = sorted(float(e["ts"]) for e in events
                   if e.get("ph") == "X" and e.get("name") == WAIT_CALL)
    waits = [t0 for name, t0, _ in spans if name == "wait"]
    if not calls or len(calls) != len(waits):
        return []
    shift = statistics.median(c - w / 1e3 for c, w in zip(calls, waits))
    return sorted((t0 / 1e3 + shift, t1 / 1e3 + shift, name)
                  for name, t0, t1 in spans)


class Trace:
    """A stretch's device operations (chrome-trace microseconds), the
    harness spans laid onto them, and the requests it completed."""

    def __init__(self, events, requests: int, spans):
        self.requests = requests
        self.spans = _align(events, spans)
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["cat"], e.get("name", "")) for e in events
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        if self.spans:  # from the first issue to the last wait's end
            self.t0 = self.spans[0][0]
            self.t1 = max(t for _, t, _ in self.spans)
        else:
            self.t0 = ops[0][0] if ops else 0.0
            self.t1 = max((t for _, t, _, _ in ops), default=0.0)
        self.ops = [(max(s, self.t0), min(t, self.t1), cat, name)
                    for s, t, cat, name in ops
                    if min(t, self.t1) > max(s, self.t0)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return _union((s, t) for s, t, _, _ in self.ops) / 1e6

    def kernel_s(self) -> float:
        return sum(t - s for s, t, cat, _ in self.ops if cat == "kernel") / 1e6

    def roofline_pct(self, bound_ms: float):
        """A request's least time ``bound_ms`` over the device time of the
        kernels the stretch's requests launched, in percent; None where
        the trace holds no kernel."""
        kernel_ms = 1e3 * self.kernel_s() / self.requests \
            if self.requests else 0.0
        return 100 * bound_ms / kernel_ms if kernel_ms > 0 else None

    def device_ops(self) -> list:
        """The ``TOP`` device operations by total time: [name, seconds]."""
        by = defaultdict(float)
        for s, t, _, name in self.ops:
            by[name] += (t - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:TOP]]

    def idle_gaps(self) -> list:
        """The device's idle time split by the harness span that was open
        on the host during it: "harness" where none was (the loop's own
        work between requests), "unaligned" where the spans could not be
        laid onto the trace. [span, seconds], largest first."""
        gaps, end = [], self.t0
        for s, t, _, _ in self.ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if self.t1 > end:
            gaps.append((end, self.t1))
        ends = [t for _, t, _ in self.spans]
        by = defaultdict(float)
        for s, t in gaps:
            rest = t - s
            k = bisect.bisect_right(ends, s)
            while k < len(self.spans) and self.spans[k][0] < t:
                a, b, name = self.spans[k]
                overlap = min(b, t) - max(a, s)
                by[name] += overlap / 1e6
                rest -= overlap
                k += 1
            by["harness" if self.spans else "unaligned"] += rest / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:TOP] if v > 0]


def profile(stretch, cuda: bool, attempts: int = 3) -> Trace:
    """Trace ``stretch()``, which returns (requests completed, its span
    log). A stretch whose trace holds no device operation on a card is
    taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    for _ in range(attempts):
        with torch_profile(activities=[activity]) as prof:
            requests, spans = stretch()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        trace = Trace(events, requests, spans)
        if trace.ops or not cuda:
            return trace
    return trace
