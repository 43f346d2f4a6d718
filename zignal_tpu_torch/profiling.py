"""Profiling on torch: the counterpart of zignal_tpu/profiling.py.

- ``Profile``: named-stage wall-time accumulator (host clock). A caller
  timing device work synchronizes inside the stage, as ``cli/common.Timer``
  does, since a CUDA call returns before the card has finished it.
- ``measure``: per-call seconds (and GPix/s when ``pixels`` is given) of
  an op. It differences two chain lengths so that the first call's
  build and warm-up and each chain's fixed cost cancel. A chain whose
  output lies on a card is timed by CUDA events on the current stream,
  one on the CPU by the host clock.
- ``trace``: context manager around ``torch.profiler.profile``. It writes
  a ``*.pt.trace.json`` that TensorBoard and Perfetto open, with the
  card's kernels whenever a card is present, and the program's own spans.
- ``RECORDER``: the program's own spans, a ``Profile`` with its span log
  on. The pipeline entries (``filter_chain``, ``resize_blur_oklab``), the
  K1 and K2 wrappers' stages (``K1.check``, ``K1.plan``, ``K1.plan_build``
  on a plan cache miss, ``K1.alloc``, ``K1.params``; the same for ``K2``)
  and every kernel ``launch`` add theirs, but only while a torch.profiler
  session runs: each starts its clock with ``span_start()``, which tests
  torch's own flag for one and gives 0 without, and stamps a stage with
  ``t0 = t0 and RECORDER.add(name, t0)``, which then runs no further code
  of the recorder. Each session starts a fresh log.
- Device spans: a stage's time on the card, from a timing CUDA event
  recorded on the current stream before its first queued work
  (``RECORDER.mark``) to one after its last (``RECORDER.add_device``),
  its boundaries shared as the host stamps share theirs: ``d0 = t0 and
  RECORDER.mark(x)``, then ``d1 = d0 and RECORDER.add_device(name, d0,
  x)``. Neither waits for the card nor reads an event while the session
  records. At the session's stop one anchor on each marked card (an
  event recorded once the card is idle, the host clock read beside it)
  puts every mark on the host clock, and each device span joins the log
  as ``<name>@device``. ORB's four stages and ``match``, ``canny`` on a
  card, and ``hough`` add theirs.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# bound once: each lookup would cost the recording path again
_get_ident, _perf_counter_ns = threading.get_ident, time.perf_counter_ns

__all__ = ["Profile", "measure", "trace"]

DEVICE_SPAN = "@device"  # the suffix of a device span's name in the log
# a device span's track in a trace: the recording thread's id plus this
# (thread ids stay below 2^22)
_DEVICE_TRACK = 1 << 30


class Profile:
    """Accumulates per-stage elapsed seconds (reference: sixel.zig:59).
    With ``log_spans()`` it also keeps the spans given to ``add``."""

    # (name, start ns, end ns, thread ident) on time.perf_counter_ns, once
    # log_spans() has started the log
    spans: list | None = None
    # the session's device spans until its stop: (name, start event, end
    # event, thread ident, device)
    device: list | None = None
    limit = 1 << 16  # spans a log keeps; the rest are counted as dropped

    def __init__(self):
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def log_spans(self) -> None:
        """Start a fresh span log that keeps at most ``limit`` spans, host
        and device together, and counts the later ones in ``dropped``;
        ``unix_offset_ns`` takes a span's clock to ``time.time_ns()``'s."""
        with self._lock:
            self.dropped, self.spans, self.device = 0, [], []
            self.unix_offset_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, t0_ns: int, t1_ns: int | None = None) -> int:
        """Log the span ``name`` from ``t0_ns`` to ``t1_ns`` (now when
        None) on ``time.perf_counter_ns``, once ``log_spans()`` has started
        the log, and return its end, where a next stage starts. Safe from any thread: an append is atomic, and
        a log past its limit gives the span back under the lock."""
        if t1_ns is None:
            t1_ns = _perf_counter_ns()
        spans = self.spans
        spans.append((name, t0_ns, t1_ns, _get_ident()))
        if len(spans) > self.limit:
            self._drop(spans)
        return t1_ns

    def mark(self, x):
        """A timing CUDA event recorded now on the current stream of the
        card that holds the tensor ``x``: the boundary of a device span.
        None for a tensor off a card. Call it only while a session runs
        (after a non-zero ``span_start()``)."""
        if x.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(x.device))
        return event

    def add_device(self, name: str, start, x):
        """Keep the device span ``name`` from the mark ``start`` to a new
        mark on the card of ``x``, which it returns, where a next stage
        starts. The span joins the log at the session's stop
        (``place_device_spans``); past the log's limit it is dropped."""
        end = self.mark(x)
        device = self.device
        device.append((name, start, end, _get_ident(), x.device))
        if len(self.spans) + len(device) > self.limit:
            self._drop(device)
        return end

    def place_device_spans(self) -> None:
        """Put the session's device spans into the log, on its host clock,
        once the session has stopped: on each marked card, wait for it,
        record one event (the anchor) and read the host clock beside it;
        a mark lies the anchor's elapsed time before that reading. Each
        span joins the log as ``(<name>@device, start ns, end ns,
        thread)`` while the log has room, and counts as dropped after."""
        with self._lock:
            device, self.device = self.device, []
        if not device:
            return
        anchors = {}
        for dev in {span[4] for span in device}:
            torch.cuda.synchronize(dev)
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(torch.cuda.current_stream(dev))
            anchors[dev] = (anchor, _perf_counter_ns())
            anchor.synchronize()
        placed = []
        for name, start, end, ident, dev in device:
            anchor, host_ns = anchors[dev]
            placed.append((name + DEVICE_SPAN,
                           host_ns - round(start.elapsed_time(anchor) * 1e6),
                           host_ns - round(end.elapsed_time(anchor) * 1e6),
                           ident))
        with self._lock:
            room = max(0, self.limit - len(self.spans))
            self.spans += placed[:room]
            self.dropped += len(placed[room:])

    def _drop(self, log: list) -> None:
        with self._lock:
            if log is self.spans and len(log) > self.limit \
                    or log is self.device \
                    and len(self.spans) + len(log) > self.limit:
                log.pop()
                self.dropped += 1

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> str:
        total = self.total or 1.0
        lines = [
            f"{name:<20} {secs * 1000:8.2f} ms  {secs / total * 100:5.1f}%"
            f"  (x{self.counts[name]})"
            for name, secs in sorted(self.stages.items(),
                                     key=lambda kv: -kv[1])
        ]
        lines.append(f"{'total':<20} {self.total * 1000:8.2f} ms")
        return "\n".join(lines)


def _host_chain(fn, args, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)  # a CPU op has finished when it returns
    return time.perf_counter() - t0


def _event_chain(fn, args, n: int, device: torch.device) -> float:
    """Seconds of ``n`` calls between two CUDA events on ``device``'s
    current stream, read once the last call has finished; the stream's
    order serializes the launches."""
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(n):
        fn(*args)
    stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def measure(fn, *args, pixels: int | None = None, n_small: int = 2,
            n_large: int = 12):
    """Per-call seconds (and GPix/s if ``pixels`` given) of ``fn(*args)``.

    One warm-up call, then chains of ``n_small`` and ``n_large`` calls,
    the fastest of ``2 + attempt`` chains of each, differenced. The
    clock is that of the device ``fn``'s output lies on: CUDA events for a
    card, the host clock for the CPU."""
    device = torch.device(fn(*args).device)  # the warm-up chain of 1
    if device.type == "cuda":
        def chain(n):
            return _event_chain(fn, args, n, device)
    elif device.type == "cpu":
        def chain(n):
            return _host_chain(fn, args, n)
    else:
        raise ValueError(f"measure times CPU and CUDA outputs, not {device}")
    # On a loaded host the noise can exceed the differenced signal and
    # the estimate goes negative; retry with more repetitions, then fall
    # back to the (positive, pessimistic) undifferenced upper bound.
    per_call = -1.0
    for attempt in range(3):
        reps = 2 + attempt
        t_small = min(chain(n_small) for _ in range(reps))
        t_large = min(chain(n_large) for _ in range(reps))
        per_call = (t_large - t_small) / (n_large - n_small)
        if per_call > 0:
            break
    if per_call <= 0:
        per_call = t_large / n_large
    if pixels is None:
        return per_call
    return per_call, pixels / per_call / 1e9


RECORDER = Profile()
RECORDER.log_spans()


def span_start() -> int:
    """Where the recorder's next span starts: now on
    ``time.perf_counter_ns`` while a torch.profiler session runs, else 0.
    ``t0 = t0 and RECORDER.add(name, t0)`` then stamps the stage ``name``
    and starts the next one, or does nothing on 0."""
    return _perf_counter_ns() if _autograd_profiler._is_profiler_enabled \
        else 0


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    """torch's hook at the start of every profiler session, whatever its
    activities, and then a fresh log for the recorder."""
    start()
    RECORDER.log_spans()


def _on_profiler_stop(stop=_autograd_profiler._run_on_profiler_stop):
    """torch's hook at the stop of every profiler session, and then the
    session's device spans into the recorder's log."""
    stop()
    RECORDER.place_device_spans()


_autograd_profiler._run_on_profiler_start = _on_profiler_start
_autograd_profiler._run_on_profiler_stop = _on_profiler_stop


def _program_events(log: Profile, base_ns: int) -> list:
    """``log``'s spans as chrome-trace complete events on a trace's clock:
    microseconds since ``base_ns`` on ``time.time_ns()``'s. A thread's
    device spans lie on a track of their own, beside its host spans."""
    native = {t.ident: t.native_id for t in threading.enumerate()}
    pid, shift = os.getpid(), log.unix_offset_ns - base_ns
    events, tracks = [], {}
    for name, t0, t1, ident in list(log.spans):
        tid = native.get(ident, ident)
        if name.endswith(DEVICE_SPAN):
            tid = tracks.setdefault(tid, _DEVICE_TRACK + tid)
        events.append({"ph": "X", "cat": "zignal", "name": name, "pid": pid,
                       "tid": tid, "ts": (t0 + shift) / 1e3,
                       "dur": (t1 - t0) / 1e3})
    return events + [{"ph": "M", "name": "thread_name", "pid": pid,
                      "tid": track,
                      "args": {"name": f"device spans of thread {tid}"}}
                     for tid, track in tracks.items()]


def _write_trace(log_dir: str, prof) -> None:
    """The session's trace into ``log_dir`` under the name
    ``tensorboard_trace_handler`` gives it, the recorder's spans added."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"] += _program_events(
        RECORDER, int(data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the body into ``log_dir`` (a
    ``*.pt.trace.json`` for TensorBoard and Perfetto): CPU activity, the
    card's kernels and copies whenever CUDA is available, and the
    program's own spans (``RECORDER``) as complete events of category
    ``zignal``. The file is written when the body raises too."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=lambda prof: _write_trace(str(log_dir),
                                                          prof)):
        yield
        if cuda:
            torch.cuda.synchronize()  # the body's kernels end in the trace
