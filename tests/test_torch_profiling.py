"""The port's profiling (zignal_tpu_torch/profiling.py) against
zignal_tpu.profiling on the CPU.

``Profile`` and ``measure`` read the host clock on the CPU, so both
packages are driven by one virtual clock: ``time.perf_counter`` patched in
each module to read a time that only the clock's own steps move (each
timed call of the op adds its cost, each read a fixed latency). The same
steps must give the same floats, bit for bit. ``trace`` is checked on the
file it writes, and the program's own spans (``RECORDER``) on the CPU
route of the pipeline entries; their CUDA route's stages are checked on
the card in tests/test_torch_kernels.py."""

import inspect
import json
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zignal_tpu.profiling as jprof
import zignal_tpu_torch.profiling as tprof


class VirtualClock:
    """A ``perf_counter`` whose reads each add ``latency`` after they
    return, and whose ``call()`` adds the next of ``costs`` (the last one
    repeats)."""

    def __init__(self, costs, latency=0.0):
        self.now, self.latency = 100.0, latency
        self.costs, self.calls = list(costs), 0

    def __call__(self) -> float:
        t = self.now
        self.now += self.latency
        return t

    def call(self) -> None:
        self.now += self.costs[min(self.calls, len(self.costs) - 1)]
        self.calls += 1


def _both(monkeypatch, drive):
    """``drive(module, clock)`` for each package, each on a fresh clock
    from the same steps; (JAX's result, the port's, the port's clock)."""
    out = []
    for mod in (jprof, tprof):
        clock = drive.clock()
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        out.append(drive(mod, clock))
        monkeypatch.undo()
    return out[0], out[1], clock


def test_profile_equals_jax_under_one_clock(monkeypatch):
    def drive(mod, clock):
        p = mod.Profile()
        for name, cost in (("decode", 0.0123), ("resize", 0.00051),
                           ("decode", 0.0101), ("encode", 0.0044),
                           ("resize", 0.00049)):
            with p.stage(name):
                clock.now += cost
        return p

    drive.clock = lambda: VirtualClock([0.0], latency=1e-6)
    j, t, _ = _both(monkeypatch, drive)
    assert t.stages == j.stages and t.counts == j.counts
    assert t.total == j.total
    assert t.report() == j.report()
    assert t.report().splitlines()[0].startswith("decode")
    assert t.counts == {"decode": 2, "resize": 2, "encode": 1}


def test_profile_counts_a_stage_that_raises():
    p = tprof.Profile()
    with pytest.raises(KeyError):
        with p.stage("a"):
            raise KeyError("a")
    assert p.counts == {"a": 1} and p.stages["a"] >= 0.0


# the virtual costs of each timed call. JAX's chain and the port's call the
# op 1 + sum over attempts of reps * (n_small + n_large) times in the same
# order, so the k-th call costs the same in both; JAX also reads the clock
# around its warm-up call. Costs and latency are powers of two, so every
# sum and difference of clock readings is exact and the two agree to the
# bit.
_MS, _US = 2.0 ** -10, 2.0 ** -20  # ~0.98 ms, ~0.95 us
_ATTEMPT0 = 2 * (2 + 12)  # calls of the first attempt (reps 2)
MEASURE_CASES = {
    # a call costs _MS / 4, a clock read 4 _US: the reads cancel
    "differenced": ([_MS / 4], 4 * _US, _MS / 4),
    # the first attempt sees no signal (every call free), the second does
    "retried": ([0.0] * (1 + _ATTEMPT0) + [_MS], 4 * _US, _MS),
    # no attempt sees a signal: t_large / n_large, one read's latency / 12
    "fallback": ([0.0], 4 * _US, 4 * _US / 12),
}


@pytest.mark.parametrize("case", sorted(MEASURE_CASES))
def test_measure_equals_jax_under_one_clock(monkeypatch, case):
    costs, latency, want = MEASURE_CASES[case]
    args = {jprof: jnp.asarray(np.ones(4, np.float32)),
            tprof: torch.ones(4)}

    def drive(mod, clock):
        def op(x):
            clock.call()
            return x

        return mod.measure(op, args[mod], pixels=1000)

    drive.clock = lambda: VirtualClock(costs, latency)
    (jsecs, jgpix), (tsecs, tgpix), clock = _both(monkeypatch, drive)
    assert tsecs == jsecs and tgpix == jgpix
    assert tsecs == pytest.approx(want, rel=1e-9)
    attempts = {"differenced": 1, "retried": 2, "fallback": 3}[case]
    assert clock.calls == 1 + sum((2 + a) * 14 for a in range(attempts))


def test_measure_runs_on_a_cpu_tensor():
    """tests/test_io_pipeline.py's measure test on the port's CPU path."""
    x = torch.ones((64, 64))
    secs, gpix = tprof.measure(lambda t: t * 2.0, x, pixels=64 * 64,
                               n_small=1, n_large=4)
    assert secs > 0 and gpix > 0
    assert gpix == 64 * 64 / secs / 1e9
    bare = tprof.measure(lambda t: t * 2.0, x, n_small=1, n_large=4)
    assert isinstance(bare, float) and bare > 0


def test_measure_refuses_a_device_it_cannot_time():
    with pytest.raises(ValueError, match="meta"):
        tprof.measure(lambda: torch.empty(4, device="meta"))


def _events(log_dir):
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_the_ops_of_the_body(tmp_path):
    a = torch.ones((32, 32))
    with tprof.trace(tmp_path):
        b = a @ a
    assert float(b[0, 0]) == 32.0
    names = {e.get("name", "") for e in _events(tmp_path)}
    assert {"aten::matmul", "aten::mm"} <= names


def test_trace_is_written_when_the_body_raises(tmp_path):
    a = torch.ones((8, 8))
    with pytest.raises(KeyError, match="boom"):
        with tprof.trace(tmp_path / "run"):
            a.cumsum(0)
            raise KeyError("boom")
    names = {e.get("name", "") for e in _events(tmp_path / "run")}
    assert "aten::cumsum" in names


def test_signatures_equal_jax():
    for name in jprof.__all__:
        assert str(inspect.signature(getattr(tprof, name))) == \
            str(inspect.signature(getattr(jprof, name)))
    assert tprof.__all__ == jprof.__all__


# --- the program's own spans: profiling.RECORDER ---------------------------

def _session():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _plane(shape=(2, 48, 40)):
    return torch.randint(0, 256, shape, dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))


def test_no_span_is_recorded_outside_a_profiler_session():
    from zignal_tpu_torch import pipeline

    log = tprof.RECORDER.spans
    before = list(log)
    pipeline.filter_chain(_plane())
    pipeline.resize_blur_oklab(_plane((1, 32, 32, 3)), 16, 16)
    assert tprof.RECORDER.spans is log and log == before


def test_each_entry_call_records_one_span_and_a_session_starts_fresh():
    from zignal_tpu_torch import pipeline

    with _session():
        for _ in range(3):
            pipeline.filter_chain(_plane())
        for _ in range(2):
            pipeline.resize_blur_oklab(_plane((1, 32, 32, 3)), 16, 16)
    first = tprof.RECORDER.spans
    # the CPU route has no wrapper stages or launch: the entries alone
    assert [s[0] for s in first] == ["filter_chain"] * 3 + \
        ["resize_blur_oklab"] * 2
    assert all(t0 < t1 for _, t0, t1, _ in first)
    assert {s[3] for s in first} == {threading.get_ident()}
    with _session():
        pipeline.filter_chain(_plane())
    assert [s[0] for s in tprof.RECORDER.spans] == ["filter_chain"]
    assert tprof.RECORDER.dropped == 0 and first is not tprof.RECORDER.spans


def test_colorspace_spans_only_in_a_session():
    """The photo-ingestion request, ``equalize`` then
    ``color_chain_values``: outside a session it records nothing; inside
    one, the equalize entry with its two stages one after the other, and
    the values entry (the CPU route has no K3 stages or launch), and
    ``color_chain.VALUES`` counts no launch on the CPU."""
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import color_chain, enhancement

    x = _plane((2, 24, 32, 3))
    log, before = tprof.RECORDER.spans, list(tprof.RECORDER.spans)
    values = color_chain.VALUES
    pipeline.color_chain_values(enhancement.equalize(x), ("rgb", "lab"))
    assert tprof.RECORDER.spans is log and log == before
    with _session():
        for _ in range(2):
            pipeline.color_chain_values(enhancement.equalize(x),
                                        ("rgb", "lab"))
    spans = tprof.RECORDER.spans
    assert [s[0] for s in spans] == ["equalize.hist", "equalize.lut",
                                     "equalize", "color_chain_values"] * 2
    for call in (spans[:4], spans[4:]):
        by = {name: (t0, t1) for name, t0, t1, _ in call}
        hist, lut, entry = by["equalize.hist"], by["equalize.lut"], \
            by["equalize"]
        assert entry[0] == hist[0] and hist[1] == lut[0] \
            and lut[1] == entry[1]
        assert entry[1] <= by["color_chain_values"][0]
    assert color_chain.VALUES == values


def test_orb_and_match_spans_only_in_a_session():
    """The stereo request, ``detect_and_compute_tensors`` then
    ``match_tensors``: outside a session it records nothing; inside one,
    the four ORB stages one after the other inside the ``orb`` entry
    (the CPU route has no kernel launch), then ``match``; and the
    counters count no level and no pair on the CPU."""
    from zignal_tpu_torch.features import Orb, matcher, orb

    x = _plane((2, 40, 56))
    o = Orb(n_features=60, n_levels=3)

    def request():
        kps, desc, valid = o.detect_and_compute_tensors(x)
        matcher.match_tensors(desc[:1], valid[:1], desc[1:], valid[1:])

    log, before = tprof.RECORDER.spans, list(tprof.RECORDER.spans)
    levels, pairs = orb.LEVELS, matcher.PAIRS
    request()
    assert tprof.RECORDER.spans is log and log == before
    with _session():
        for _ in range(2):
            request()
    spans = tprof.RECORDER.spans
    stages = ["orb.pyramid", "orb.detect", "orb.select", "orb.describe"]
    assert [s[0] for s in spans] == (stages + ["orb", "match"]) * 2
    for call in (spans[:6], spans[6:]):
        by = {name: (t0, t1) for name, t0, t1, _ in call}
        assert by["orb"][0] == by[stages[0]][0]
        assert by["orb"][1] == by[stages[-1]][1]
        assert all(by[a][1] == by[b][0] for a, b in zip(stages, stages[1:]))
        assert by["orb"][1] <= by["match"][0] < by["match"][1]
    assert (orb.LEVELS, matcher.PAIRS) == (levels, pairs)


def _road_edges(shape=(2, 60, 90)):
    """Edge-like u8 frames: a bright bar with a fading tail on grain, so
    that the hysteresis grows over several tests."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(60, 68, shape, generator=g).to(torch.float32)
    x[:, 20:24, 5:80] += torch.linspace(150, 40, 75)
    return x


def test_canny_and_hough_spans_only_in_a_session():
    """The lane request, ``canny`` then ``HoughTransform.lines_batch``:
    outside a session it records nothing; inside one, the four Canny
    stages one after the other inside ``canny``, one ``canny.test`` for
    each convergence test inside ``canny.hysteresis`` (the CPU route
    grows to the fixpoint), then ``hough`` around its three stages; and
    the counters count no test and no frame on the CPU."""
    from zignal_tpu_torch.ops import edges, hough

    x = _road_edges()
    ht = hough.HoughTransform(64)

    def request():
        ht.lines_batch(edges.canny(x), 5, max_lines=4)

    log, before = tprof.RECORDER.spans, list(tprof.RECORDER.spans)
    tests, frames = edges.HYSTERESIS_TESTS, hough.FRAMES
    request()
    assert tprof.RECORDER.spans is log and log == before
    with _session():
        for _ in range(2):
            request()
    spans = tprof.RECORDER.spans
    names = [s[0] for s in spans]
    assert names.count("canny") == names.count("hough") == 2
    stages = ["canny.smooth", "canny.gradients", "canny.nms",
              "canny.hysteresis"]
    half = len(spans) // 2
    for call in (spans[:half], spans[half:]):
        n_tests = [s[0] for s in call].count("canny.test")
        assert n_tests >= 2
        assert [s[0] for s in call] == stages[:3] + ["canny.test"] * n_tests \
            + stages[3:] + ["canny", "hough.resize", "hough.vote",
                            "hough.peaks", "hough"]
        by = {name: (t0, t1) for name, t0, t1, _ in call}
        assert by["canny"][0] == by[stages[0]][0]
        assert by["canny"][1] == by[stages[-1]][1]
        assert all(by[a][1] == by[b][0] for a, b in zip(stages, stages[1:]))
        for name, t0, t1, _ in call:
            if name == "canny.test":
                assert by["canny.hysteresis"][0] <= t0 < t1 <= \
                    by["canny.hysteresis"][1]
        assert by["canny"][1] <= by["hough"][0]
        assert by["hough"][0] <= by["hough.resize"][0]
        assert by["hough.resize"][1] == by["hough.vote"][0]
        assert by["hough.vote"][1] <= by["hough.peaks"][0]
        assert by["hough.peaks"][1] <= by["hough"][1]
    assert (edges.HYSTERESIS_TESTS, hough.FRAMES) == (tests, frames)


def test_span_log_bound_counts_what_it_drops():
    p = tprof.Profile()
    assert p.spans is None and tprof.RECORDER.limit == 1 << 16
    p.limit = 4
    p.log_spans()
    for k in range(10):
        assert p.add(f"s{k}", 100 * k, 100 * k + 5) == 100 * k + 5
    assert [s[0] for s in p.spans] == ["s0", "s1", "s2", "s3"]
    assert p.dropped == 6
    p.log_spans()
    assert p.spans == [] and p.dropped == 0


def test_spans_from_eight_threads_are_all_kept():
    p = tprof.Profile()
    p.log_spans()
    n, per = 8, 3000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                t0 = time.perf_counter_ns()
                p.add(f"t{k}", t0)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(p.spans) == n * per and p.dropped == 0
    assert {s[3] for s in p.spans} == {t.ident for t in threads}
    assert all(sum(s[0] == f"t{k}" for s in p.spans) == per
               for k in range(n))


def test_trace_holds_the_programs_spans_on_its_clock(tmp_path):
    from zignal_tpu_torch import pipeline

    x = _plane((4, 256, 256))
    with tprof.trace(tmp_path):
        pipeline.filter_chain(x)
    events = _events(tmp_path)
    (span,) = [e for e in events if e.get("cat") == "zignal"]
    assert span["ph"] == "X" and span["name"] == "filter_chain"
    assert span["dur"] > 0
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::")]
    assert ops and {e["tid"] for e in ops} == {span["tid"]}
    # every operator of the call lies inside the call's span, on the
    # trace's clock (20 us for the two clocks' readings)
    assert span["ts"] - 20 <= min(e["ts"] for e in ops)
    assert max(e["ts"] + e["dur"] for e in ops) <= \
        span["ts"] + span["dur"] + 20


# --- device spans: marks on the stream, placed at the session's stop -------

class _Card:
    """A stand-in for one card and its clock: an event stamps the card's
    time (ns) when it is recorded, and the card's time moves only by
    ``run``. Counts the waits for the card and the events read."""

    def __init__(self, now_ns=7_000_000):
        self.now_ns, self.waits, self.reads, self.streams = now_ns, 0, 0, []
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None

            def record(self, stream):
                card.streams.append(stream)
                self.t = card.now_ns

            def synchronize(self):
                card.waits += 1

            def elapsed_time(self, other):
                card.reads += 1
                return (other.t - self.t) / 1e6

        self.Event = Event

    def run(self, ns):
        self.now_ns += ns

    def install(self, monkeypatch, host_ns):
        """The card in place of torch.cuda's, and ``host_ns`` as the
        recorder's host clock."""
        monkeypatch.setattr(torch.cuda, "Event", self.Event)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device: ("stream", device))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: self._wait())
        monkeypatch.setattr(tprof, "_perf_counter_ns", lambda: host_ns)

    def _wait(self):
        self.waits += 1


def _on_card():
    """A stand-in for a tensor on the first card: the recorder reads its
    device alone."""
    from types import SimpleNamespace

    return SimpleNamespace(device=torch.device("cuda", 0))


def test_no_mark_outside_a_session_and_none_for_cpu_tensors(monkeypatch):
    """Outside a session the instrumented entries never reach the
    recorder's marks; a mark of a CPU tensor is None (the CPU calls in a
    session: the next test)."""
    calls = []
    for name in ("mark", "add_device"):
        monkeypatch.setattr(tprof.RECORDER, name,
                            lambda *a, _n=name: calls.append(_n))
    _stereo_and_lane_requests()
    assert calls == []
    monkeypatch.undo()
    assert tprof.RECORDER.mark(_plane()) is None


def _stereo_and_lane_requests():
    from zignal_tpu_torch.features import Orb, matcher
    from zignal_tpu_torch.ops import edges, hough

    kps, desc, valid = Orb(n_features=60, n_levels=3) \
        .detect_and_compute_tensors(_plane((2, 40, 56)))
    matcher.match_tensors(desc[:1], valid[:1], desc[1:], valid[1:])
    hough.HoughTransform(64).lines_batch(edges.canny(_road_edges()), 5,
                                         max_lines=4)


@pytest.mark.parametrize("entry", ["orb", "match", "canny", "hough"])
def test_a_cpu_call_records_its_host_spans_and_no_device_span(entry):
    """Each instrumented entry on CPU tensors, in a session: its host span
    as before, and no ``@device`` span."""
    from zignal_tpu_torch.features import Orb, matcher
    from zignal_tpu_torch.ops import edges, hough

    x = _plane((2, 40, 56))
    kps, desc, valid = Orb(n_features=60, n_levels=3) \
        .detect_and_compute_tensors(x)
    e = edges.canny(_road_edges())
    call = {"orb": lambda: Orb(n_features=60, n_levels=3)
            .detect_and_compute_tensors(x),
            "match": lambda: matcher.match_tensors(desc[:1], valid[:1],
                                                   desc[1:], valid[1:]),
            "canny": lambda: edges.canny(_road_edges()),
            "hough": lambda: hough.HoughTransform(64).lines_batch(
                e, 5, max_lines=4)}[entry]
    with _session():
        call()
        assert tprof.RECORDER.device == []
    names = [s[0] for s in tprof.RECORDER.spans]
    assert names.count(entry) == 1 and names[-1] == entry
    assert not any(n.endswith(tprof.DEVICE_SPAN) for n in names)


def test_stop_places_device_spans_at_the_anchors_offset(monkeypatch):
    """Three stages on a card, one after the other, then one from another
    thread: nothing waits for the card or reads an event while the
    session records; at its stop one anchor (the card idle, then the host
    clock read beside it) puts each mark the card's time before it, and
    each span joins the log as ``<name>@device`` with its thread."""
    card, host_ns = _Card(), 50_000_000_000
    card.install(monkeypatch, host_ns)
    x = _on_card()
    rec = tprof.RECORDER
    with _session():
        d0 = rec.mark(x)
        card.run(1_000)
        d1 = rec.add_device("a", d0, x)
        card.run(2_500)
        d2 = rec.add_device("b", d1, x)
        card.run(4_000)
        rec.add_device("c", d2, x)
        other = threading.Thread(target=lambda: rec.add_device(
            "d", rec.mark(x), x))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        card.run(3_000)  # queued work that the anchor waits for
        assert (card.waits, card.reads, len(rec.device)) == (0, 0, 4)
        assert rec.spans == []
    assert card.waits >= 1 and rec.device == []
    anchor = card.now_ns
    assert card.streams == [("stream", x.device)] * 7
    placed = {s[0]: s for s in rec.spans}
    # the marks: 7.0, 7.001, 7.0035, 7.0075 ms on the card, the anchor at
    # 7.0105 ms; each at the host's reading less its distance to the anchor
    want = {"a@device": (7_000_000, 7_001_000),
            "b@device": (7_001_000, 7_003_500),
            "c@device": (7_003_500, 7_007_500),
            "d@device": (7_007_500, 7_007_500)}
    assert [s[0] for s in rec.spans] == list(want)
    for name, (s, t) in want.items():
        assert placed[name][1:3] == (host_ns - (anchor - s),
                                     host_ns - (anchor - t))
    assert {placed[f"{n}@device"][3] for n in "abc"} == \
        {threading.get_ident()}
    assert placed["d@device"][3] == other.ident
    assert rec.dropped == 0


def test_the_span_log_bound_counts_the_device_spans_it_drops(monkeypatch):
    card = _Card()
    card.install(monkeypatch, 10_000_000)
    x = _on_card()
    p = tprof.Profile()
    p.limit = 4
    p.log_spans()
    for k in range(3):
        p.add(f"h{k}", 100 * k, 100 * k + 5)
    d = p.mark(x)
    for k in range(3):  # one fits beside the host's three
        d = p.add_device(f"s{k}", d, x)
    assert len(p.device) == 1 and p.dropped == 2
    p.place_device_spans()
    assert [s[0] for s in p.spans] == ["h0", "h1", "h2", "s0@device"]
    # device spans first, then the host's: the log's room is spent before
    # the stop, and the stop counts what it cannot place
    p.log_spans()
    d = p.mark(x)
    for k in range(2):
        d = p.add_device(f"s{k}", d, x)
    for k in range(5):
        p.add(f"h{k}", 100 * k, 100 * k + 5)
    assert p.dropped == 1
    p.place_device_spans()
    assert [s[0] for s in p.spans] == ["h0", "h1", "h2", "h3"]
    assert p.dropped == 3


def test_trace_writes_device_spans_on_their_own_track():
    """``profiling.trace``'s program events: a thread's device spans on a
    track of their own, named, beside its host spans, on the same clock."""
    p = tprof.Profile()
    p.log_spans()
    p.unix_offset_ns = 1_000_000
    me = threading.get_ident()
    p.spans += [("match", 2_000, 9_000, me),
                ("match@device", 5_000, 12_000, me)]
    events = tprof._program_events(p, 0)
    host, device, meta = events
    native = threading.get_native_id()
    assert host["tid"] == native and device["tid"] != native
    assert (host["ts"], host["dur"]) == (1_002.0, 7.0)
    assert (device["ts"], device["dur"]) == (1_005.0, 7.0)
    assert device["cat"] == host["cat"] == "zignal"
    assert meta["ph"] == "M" and meta["tid"] == device["tid"]
    assert meta["name"] == "thread_name" and str(native) in \
        meta["args"]["name"]
