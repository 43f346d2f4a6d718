"""The readers of the program's own spans (``program_spans.py`` and the
metrics on it) on a synthetic stretch whose clocks and answers are known,
and the runs in which they must read nothing."""

import json
from pathlib import Path

import pytest

from benchmarks import program_spans, run
from benchmarks.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
READERS = [m["name"] for m in MANIFEST["per_layer"]
           if m["name"].startswith(("entry_us", "wrapper_us",
                                    "launch_call_us", "idle_program_pct"))]

# two frame-loop requests on the host clock (ns): the harness's spans, and
# inside each launch the program's entry, its four wrapper stages (4, 2, 3
# and 1 us) and its launch (14 us, then 12)
HARNESS = [("launch", 0, 30_000), ("wait", 30_000, 80_000),
           ("launch", 90_000, 120_000), ("wait", 120_000, 170_000)]


def _program(offset, launch_us):
    at = offset + 2_500
    spans = []
    for name, us in (("K2.check", 4), ("K2.plan", 2), ("K2.alloc", 3),
                     ("K2.params", 1), ("launch", launch_us)):
        spans.append((name, at, at + us * 1000, 7))
        at += us * 1000
    return spans + [("filter_chain", offset + 2_000, offset + 28_000, 7)]


PROGRAM = _program(0, 14) + _program(90_000, 12)


def _events():
    """The trace's clock 1000 us ahead of the host's: the wait calls pair
    the two; K2 runs 20-60 us into the first request, 110-150 into the
    second."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
           "ts": 1000 + t0 / 1e3, "dur": 1.0}
          for name, t0, _ in HARNESS if name == "wait"]
    return ev + [{"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                  "dur": 40.0} for ts in (1020.0, 1110.0)]


def _trace():
    return Trace(_events(), 2, HARNESS)


def _read(name, program, config="filter_fusion", trace=None,
          monkeypatch=None):
    monkeypatch.setattr(program_spans, "recorded", lambda: program)
    record = run.Record(cfg={"name": config},
                        trace=_trace() if trace is None else trace)
    return run.load("metrics", name).read(record)


def test_readers_lay_the_program_on_the_trace(monkeypatch):
    def read(name):
        return _read(name, PROGRAM, monkeypatch=monkeypatch)

    assert read("entry_us.filter") == pytest.approx(26.0)
    assert read("wrapper_us.filter") == pytest.approx(10.0)
    assert read("launch_call_us.filter") == pytest.approx(13.0)
    # idle 0-20, 60-110 and 150-170 us of the 170-us stretch; under the
    # entries (2-28, 92-118): 18 + 18 us
    want = 100 * 36 / 170
    assert read("idle_program_pct") == pytest.approx(want)
    assert read("idle_program_pct.frame_loop") == pytest.approx(want)
    assert read("entry_us.resize_blur_oklab") is None  # another config


def test_the_north_star_entry_is_read(monkeypatch):
    renamed = [("resize_blur_oklab" if n == "filter_chain" else
                n.replace("K2", "K1"), *rest) for n, *rest in PROGRAM]
    assert _read("entry_us.resize_blur_oklab", renamed, "north_star",
                 monkeypatch=monkeypatch) == pytest.approx(26.0)
    assert _read("entry_us.filter", renamed, "north_star",
                 monkeypatch=monkeypatch) is None


@pytest.mark.parametrize("case", ["unpaired", "outside", "none", "empty",
                                  "unaligned"])
@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_they_cannot_lay(case, name, monkeypatch):
    program, trace = PROGRAM, None
    if case == "unpaired":  # one request's entry missing
        program = PROGRAM[:-1]
    elif case == "outside":  # an entry longer than its launch span
        program = PROGRAM[:-1] + [("filter_chain", 85_000, 125_000, 7)]
    elif case == "none":  # a program without the recorder
        program = None
    elif case == "empty":
        program = []
    else:  # the trace's wait calls do not pair with the harness's waits
        trace = Trace(_events()[1:], 2, HARNESS)
    config = "north_star" if "resize_blur" in name else "filter_fusion"
    if config == "north_star" and program:
        program = [("resize_blur_oklab" if n == "filter_chain" else n, *r)
                   for n, *r in program]
    assert _read(name, program, config, trace, monkeypatch) is None


def test_recorded_reads_nothing_from_a_program_without_the_recorder(
        monkeypatch):
    from zignal_tpu_torch import profiling

    monkeypatch.delattr(profiling, "RECORDER")
    assert program_spans.recorded() is None


def test_recorded_reads_nothing_from_a_log_that_dropped(monkeypatch):
    from zignal_tpu_torch import profiling

    log = profiling.Profile()
    log.limit = 1
    log.log_spans()
    log.add("filter_chain", 0, 1)
    monkeypatch.setattr(profiling, "RECORDER", log)
    assert [s[:3] for s in program_spans.recorded()] == [
        ("filter_chain", 0, 1)]
    log.add("filter_chain", 2, 3)
    assert log.dropped == 1 and program_spans.recorded() is None


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_traced_run_prints_none_of_the_program_span_metrics(cell,
                                                                capsys):
    """On the CPU the trace has no wait calls to align by: the new readers
    read nothing, raise nothing, and the line holds only metrics the cell
    reports."""
    assert run.main(["--workload", cell, "--seed", str(2 ** 33 + 5),
                     "--seconds", "0.3", "--trace", "1",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    reported = {m["name"] for m in MANIFEST["per_layer"]
                if cell in m["workloads"]}
    assert set(line["metrics"]) <= reported
    assert not set(line["metrics"]) & set(READERS)
