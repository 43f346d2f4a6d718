"""The readers of the program's device spans (``device_spans.py`` and the
``device_us.*`` metrics) on synthetic logs, and the runs in which they
must read nothing: the parent (no device spans), the CPU, a log that
dropped spans, and counts that do not pair."""

import json
from pathlib import Path

import pytest

from benchmarks import program_spans, run
from benchmarks.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: m["workloads"] for m in MANIFEST["per_layer"]
           if m["name"].startswith("device_us.")}
# each metric's configuration, entry span and stage
STAGES = {"device_us.orb.pyramid": ("orb_stereo", "orb", "orb.pyramid"),
          "device_us.orb.detect": ("orb_stereo", "orb", "orb.detect"),
          "device_us.orb.select": ("orb_stereo", "orb", "orb.select"),
          "device_us.orb.describe": ("orb_stereo", "orb", "orb.describe"),
          "device_us.match": ("orb_stereo", "orb", "match"),
          "device_us.canny": ("lane_hough", "canny", "canny"),
          "device_us.hough": ("lane_hough", "canny", "hough")}


def _trace(device=True):
    """A stretch of two requests; on the card it holds a kernel."""
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0,
               "dur": 40.0}] if device else []
    return Trace(events, 2, [])


def _log(config, device_us=(100.0, 300.0), stages=None):
    """Two requests of ``config`` on the host clock (ns): the entry and its
    fellow host spans, and each stage's device spans of ``device_us``."""
    names = [s for c, _, s in STAGES.values() if c == config]
    entry = "orb" if config == "orb_stereo" else "canny"
    spans = []
    for k, us in enumerate(device_us):
        at = 1_000_000 * k
        spans += [(entry, at, at + 50_000, 7), (f"{entry}.x", at, at + 10, 7)]
        for j, stage in enumerate(stages or names):
            start = at + 1_000 * j
            if stage != entry:
                spans.append((stage, start, start + 20_000, 7))
            spans.append((f"{stage}@device", start,
                          start + round((j + 1) * us * 1000), 7))
    return spans


def _read(monkeypatch, metric, spans, config=None, trace=None):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    record = run.Record(cfg={"name": config or STAGES[metric][0]},
                        trace=_trace() if trace is None else trace)
    return run.load("metrics", metric).read(record)


def test_the_manifest_lists_each_reader_for_its_one_cell():
    assert set(READERS) == set(STAGES)
    for name, cells in READERS.items():
        assert cells == [f"{STAGES[name][0]}.device_b8"]


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_a_reader_gives_the_mean_of_its_stages_device_spans(monkeypatch,
                                                           metric):
    config, _, stage = STAGES[metric]
    names = [s for c, _, s in STAGES.values() if c == config]
    j = names.index(stage)
    # the stage's spans last (j + 1) x 100 and (j + 1) x 300 us
    got = _read(monkeypatch, metric, _log(config))
    assert got == pytest.approx((j + 1) * 200.0)


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_a_reader_reads_nothing_where_it_must(monkeypatch, metric):
    config, entry, stage = STAGES[metric]
    other = "lane_hough" if config == "orb_stereo" else "orb_stereo"
    log = _log(config)
    host_only = [s for s in log if not s[0].endswith("@device")]
    assert _read(monkeypatch, metric, host_only) is None  # the parent
    assert _read(monkeypatch, metric, log, config=other) is None
    assert _read(monkeypatch, metric, log, trace=_trace(False)) is None
    assert _read(monkeypatch, metric, None) is None  # dropped, or no log
    one_short = list(log)
    one_short.remove(next(s for s in log if s[0] == f"{stage}@device"))
    assert _read(monkeypatch, metric, one_short) is None
    one_more = log + [(entry, 5_000_000, 5_050_000, 7)]
    assert _read(monkeypatch, metric, one_more) is None


def test_a_log_that_dropped_spans_is_not_read(monkeypatch):
    """Through the program's own recorder: the same log reads once it
    dropped nothing, and not after."""
    from zignal_tpu_torch.profiling import RECORDER

    record = run.Record(cfg={"name": "orb_stereo"}, trace=_trace())
    reader = run.load("metrics", "device_us.match")
    monkeypatch.setattr(RECORDER, "spans", _log("orb_stereo"))
    monkeypatch.setattr(RECORDER, "dropped", 0)
    assert reader.read(record) == pytest.approx(5 * 200.0)
    monkeypatch.setattr(RECORDER, "dropped", 1)
    assert reader.read(record) is None


def test_the_entry_readers_still_read_with_device_spans_in_the_log(
        monkeypatch):
    """``entry_us.orb`` and ``entry_us.match`` read their host spans alone
    when the log holds the device spans too."""
    harness = [("launch", 0, 60_000), ("wait", 60_000, 70_000),
               ("launch", 1_000_000, 1_060_000),
               ("wait", 1_060_000, 1_070_000)]
    events = [{"ph": "X", "cat": "cuda_runtime",
               "name": "cudaEventSynchronize", "ts": t0 / 1e3, "dur": 1.0}
              for name, t0, _ in harness if name == "wait"]
    events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 5.0,
                   "dur": 40.0})
    trace = Trace(events, 2, harness)
    log = _log("orb_stereo")
    for metric, us in (("entry_us.orb", 50.0), ("entry_us.match", 20.0)):
        assert _read(monkeypatch, metric, log, "orb_stereo", trace) == \
            pytest.approx(us)
