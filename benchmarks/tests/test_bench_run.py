"""The harness end to end on the CPU at toy sizes (``--device cpu``, the
program's plain path), and the runs that must give no result."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmarks import run

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def _cpu_args(cell, seed=2 ** 31 + 7, seconds=0.3, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu"]


def _reported(key, cell):
    return {m["name"]: m["unit"] for m in MANIFEST[key]
            if cell in m.get("workloads", [cell])}


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_prints_the_contract_line(cell, capsys):
    assert run.main(_cpu_args(cell)) == 0
    line = _last_line(capsys)
    assert list(line) == REQUIRED + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = _reported("end_to_end", cell)
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_traced_run_adds_the_trace(cell, capsys):
    assert run.main(_cpu_args(cell, trace=1)) == 0
    line = _last_line(capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) <= set(_reported("per_layer", cell))
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_seed_makes_the_inputs():
    from benchmarks.sources import device

    a, b, c = (device.Ring((2, 8, 8), 2, s, torch.device("cpu"))
               for s in (5, 5, 6))
    assert torch.equal(a.on_device(1), b.on_device(1))
    assert not torch.equal(a.on_device(1), c.on_device(1))


def test_sample_spreads_over_the_window():
    s = run.Sample(4, 3)
    for k in range(1000):
        s.offer(k, k)
    kept = [k for k, _ in s.items()]
    assert 4 <= len(kept) <= 9 and kept[-1] == 999
    assert kept[0] < 250 and all(k % s.stride == 3 % s.stride
                                 for k in kept[:-1])


def _subprocess(args, cwd, **env):
    return subprocess.run([sys.executable, "-m", "benchmarks.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=dict(os.environ, **env), timeout=300)


def test_no_card_no_result():
    proc = _subprocess(["--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1"], ROOT, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in MANIFEST["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = _subprocess(_cpu_args(CELLS[0]), tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_loaded_jax_refuses_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(_cpu_args(CELLS[0])) != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == "" and "jax" in captured.err


def _loads_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


@pytest.mark.parametrize("where", ["metric", "compare"])
def test_jax_loaded_after_the_window_refuses_the_run(where, monkeypatch,
                                                     capsys):
    """JAX loaded by a metric's reader, or by the check that decides
    ``correct``, both after the window, still refuses the run."""
    load = run.load

    def planted(kind, name):
        module = load(kind, name)
        if where == "metric" and kind == "metrics":
            read = module.read
            module.read = lambda r: (_loads_jax(monkeypatch), read(r))[1]
        if where == "compare" and kind == "configs":
            compare = module.compare
            module.compare = lambda *a: (_loads_jax(monkeypatch),
                                         compare(*a))[1]
        return module

    monkeypatch.setattr(run, "load", planted)
    assert "jax" not in sys.modules
    assert run.main(_cpu_args(CELLS[0])) == 2
    captured = capsys.readouterr()
    assert captured.out.strip() == "" and "jax" in captured.err


def test_unknown_workload_is_refused(capsys):
    assert run.main(_cpu_args("no_such.cell")) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _subprocess(["--workload", cell, "--seed", "12345", "--seconds",
                        "1"], ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


def test_trace_reads_a_stretch():
    from benchmarks.trace import Trace

    # two requests: spans on the host clock (ns), the trace's clock (us)
    # 1000 us ahead; the wait calls pair the two
    spans = [("launch", 0, 10_000), ("wait", 10_000, 60_000),
             ("launch", 70_000, 80_000), ("wait", 80_000, 130_000)]
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
           "ts": 1000 + t0 / 1e3, "dur": 1.0}
          for name, t0, _ in spans if name == "wait"]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 1005.0,
            "dur": 50.0},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": 1080.0,
            "dur": 40.0}]
    tr = Trace(ev, 2, spans)
    assert tr.window_s == pytest.approx(130e-6)
    assert tr.busy_s == pytest.approx(90e-6)
    assert tr.kernel_s() == pytest.approx(90e-6)
    assert tr.device_ops() == [["k", pytest.approx(90e-6)]]
    assert tr.roofline_pct(0.009) == pytest.approx(20.0)  # 9 of 45 us
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # idle 0-5 us in the first launch; 55-80 us: wait to 60, harness
    # 60-70, launch 70-80; 120-130 in the last wait
    assert gaps["launch"] == pytest.approx(15e-6)
    assert gaps["harness"] == pytest.approx(10e-6)
    assert gaps["wait"] == pytest.approx(15e-6)
    unaligned = Trace(ev[1:], 2, spans)
    assert [k for k, _ in unaligned.idle_gaps()] == ["unaligned"]
