"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file under benchmarks/."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def _reports(metric: dict) -> list:
    return metric.get("workloads", list(CELLS))


def test_top_level_keys():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_names_units_and_texts():
    named = (MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[kind]]
        assert len(names) == len(set(names)), kind
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert TEXT.match(e["why"])
    for m in MANIFEST["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        for e in MANIFEST[kind]:
            assert set(e) - {"workloads"} == want, e["name"]


def test_configs_are_files_used_by_cells():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmarks/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
        assert c["reduced"] == [] and c["source"].startswith("https://")


def test_cells_find_their_files():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["config"] == w["config"]
        assert traffic["why"] == w["why"]
        assert (BENCH / "sources" / f"{traffic['residency']}.py").is_file()


def test_metrics_have_readers_and_bounds():
    assert "setup_s" in E2E
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_of_its_cells(metric):
    moved = E2E[metric["moves"]]
    assert metric["workloads"], metric["name"]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in _reports(moved)


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m for m in MANIFEST["end_to_end"] if cell in _reports(m)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(cell in _reports(m) for m in MANIFEST["per_layer"])


def test_layers_are_named_alike():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
