"""The check that decides ``correct`` fails what it must: the control (the
reference in the precision below the configuration's, in the program's
place) and the faults a cell can have, planted under the program's entry
at toy sizes on the CPU."""

import json
from pathlib import Path

import pytest
import torch

from benchmarks import run

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
# the function each config's entry reaches on every path, by its name in
# zignal_tpu_torch.pipeline
KERNEL = {"north_star": "fused_resize_blur_oklab",
          "filter_fusion": "fused_blur_sharpen_morph"}


def _measure(cell, control=False, seed=99):
    import torch as t

    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.2", "--device", "cpu"])
    return run.measure(args, MANIFEST, t, control=control)[0]


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_is_not_correct(cell):
    result = _measure(cell, control=True)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _altered(out):
    out = out.clone()
    flat = out.view(-1)
    flat[0] = 255 - flat[0] if out.dtype == torch.uint8 else flat[0] + 0.01
    return out


def _half_batch(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


FAULTS = {
    # an answer altered where it is produced
    "altered": lambda fn: lambda x, *a: _altered(fn(x, *a)),
    # half of the batch left out
    "half_batch": lambda fn: lambda x, *a: _half_batch(fn(x, *a)),
    # a stage that returns what it was given: the blur of the north star
    # (sigma 0), the sharpen of the filter chain (radius 0)
    "stage_skipped": lambda fn: (
        (lambda x, rows, cols, sigma, *a: fn(x, rows, cols, 0.0, *a))
        if fn.__name__ == "fused_resize_blur_oklab"
        else (lambda x, sigma, radius, thr: fn(x, sigma, 0, thr))),
}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_batch" and
                 json.loads((ROOT / "benchmarks" / "traffic" /
                             f"{CELLS[c]['traffic']}.json").read_text())
                 ["batch"] == 1)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from zignal_tpu_torch import pipeline

    name = KERNEL[CELLS[cell]["config"]]
    monkeypatch.setattr(pipeline, name, FAULTS[fault](getattr(pipeline,
                                                              name)))
    assert _measure(cell)["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_program_is_correct(cell):
    assert _measure(cell)["correct"] is True
