"""The colorspace deployment's check at toy sizes on the CPU: its frozen
reference held to the port's plain path, and the faults a request can
have, planted under the program's entries, each not correct. (The control
and the sound program run for every cell in ``test_bench_checks.py``.)"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import run
from benchmarks.reference import colorspace
from benchmarks.sources import device_photo

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "colorspace.photo_b4"
# the port's plain f32 Lab against the float64 reference: over every RGB
# triple its widest gap is 8.4e-5 (a, 500 times a difference of two f32
# cube roots), rounded up
LAB_TOL = 1e-4


def _frames(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return device_photo.frames(shape, gen, torch.device("cpu"))


def _triples(step):
    v = torch.arange(0, 1 << 24, step, dtype=torch.int64)
    return torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1) \
        .to(torch.uint8)[None, None]


@pytest.mark.parametrize("shape,seed", [((2, 36, 48, 3), 1),
                                        ((3, 17, 5, 3), 2),
                                        ((1, 300, 400, 3), 3)])
def test_equalize_matches_the_plain_path(shape, seed):
    from zignal_tpu_torch.ops.enhancement import equalize

    x = _frames(shape, seed)
    assert torch.equal(colorspace.equalize_u8(x), equalize(x))


def test_equalize_of_flat_and_two_valued_planes():
    from zignal_tpu_torch.ops.enhancement import equalize

    x = torch.zeros((2, 8, 9, 3), dtype=torch.uint8)
    x[0, ..., 1] = 77
    x[1, :4, :, 2] = 200
    assert torch.equal(colorspace.equalize_u8(x), equalize(x))


@pytest.mark.parametrize("which", ["triples", "frames"])
def test_lab_matches_the_plain_path(which):
    from zignal_tpu_torch import pipeline

    x = _triples(7) if which == "triples" else _frames((2, 64, 80, 3), 4)
    got = pipeline.color_chain_values(x, ("rgb", "lab"))
    want = colorspace.srgb_to_lab(x)
    assert want.dtype == torch.float64
    assert float((got.double() - want).abs().max()) <= LAB_TOL


def test_frames_are_peaked_and_seeded():
    a, b, c = (_frames((1, 120, 160, 3), s) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) <= 16 + 128 + 6
    eq = colorspace.equalize_u8(a)
    assert int(eq.max()) == 255 and float((eq != a).float().mean()) > 0.9


def _measure(seed=2 ** 32 + 99):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.2", "--device", "cpu"])
    return run.measure(args, MANIFEST, torch)[0]


def _altered(fn):
    def planted(batch, spaces):
        out = fn(batch, spaces).clone()
        out.view(-1)[0] += 1.0  # a Delta E of 1
        return out
    return planted


def _half_batch(fn):
    def planted(batch, spaces):
        out = fn(batch, spaces).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return planted


# (the program's function, the fault planted over it)
FAULTS = {
    "lab_altered": ("color_chain_values", _altered),
    "half_batch": ("color_chain_values", _half_batch),
    "equalize_skipped": ("equalize", lambda fn: lambda x, *a: x),
    "chain_is_x_over_255": ("color_chain_values",
                            lambda fn: lambda b, s: b.to(torch.float32)
                            / 255),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import enhancement

    name, plant = FAULTS[fault]
    module = enhancement if name == "equalize" else pipeline
    monkeypatch.setattr(module, name, plant(getattr(module, name)))
    result = _measure()
    assert result["correct"] is False
    checks = result["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_limit_lies_between_program_and_control():
    cfg = json.loads((ROOT / "benchmarks" / "configs" / "colorspace.json")
                     .read_text())
    x = _frames((2, 64, 80, 3), 7)
    eq = colorspace.equalize_u8(x)
    ref = colorspace.srgb_to_lab(eq)
    control = colorspace.srgb_to_lab(eq, torch.bfloat16).double()
    limit = cfg["limits"]["lab_max_abs_gap"]
    assert LAB_TOL < limit < float((control - ref).abs().max())
    assert np.isfinite(limit)
