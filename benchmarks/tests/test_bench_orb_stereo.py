"""The orb_stereo deployment's check at toy sizes on the CPU: its frozen
reference held to the port's plain path, the stereo frames it is fed, and
the faults a request can have, planted under the program's entries, each
not correct; the control and the sound program too (which
``test_bench_checks.py`` also runs for every cell)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import roofline_features, run
from benchmarks.reference import orb_stereo
from benchmarks.sources import device_stereo

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "orb_stereo.device_b8"
CFG = json.loads((ROOT / "benchmarks" / "configs" / "orb_stereo.json")
                 .read_text())
TOY = dict(CFG, **CFG["toy"])
ADAPTER = run.load("configs", "orb_stereo")
CPU = torch.device("cpu")


class _Span:
    def __call__(self, name):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _frames(cfg, seed, b=2):
    gen = torch.Generator().manual_seed(seed)
    return device_stereo.frames((b, cfg["rows"], cfg["cols"]), gen, CPU)


def _measure(control=False, seed=2 ** 32 + 99):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.2", "--device", "cpu"])
    return run.measure(args, MANIFEST, torch, control=control)[0]


def _noise(cfg, seed, b=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, cfg["rows"], cfg["cols"]),
                         generator=gen, dtype=torch.uint8)


@pytest.mark.parametrize("which,seed", [("stereo", 1), ("stereo", 2 ** 40),
                                        ("noise", 3)])
def test_reference_equals_the_plain_path(which, seed):
    x = (_frames if which == "stereo" else _noise)(TOY, seed, 4)
    out = ADAPTER.run_device(TOY, x, _Span())
    checks = orb_stereo.compare(TOY, out, ADAPTER.reference(TOY, x))
    assert checks["keypoints_differing"] == 0
    assert checks["descriptor_bits_differing"] == 0
    assert checks["matches_differing"] == 0
    assert checks["angle_max_gap_deg"] <= 1e-4
    assert int(out[2].sum()) > 40 and int((out[3][0] >= 0).sum()) > 0


def test_reference_pyramid_is_the_ports():
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    x = _frames(TOY, 5)
    got = ImagePyramid.build(x, TOY["n_levels"], TOY["scale_factor"], 1.6)
    for f in range(2):
        for a, b in zip(got.levels, orb_stereo.pyramid(x[f], TOY)):
            assert torch.equal(a[f], b)


def test_frames_are_seeded_stereo_pairs():
    a, b, c = _frames(TOY, 7), _frames(TOY, 7), _frames(TOY, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.shape == (2, TOY["rows"], TOY["cols"])
    # each band of the right frame is the left one's read a few columns
    # to the right, with new grain
    left, right = a[0].to(torch.int32), a[1].to(torch.int32)
    cols = TOY["cols"]
    for band in range(device_stereo.BANDS):
        rows = slice(TOY["rows"] * band // device_stereo.BANDS,
                     TOY["rows"] * (band + 1) // device_stereo.BANDS)
        gaps = [float((right[rows, :cols - 60] - left[rows, d:cols - 60 + d])
                      .abs().float().mean()) for d in range(60)]
        assert min(gaps) < 4 < gaps[0]
    with pytest.raises(ValueError, match="pairs"):
        _frames(TOY, 1, 3)


def test_frames_fill_every_levels_budget_at_the_cells_size():
    """Every level holds more candidates than its budget (the rows of its
    top-k all finite) on a pair of frames at 1241 x 376."""
    from zignal_tpu_torch.features import Orb

    x = _frames(CFG, 11)
    orb = ADAPTER._orb(CFG)
    assert isinstance(orb, Orb)
    kps, _, valid = orb.detect_and_compute_tensors(x)
    ks = orb_stereo.budgets(CFG)
    assert kps.shape[1] == sum(ks) == 1999
    assert bool(torch.isfinite(kps[..., 0]).all())
    assert float(valid.float().mean()) > 0.75


def test_control_is_not_correct():
    result = _measure(control=True)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["angle_max_gap_deg"]["value"] > \
        checks["angle_max_gap_deg"]["limit"]


def test_sound_program_is_correct():
    result = _measure()
    assert result["correct"] is True
    assert result["checks"]["matches_differing"]["value"] == 0


def _zero_one_frame(fn):
    def planted(self, planes):
        kps, desc, valid = fn(self, planes)
        desc = desc.clone()
        desc[1] = 0
        return kps, desc, valid
    return planted


def _no_cross_check(fn):
    return lambda *a, cross_check=True, **k: fn(*a, cross_check=False, **k)


def _right_rows_shifted(fn):
    def planted(*a, **k):
        idx, dist = fn(*a, **k)
        return torch.where(idx >= 0, idx + 1, idx), dist
    return planted


# (the program's module, its function, the fault planted over it)
FAULTS = {
    "one_frame_descriptors_zeroed": ("orb", "detect_and_compute_tensors",
                                     _zero_one_frame),
    "cross_check_dropped": ("matcher", "match_tensors", _no_cross_check),
    "right_matches_shifted_a_row": ("matcher", "match_tensors",
                                    _right_rows_shifted),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    from zignal_tpu_torch.features import Orb, matcher

    module, name, plant = FAULTS[fault]
    owner = Orb if module == "orb" else matcher
    monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    result = _measure()
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _tie_frames(rows=120, cols=200):
    """Two frames of identical bright squares on a flat field, inside the
    level-0 margin: their corners' responses tie exactly, more of them
    than the level's budget."""
    x = torch.full((2, rows, cols), 90, dtype=torch.uint8)
    for y in range(36, rows - 36, 12):
        for c in range(36, cols - 36, 12):
            x[:, y:y + 5, c:c + 5] = 200
    return x


def test_unstable_top_k_is_not_correct(monkeypatch):
    """Ties broken towards the higher flat index (a top-k that is not
    stable) select other keypoints than the reference's stable order."""
    from zignal_tpu_torch.features import orb

    cfg = dict(TOY, rows=120, cols=200)
    x = _tie_frames()
    ref = ADAPTER.reference(cfg, x)
    sound = orb_stereo.compare(cfg, ADAPTER.run_device(cfg, x, _Span()), ref)
    assert sound["keypoints_differing"] == 0

    def unstable(cand, k):
        n = cand.shape[-1]
        resp, idx = torch.sort(cand.flip(-1), dim=-1, descending=True,
                               stable=True)
        return resp[:, :k], n - 1 - idx[:, :k]

    monkeypatch.setattr(orb, "_top_k", unstable)
    faulty = orb_stereo.compare(cfg, ADAPTER.run_device(cfg, x, _Span()),
                                ref)
    assert faulty["keypoints_differing"] > cfg["limits"][
        "keypoints_differing"]


def test_limits_are_written_with_their_reasons():
    assert set(CFG["limits"]) == set(CFG["limits_why"]) == {
        "keypoints_differing", "descriptor_bits_differing",
        "angle_max_gap_deg", "matches_differing"}
    assert CFG["limits"]["matches_differing"] == 0
    assert CFG["reduced"] == [] and (CFG["rows"], CFG["cols"]) == (376, 1241)


def test_roofline_counts():
    ms, which = roofline_features.request_bound(8, 376, 1241, 2000, 1.2, 8)
    assert which == "operations" and round(ms, 5) == 0.02019
    assert roofline_features.PATCH_VALUES == 709
    assert np.isclose(ADAPTER.bound_ms(CFG, 8), ms)
