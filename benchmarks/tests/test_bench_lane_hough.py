"""The lane_hough deployment's check at toy sizes on the CPU: its frozen
reference held to the port's plain path, the road frames it is fed, and
the faults a request can have, planted under the program's entries, each
not correct; the control and the sound program too."""

import ast
import json
from pathlib import Path

import pytest
import torch

from benchmarks import roofline_edges, run
from benchmarks.reference import lane_hough
from benchmarks.sources import device_road

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "lane_hough.device_b8"
CFG = json.loads((ROOT / "benchmarks" / "configs" / "lane_hough.json")
                 .read_text())
TOY = dict(CFG, **CFG["toy"])
ADAPTER = run.load("configs", "lane_hough")
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
    return device_road.frames((b, cfg["rows"], cfg["cols"]), gen, CPU)


def _measure(control=False, seed=2 ** 32 + 99):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.2", "--device", "cpu"])
    return run.measure(args, MANIFEST, torch, control=control)[0]


@pytest.mark.parametrize("seed", [1, 2 ** 40])
def test_reference_equals_the_plain_path(seed):
    x = _frames(TOY, seed, 3)
    out = ADAPTER.run_device(TOY, x, _Span())
    ref = ADAPTER.reference(TOY, x)
    assert lane_hough.compare(TOY, out, ref) == {
        "edge_pixels_differing": 0.0, "accumulator_bins_differing": 0.0,
        "lines_differing": 0.0}
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int(out[3].sum()) > 0


def test_frames_are_seeded_drives():
    a, b, c = _frames(TOY, 7), _frames(TOY, 7), _frames(TOY, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.shape == (2, TOY["rows"],
                                                  TOY["cols"])


def test_frames_hold_edges_and_long_weak_chains_at_the_cells_size():
    """At 1241 x 376: at least 2 % edge pixels, and a hysteresis that
    grows over more than one convergence test."""
    from zignal_tpu_torch.ops import edges

    x = _frames(CFG, 11).to(torch.float32)
    tests = []

    def counted(prev, cur, equal=torch.equal):
        tests.append(1)
        return equal(prev, cur)

    e = edges.canny(x)
    assert float((e > 0).float().mean()) >= 0.02
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(edges.torch, "equal", counted)
        assert torch.equal(edges.canny(x), e)
    assert len(tests) >= 4


def test_control_is_not_correct():
    result = _measure(control=True)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["edge_pixels_differing"]["value"] > \
        checks["edge_pixels_differing"]["limit"]


def test_sound_program_is_correct():
    result = _measure()
    assert result["correct"] is True
    assert all(c["value"] == 0 for c in result["checks"].values())


def _zero_one_frame(fn):
    def planted(*a, **k):
        out = fn(*a, **k).clone()
        out[-1] = 0
        return out
    return planted


def _one_test(fn):
    """The hysteresis returned after its first convergence test."""
    from zignal_tpu_torch.ops import edges

    def planted(candidate, gradients, t_low, t_high, span=None):
        weak = candidate & (gradients >= t_low)
        strong = candidate & (gradients >= t_high)
        cur = (weak & edges._dilate8(strong)) | strong
        for _ in range(edges._GROWTH_STEPS):
            cur = (weak | strong) & edges._dilate8(cur)
        return cur
    return planted


def _shifted_votes(fn):
    def planted(planes, size):
        return torch.roll(fn(planes, size), 1, dims=1)
    return planted


def _ties_reversed(fn):
    """Lines of equal score in the other order."""
    def planted(self, *a, **k):
        rows, valid = fn(self, *a, **k)
        n = rows.shape[1]
        idx = torch.arange(n).expand(rows.shape[0], n)
        key = torch.where(valid, rows[..., 2].long() * (n + 1) + idx, -1)
        order = torch.argsort(key, dim=1, descending=True)
        return rows.gather(1, order[..., None].expand(-1, -1, 3)), valid
    return planted


# (the program's module, its attribute, the fault planted over it, the
# frames' size: the toy's, or the cell's where a toy frame's chains are
# too short for the fault to pass the limit on every request)
FAULTS = {
    "one_frame_edges_zeroed": ("edges", "canny", _zero_one_frame, TOY),
    "hysteresis_stopped_after_one_test": ("edges", "_hysteresis", _one_test,
                                          CFG),
    "votes_shifted_a_rho_bin": ("hough", "_vote", _shifted_votes, TOY),
    "line_ties_broken_the_other_way": ("HoughTransform",
                                       "find_lines_tensors", _ties_reversed,
                                       TOY),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    """The check of a request of fixed frames, with the fault planted,
    passes a limit."""
    from zignal_tpu_torch.ops import edges, hough

    module, name, plant, cfg = FAULTS[fault]
    owner = {"edges": edges, "hough": hough,
             "HoughTransform": hough.HoughTransform}[module]
    x = _frames(cfg, 2 ** 32 + 99, 2)
    ref = ADAPTER.reference(cfg, x)
    sound = lane_hough.compare(cfg, ADAPTER.run_device(cfg, x, _Span()), ref)
    assert all(v <= cfg["limits"][k] for k, v in sound.items())
    monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    checks = lane_hough.compare(cfg, ADAPTER.run_device(cfg, x, _Span()),
                                ref)
    assert any(v > cfg["limits"][k] for k, v in checks.items())


def test_a_fault_fails_the_harness_run(monkeypatch):
    """Through the harness too: one frame's edges zeroed is not correct."""
    from zignal_tpu_torch.ops import edges

    monkeypatch.setattr(edges, "canny", _zero_one_frame(edges.canny))
    result = _measure()
    assert result["correct"] is False
    assert result["checks"]["edge_pixels_differing"]["value"] > \
        result["checks"]["edge_pixels_differing"]["limit"]


def test_limits_are_written_with_their_reasons():
    assert set(CFG["limits"]) == set(CFG["limits_why"]) == {
        "edge_pixels_differing", "accumulator_bins_differing",
        "lines_differing"}
    assert CFG["limits"]["accumulator_bins_differing"] == 0
    assert CFG["limits"]["lines_differing"] == 0
    assert CFG["reduced"] == [] and (CFG["rows"], CFG["cols"]) == (376, 1241)


def test_the_reference_imports_neither_the_program_nor_jax():
    tree = ast.parse((ROOT / "benchmarks" / "reference" / "lane_hough.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "zignal_tpu", "zignal_tpu_torch"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_roofline_counts():
    ms, which = roofline_edges.request_bound(8, 376, 1241, 1024)
    assert which == "bytes" and round(ms, 5) == 0.02838
    assert roofline_edges.PIXEL_OPS == 81
    assert ADAPTER.bound_ms(CFG, 8) == ms
