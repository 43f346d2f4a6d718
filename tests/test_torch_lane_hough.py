"""The lane_hough deployment's program paths on the CPU: the Hough
transform of a batch (``HoughTransform.compute_batch``) against the
per-frame ``compute`` and the JAX package, the device line finder
(``find_lines_tensors``) against the host ``find_lines`` on accumulators
built to hold ties, suppressed peaks and too few or no peaks, Canny on
road frames against the JAX package, the one-copy dilation and the table
caches, and the deployment's plain reference against the program at the
configuration's toy size."""

import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zignal_tpu.ops import edges as jax_edges
from zignal_tpu.ops import hough as jhough

from zignal_tpu_torch.ops import edges, hough

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmarks" / "configs" / "lane_hough.json")
                 .read_text())
TOY = dict(CFG, **CFG["toy"])


def _sparse_planes(b, h, w, seed, share=0.004):
    """u8 ``[b, h, w]`` edge planes: a line across each and a few specks."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((b, h, w), np.uint8)
    for i in range(b):
        planes[i][rng.random((h, w)) < share] = 255
        r = rng.integers(0, h)
        planes[i, r, :] = 255 if i % 2 == 0 else 0
    return torch.from_numpy(planes)


# -- compute_batch ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 40, 70), (2, 70, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("size", [64, 256, 1024])
def test_compute_batch_equals_each_frames_compute(size, shape):
    planes = _sparse_planes(*shape, seed=size + shape[1])
    ht = hough.HoughTransform(size)
    acc = ht.compute_batch(planes)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (
        shape[0], size, size)
    for f in range(shape[0]):
        want = ht.compute(planes[f])
        assert want.dtype == np.int32
        np.testing.assert_array_equal(acc[f].numpy(), want)
    if size <= 256:  # and the JAX package's accumulator, frame by frame
        for f in range(shape[0]):
            np.testing.assert_array_equal(
                acc[f].numpy(),
                jhough.HoughTransform(size).compute(planes[f].numpy()))


def test_compute_batch_votes_in_theta_chunks(monkeypatch):
    planes = _sparse_planes(3, 48, 80, seed=7, share=0.05)
    ht = hough.HoughTransform(64)
    whole = ht.compute_batch(planes)
    monkeypatch.setattr(hough, "_VOTES", 999)  # a few thetas a chunk
    assert torch.equal(ht.compute_batch(planes), whole)


def test_compute_batch_of_no_edges_is_zero():
    acc = hough.HoughTransform(32).compute_batch(
        torch.zeros((2, 20, 30), dtype=torch.uint8))
    assert acc.shape == (2, 32, 32) and not acc.any()


def test_compute_batch_rejects_a_single_plane():
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        hough.HoughTransform(32).compute_batch(
            torch.zeros((20, 30), dtype=torch.uint8))


# -- find_lines_tensors -------------------------------------------------------

N = 64


def _acc(peaks, n=N):
    """An int32 accumulator holding each (r, c, score) of ``peaks`` over a
    floor of small noise."""
    acc = np.random.default_rng(len(peaks)).integers(0, 5, (n, n))
    for r, c, score in peaks:
        acc[r, c] = score
    return acc.astype(np.int32)


# each case: accumulators of one batch and the threshold
CASES = {
    # equal scores everywhere: the order falls to (r, c) descending
    "ties": ([_acc([(r, c, 50) for r in (5, 20, 40) for c in (3, 30, 60)]),
              _acc([(10, 10, 70), (10, 40, 70), (30, 10, 70)])], 20),
    # peaks closer than 5 degrees and 10 radius to a stronger one
    "suppressed": ([_acc([(30, 20, 90), (31, 21, 80), (33, 22, 85),
                          (40, 22, 60), (30, 50, 75), (29, 51, 74)])], 20),
    # fewer lines than max_lines in one frame, none in the next
    "few_and_none": ([_acc([(12, 12, 40), (50, 50, 45)]), _acc([])], 20),
    # nothing reaches the threshold
    "none": ([_acc([(12, 12, 40)]), _acc([])], 1000),
    # more peaks than max_lines
    "many": ([_acc([(r, c, 30 + (r * 7 + c) % 40) for r in range(3, 62, 4)
                    for c in range(3, 62, 4)])], 20),
}


def _host_rows(ht, acc, threshold, max_lines, angle=5.0, radius=10.0):
    """``find_lines``'s first ``max_lines`` lines as (angle, radius,
    score)."""
    return [(line.angle, line.radius, line.score)
            for line in ht.find_lines(acc, threshold, angle,
                                      radius)[:max_lines]]


def _device_rows(ht, rows, valid):
    out = []
    for (r, c, score), ok in zip(rows.tolist(), valid.tolist()):
        if ok:
            out.append((c * (180.0 / ht.even_size) - 90.0,
                        (r - ht.even_size / 2.0) * math.sqrt(2.0), score))
        else:
            assert (r, c, score) == (0, 0, 0)
    return out


@pytest.mark.parametrize("max_lines", [32, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_find_lines_tensors_equals_find_lines(case, max_lines):
    accs, threshold = CASES[case]
    ht = hough.HoughTransform(N)
    batch = torch.from_numpy(np.stack(accs))
    rows, valid = ht.find_lines_tensors(batch, threshold, max_lines=max_lines)
    assert rows.dtype == torch.int32 and valid.dtype == torch.bool
    assert rows.shape == (len(accs), max_lines, 3)
    for f, acc in enumerate(accs):
        want = _host_rows(ht, acc, threshold, max_lines)
        # valid rows first, in find_lines' order
        assert valid[f].tolist() == [True] * len(want) + [False] * (
            max_lines - len(want))
        assert _device_rows(ht, rows[f], valid[f]) == want
    if case == "suppressed":
        assert len(ht.find_lines(accs[0], threshold)) < 6
    if case == "many" and max_lines == 3:
        assert len(ht.find_lines(accs[0], threshold)) > 3


@pytest.mark.parametrize("threshold", [10, 30, 60])
def test_find_lines_tensors_of_real_votes_equal_find_lines(threshold):
    planes = _sparse_planes(3, 96, 96, seed=threshold, share=0.03)
    ht = hough.HoughTransform(96)
    acc = ht.compute_batch(planes)
    rows, valid = ht.find_lines_tensors(acc, threshold, 4.0, 8.0, 16)
    for f in range(3):
        assert _device_rows(ht, rows[f], valid[f]) == _host_rows(
            ht, acc[f].numpy(), threshold, 16, 4.0, 8.0)


@pytest.mark.parametrize("size,max_lines", [(2, 4), (N, 0), (3, 2)])
def test_find_lines_tensors_without_an_interior_or_lines_is_empty(
        size, max_lines):
    ht = hough.HoughTransform(size)
    acc = torch.full((2, size, size), 500, dtype=torch.int32)
    rows, valid = ht.find_lines_tensors(acc, 10, max_lines=max_lines)
    assert rows.shape == (2, max_lines, 3) and valid.shape == (2, max_lines)
    # a 3 x 3 plane's one interior bin is a peak of a flat accumulator
    lines = min(max_lines, 1) if size == 3 else 0
    assert valid.sum(1).tolist() == [lines, lines]
    assert int(rows[~valid].abs().sum()) == 0


def test_find_lines_tensors_refuses_a_negative_count():
    ht = hough.HoughTransform(N)
    with pytest.raises(ValueError, match="max_lines"):
        ht.find_lines_tensors(torch.zeros((1, N, N), dtype=torch.int32), 10,
                              max_lines=-1)


@pytest.mark.parametrize("size", [2, 64, 1024, 2048, 46340])
def test_a_vote_block_counts_the_thetas_its_shared_bins_hold(size):
    from zignal_tpu_torch.ops import hough_kernels

    t = hough_kernels.thetas(size)
    assert 1 <= t <= hough_kernels.MAX_THETAS and t & (t - 1) == 0
    assert size * t * 4 <= hough_kernels.BIN_BYTES or t == 1
    assert t == hough_kernels.MAX_THETAS or \
        size * 2 * t * 4 > hough_kernels.BIN_BYTES


def _emulate_vote(planes, size):
    """The vote kernel's schedule in numpy: each frame's edge list of y <<
    16 | x over its NEAREST plane, then a block's T thetas counted in its
    own [size, T] bins and written into those columns."""
    from zignal_tpu_torch.ops import hough_kernels
    from zignal_tpu_torch.ops.tables import nearest_indices

    b, h, w = planes.shape
    rows, cols = nearest_indices(h, size), nearest_indices(w, size)
    cos_t, sin_t, offset, _ = hough._tables(size)
    t_n = hough_kernels.thetas(size)
    acc = np.full((b, size, size), -1, np.int64)
    for f in range(b):
        ys, xs = np.nonzero(planes[f].numpy()[rows][:, cols] > 0)
        packed = (ys << 16 | xs).astype(np.int32)
        xv = 2 * (packed & 0xffff) - (size - 1)
        yv = 2 * (packed >> 16) - (size - 1)
        for t0 in range(0, size, t_n):
            bins = np.zeros((size, t_n), np.int64)
            for lt in range(min(t_n, size - t0)):
                ct, st = np.int32(cos_t[t0 + lt]), np.int32(sin_t[t0 + lt])
                rho = xv.astype(np.int32) * ct + yv.astype(np.int32) * st
                r = ((rho >> 1) + (np.int32(offset) << 1)) >> 16
                r = r[(r >= 0) & (r < size)]
                np.add.at(bins[:, lt], r, 1)
            c = min(t_n, size - t0)
            acc[f, :, t0:t0 + c] = bins[:, :c]
    return acc


@pytest.mark.parametrize("shape,size", [((2, 30, 50), 37), ((1, 64, 64), 64),
                                        ((2, 41, 23), 100)])
def test_vote_kernel_schedule_equals_the_plain_votes(shape, size):
    planes = _sparse_planes(*shape, seed=size, share=0.05)
    want = hough.HoughTransform(size).compute_batch(planes)
    got = _emulate_vote(planes, size)
    assert (got >= 0).all()
    assert np.array_equal(got, want.numpy())


def test_lines_batch_is_compute_then_find():
    planes = _sparse_planes(2, 50, 90, seed=3, share=0.03)
    ht = hough.HoughTransform(64)
    acc, rows, valid = ht.lines_batch(planes, 15, max_lines=8)
    assert torch.equal(acc, ht.compute_batch(planes))
    want_rows, want_valid = ht.find_lines_tensors(acc, 15, max_lines=8)
    assert torch.equal(rows, want_rows) and torch.equal(valid, want_valid)


# -- Canny --------------------------------------------------------------------

def _road(seed, b=2, rows=96, cols=160):
    from benchmarks.sources import device_road

    gen = torch.Generator().manual_seed(seed)
    return device_road.frames((b, rows, cols), gen, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 2 ** 40 + 3])
def test_canny_on_road_frames_equals_jax(seed):
    x = _road(seed).to(torch.float32)
    got = edges.canny(x).numpy()
    for f in range(x.shape[0]):
        want = np.asarray(jax_edges.canny(jnp.asarray(x[f].numpy())))
        np.testing.assert_array_equal(got[f], want)
    assert got.any()


def _old_dilate8(mask):
    h = mask | edges._shift(mask, 0, -1, False) | edges._shift(mask, 0, 1,
                                                               False)
    return h | edges._shift(h, -1, 0, False) | edges._shift(h, 1, 0, False)


@pytest.mark.parametrize("shape", [(2, 9, 13), (1, 1), (3, 1, 7), (5, 2)])
def test_one_copy_dilation_equals_the_shifted_ors(shape):
    mask = torch.from_numpy(np.random.default_rng(sum(shape)).random(shape)
                            < 0.2)
    assert torch.equal(edges._dilate8(mask), _old_dilate8(mask))


def test_hysteresis_on_road_frames_does_not_depend_on_steps(monkeypatch):
    x = _road(5).to(torch.float32)
    want = edges.canny(x)
    monkeypatch.setattr(edges, "_GROWTH_STEPS", 1)
    assert torch.equal(edges.canny(x), want)


def test_the_cached_tables_are_made_once():
    a = torch.zeros((2, 6, 7))
    assert edges._interior(a) is edges._interior(torch.ones((6, 7)))
    assert edges._interior(a)[1:-1, 1:-1].all()
    assert not edges._interior(a)[0].any()


def test_the_kernels_take_only_card_tensors():
    from zignal_tpu_torch.ops import canny_front, hough_kernels, hysteresis

    cand = torch.zeros((4, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="device cpu"):
        hysteresis.hysteresis_u8(cand, torch.zeros((4, 5)), 1.0, 2.0)
    with pytest.raises(ValueError, match="bool"):
        hysteresis.hysteresis_u8(cand.byte(), torch.zeros((4, 5)), 1.0, 2.0)
    with pytest.raises(ValueError, match="device cpu"):
        canny_front.front(torch.zeros((4, 5)), 1.4)
    with pytest.raises(ValueError, match="f32"):
        canny_front.front(torch.zeros((4, 5), dtype=torch.float64), 1.4)
    with pytest.raises(ValueError, match="device cpu"):
        hough_kernels.vote(torch.zeros((1, 4, 5), dtype=torch.uint8), 8,
                           None, None, 0, 8)
    with pytest.raises(ValueError, match="on a card"):
        hough_kernels.lines(torch.zeros((1, 8, 8), dtype=torch.int32), 1,
                            5.0, 10.0, 4, 8)


@pytest.mark.parametrize("sigma,taps", [(0.0, 0), (1.4, 11), (5.0, 31),
                                        (5.4, 35)])
def test_the_front_kernel_takes_blurs_of_up_to_33_taps(sigma, taps):
    from zignal_tpu_torch.ops import canny_front

    assert len(canny_front._taps(sigma)) == taps
    assert canny_front.supports(sigma) == (taps <= canny_front.MAX_TAPS)


def test_the_front_kernel_keeps_the_plain_routes_taps():
    """Every tap on an axis longer than the radius with a nonzero weight;
    every tap, zero or not, on a shorter one (``_sep_pass_float``)."""
    from zignal_tpu_torch.ops import canny_front

    w = (0.25, 0.0, 0.5, 0.0, 0.25)
    assert canny_front._kept(w, 9)[0] == [0, 2, 4]
    assert canny_front._kept(w, 2)[0] == [0, 1, 2, 3, 4]
    assert canny_front._kept(w, 9)[1].dtype == np.float32


# -- the deployment's reference ------------------------------------------------

@pytest.mark.parametrize("seed", [11, 2 ** 33 + 1])
def test_reference_equals_the_program_at_the_toy_size(seed):
    from benchmarks.reference import lane_hough as ref

    x = _road(seed, 2, TOY["rows"], TOY["cols"])
    e = edges.canny(x.to(torch.float32), TOY["sigma"], TOY["low"],
                    TOY["high"])
    ht = hough.HoughTransform(TOY["hough_size"])
    acc, rows, valid = ht.lines_batch(e, TOY["threshold"], TOY["angle_nms"],
                                      TOY["radius_nms"], TOY["max_lines"])
    want = ref.lane_hough(x, TOY)
    assert torch.equal(e, want[0])
    assert torch.equal(acc, want[1])
    assert torch.equal(rows, want[2]) and torch.equal(valid, want[3])
    assert int(valid.sum()) > 0
    assert ref.compare(TOY, (e, acc, rows, valid), want) == {
        "edge_pixels_differing": 0.0, "accumulator_bins_differing": 0.0,
        "lines_differing": 0.0}
