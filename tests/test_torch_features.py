"""The port's features (FAST, ORB, the Hamming matcher, the tracer) and
its batched pyramid against zignal_tpu on JAX-CPU, ``device="cpu"`` on
the port's side.

Bounds:
- copies (``CIRCLE_OFFSETS``, ``ORB_PATTERN``, the descriptor, the
  tracer, ORB's host oracle): equal;
- FAST response maps and NMS masks (integer ops): equal, on random planes
  and on planes of 7-16 px;
- ORB's device path (the inputs of tests/test_features.py:204-208, :223,
  :233 and :253): ``(x, y, octave)`` equal and in the same order,
  responses equal (the Harris map rounds where XLA's compiled program
  does: equal to JAX's ``_harris_map_device``), descriptors equal, angles
  within 1e-3 degrees (the port's ``atan2`` is the f64 one rounded to
  f32, XLA's an f32 approximation: 1 ulp, 1.5e-5 degrees, on 2 to 8
  keypoints of each case; ``python tests/test_torch_features.py`` prints
  them); BRIEF fed JAX's angles equal; the batch equal to per-image
  calls;
- the Hamming distance matrix and ``match`` / ``knn_match`` /
  ``radius_match`` (with ``cross_check``): equal.
"""

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.features import BruteForceMatcher as JMatcher
from zignal_tpu.features import Fast as JFast
from zignal_tpu.features import Orb as JOrb
from zignal_tpu.features import Tracer as JTracer
from zignal_tpu.features import fast as jfast
from zignal_tpu.features import orb as jorb
from zignal_tpu.features._orb_pattern import ORB_PATTERN as J_PATTERN
from zignal_tpu.features.matcher import _distance_matrix as j_distances
from zignal_tpu.ops.pyramid import ImagePyramid as JPyramid

import zignal_tpu_torch as zp
from zignal_tpu_torch.features import BinaryDescriptor, BruteForceMatcher, \
    Fast, KeyPoint, Orb, Tracer
from zignal_tpu_torch.features import fast as pfast
from zignal_tpu_torch.features import orb as porb
from zignal_tpu_torch.features._orb_pattern import ORB_PATTERN
from zignal_tpu_torch.features.matcher import distance_matrix
from zignal_tpu_torch.ops.pyramid import ImagePyramid

CPU = "cpu"
ANGLE_DEG = 1e-3


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _wave(h=200, w=180, seed=5):
    """tests/test_features.py:204-208's textured plane."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.clip(128 + 90 * np.sin(xx / 19) * np.cos(yy / 13)
                   + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


def _assert_same_orb(got, want, descs=True):
    kg, dg = got
    kw, dw = want
    assert len(kg) == len(kw) > 0
    assert [(k.x, k.y, k.octave, k.size) for k in kg] == \
        [(k.x, k.y, k.octave, k.size) for k in kw]
    assert [k.response for k in kg] == [k.response for k in kw]
    assert max(abs(a.angle - b.angle) for a, b in zip(kg, kw)) <= ANGLE_DEG
    if descs:
        assert len(dg) == len(dw)
        for a, b in zip(dg, dw):
            np.testing.assert_array_equal(a.bits, b.bits)


# -- copies -----------------------------------------------------------------

def test_pattern_and_circle_copies_equal():
    assert ORB_PATTERN == J_PATTERN
    assert pfast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS
    np.testing.assert_array_equal(porb._CIRC, jorb._CIRC)
    np.testing.assert_array_equal(porb._PAT, jorb._PAT)


def test_binary_descriptor_copy():
    a, b = BinaryDescriptor(), BinaryDescriptor()
    a.set_bit(3)
    a.set_bit(200)
    assert a.get_bit(200) and not b.get_bit(200)
    assert a.hamming_distance(b) == 2
    assert a != b and a == BinaryDescriptor(a.bits.copy())


# -- FAST --------------------------------------------------------------------

FAST_PLANES = [(24, 24), (64, 80), (7, 7), (7, 16), (9, 12), (12, 9),
               (16, 16), (13, 7)]


@pytest.mark.parametrize("shape", FAST_PLANES)
@pytest.mark.parametrize("threshold,run", [(20, 9), (10, 12)])
def test_fast_response_and_nms_equal_jax(shape, threshold, run):
    img = _u8(shape, sum(shape))
    got = pfast.fast_response_map(torch.from_numpy(img), threshold, run)
    want = np.asarray(jfast.fast_response_map(img, threshold, run))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pfast._nms_device(got).numpy(),
                                  np.asarray(jfast._nms_device(want)))


@pytest.mark.parametrize("side", [1, 4, 6])
def test_fast_on_planes_of_six_px_or_fewer_is_empty(side):
    img = _u8((side, side + 1), side)
    assert not pfast.fast_response_map(torch.from_numpy(img)).any()
    assert Fast().detect(img, device=CPU) == []


def test_fast_response_of_a_batch_is_per_plane():
    planes = _u8((3, 40, 44), 2)
    got = pfast.fast_response_map(torch.from_numpy(planes), 15, 9)
    for i in range(3):
        want = jfast.fast_response_map(planes[i], 15, 9)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_fast_detect_equals_jax_on_every_input_kind():
    sq = np.zeros((64, 64), np.uint8)
    sq[16:48, 16:48] = 255
    want = JFast(threshold=30).detect(sq)
    assert len(want) >= 4
    for arg in (dict(image=sq, device=CPU), dict(image=torch.from_numpy(sq)),
                dict(image=zp.Image.from_numpy(
                    np.repeat(sq[..., None], 3, -1), device=CPU))):
        got = Fast(threshold=30).detect(arg.pop("image"), **arg)
        assert got == want or [(k.x, k.y, k.response) for k in got] == \
            [(k.x, k.y, k.response) for k in want]
        assert all(isinstance(k, KeyPoint) for k in got)
    with pytest.raises(ValueError, match="device"):
        Fast().detect(sq)


# -- ORB ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def wave_orb():
    """JAX's device and host ORB on the 200x180 plane (one compile)."""
    img = _wave()
    return img, JOrb(n_features=150, n_levels=4).detect_and_compute(img)


def test_orb_device_path_equals_jax(wave_orb):
    img, want = wave_orb
    got = Orb(n_features=150, n_levels=4).detect_and_compute(img, device=CPU)
    _assert_same_orb(got, want)


def test_orb_host_oracle_equals_jax_host_oracle(wave_orb):
    img, _ = wave_orb
    got = Orb(n_features=150, n_levels=4, use_device=False) \
        .detect_and_compute(img, device=CPU)
    want = JOrb(n_features=150, n_levels=4, use_device=False) \
        .detect_and_compute(img)
    _assert_same_orb(got, want)
    assert [k.angle for k in got[0]] == [k.angle for k in want[0]]


def test_orb_device_path_within_jax_bound_of_its_host_oracle(wave_orb):
    img, _ = wave_orb
    kd, dd = Orb(n_features=150, n_levels=4).detect_and_compute(img,
                                                                device=CPU)
    kh, dh = Orb(n_features=150, n_levels=4, use_device=False) \
        .detect_and_compute(img, device=CPU)
    assert [(a.x, a.y, a.octave) for a in kd] == \
        [(b.x, b.y, b.octave) for b in kh]
    for a, b, da, db in zip(kd, kh, dd, dh):
        assert abs(a.angle - b.angle) < 1e-3
        assert abs(a.response - b.response) <= 1e-3 * max(1.0, abs(b.response))
        np.testing.assert_array_equal(da.bits, db.bits)


def test_brief_fed_jax_angles_equals_jax(wave_orb):
    img, (kw, dw) = wave_orb
    pyr = JPyramid.build(img, 4, 1.2, 1.6)
    for level in sorted({k.octave for k in kw}):
        sel = [i for i, k in enumerate(kw) if k.octave == level]
        scale = 1.2 ** level
        lvl = torch.from_numpy(np.asarray(pyr.levels[level]))[None]
        xs = torch.tensor([[round(kw[i].x / scale) for i in sel]])
        ys = torch.tensor([[round(kw[i].y / scale) for i in sel]])
        ang = torch.tensor([[kw[i].angle for i in sel]], dtype=torch.float32)
        got = porb._brief(lvl, ys, xs, ang)[0].numpy()
        want = np.stack([dw[i].bits for i in sel])
        np.testing.assert_array_equal(got, want)


def test_harris_map_equals_jax_compiled():
    """The map as it runs inside JAX's compiled ORB program (XLA contracts
    its multiply-adds; run eagerly, op by op, it would not)."""
    import jax

    lvl = _wave(120, 130, 6)
    got = porb._harris_map(torch.from_numpy(lvl))
    want = np.asarray(jax.jit(jorb._harris_map_device)(lvl))
    np.testing.assert_array_equal(got.numpy(), want)


def test_orb_detect_only_equals_jax():
    img = _u8((96, 96), 9)
    got = Orb(n_features=60, n_levels=3).detect(torch.from_numpy(img))
    want = JOrb(n_features=60, n_levels=3).detect(img)
    assert [(k.x, k.y, k.octave, k.response) for k in got] == \
        [(k.x, k.y, k.octave, k.response) for k in want]


def test_orb_fast_score_ties_break_as_jax():
    """Integer FAST scores tie often: the top-k keeps the lower flat
    index first, as lax.top_k does (tests/test_features.py:231)."""
    img = _u8((128, 128), 10)
    got = Orb(n_features=80, n_levels=3, score_type="fast_score") \
        .detect_and_compute(img, device=CPU)
    want = JOrb(n_features=80, n_levels=3, score_type="fast_score") \
        .detect_and_compute(img)
    _assert_same_orb(got, want)
    resp = [k.response for k in got[0]]
    assert len(set(resp)) < len(resp)  # the case has ties


@pytest.fixture(scope="module")
def rgb_batch():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 256, (64, 72, 3), dtype=np.uint8)
            for _ in range(4)]


def test_orb_batch_equals_jax_batch_and_per_image(rgb_batch):
    orb = Orb(n_features=60, n_levels=3)
    images = [zp.Image.from_numpy(a.copy(), device=CPU) for a in rgb_batch]
    got = orb.detect_and_compute_batch(images)
    want = JOrb(n_features=60, n_levels=3).detect_and_compute_batch(
        [jz.Image.from_numpy(a.copy()) for a in rgb_batch])
    assert len(got) == len(want) == 4
    for g, w, im in zip(got, want, images):
        _assert_same_orb(g, w)
        one = orb.detect_and_compute(im)
        assert [(a.x, a.y, a.angle, a.response, a.octave) for a in g[0]] == \
            [(b.x, b.y, b.angle, b.response, b.octave) for b in one[0]]
        for a, b in zip(g[1], one[1]):
            np.testing.assert_array_equal(a.bits, b.bits)


def test_orb_batch_of_device_images_and_arrays(rgb_batch):
    orb = Orb(n_features=40, n_levels=2)
    host = orb.detect_and_compute_batch(
        [zp.Image.from_numpy(a.copy(), device=CPU) for a in rgb_batch[:2]])
    # device-resident Images take the device gray conversion
    dev = orb.detect_and_compute_batch(
        [zp.Image._from_device(torch.from_numpy(a.copy()), "rgb")
         for a in rgb_batch[:2]])
    for a, b in zip(host, dev):
        assert [(k.x, k.y, k.angle) for k in a[0]] == \
            [(k.x, k.y, k.angle) for k in b[0]]
    # raw arrays take channel 0 and name their device
    raw = orb.detect_and_compute_batch(rgb_batch[:2], device=CPU)
    one = orb.detect_and_compute(rgb_batch[0][..., 0], device=CPU)
    assert [(k.x, k.y) for k in raw[0][0]] == [(k.x, k.y) for k in one[0]]
    with pytest.raises(ValueError, match="device"):
        orb.detect_and_compute_batch(rgb_batch[:2])
    with pytest.raises(ValueError, match="same-shape"):
        orb.detect_and_compute_batch(
            [rgb_batch[0], rgb_batch[1][:, :60]], device=CPU)
    assert orb.detect_and_compute_batch([]) == []


def test_host_gray_plane_is_the_device_plane_and_jax_s():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    base[0, 0], base[0, 1] = 0, 255
    orb, jorb_ = Orb(), JOrb()
    for arr in (base, np.concatenate([base, base[..., :1]], -1),
                base[..., :1]):
        im = zp.Image.from_numpy(arr.copy(), device=CPU)
        host = orb._plane_host_np(im)
        np.testing.assert_array_equal(host, im._gray_u8_plane().numpy())
        np.testing.assert_array_equal(
            host, jorb_._plane_host_np(jz.Image.from_numpy(arr.copy())))
    np.testing.assert_array_equal(orb._plane_host_np(base), base[..., 0])
    assert orb._plane_host_np(
        zp.Image._from_device(torch.from_numpy(base), "rgb")) is None


def test_pyramid_of_a_stack_is_per_plane():
    planes = _u8((3, 50, 60), 4)
    stack = ImagePyramid.build(torch.from_numpy(planes), 4, 1.3)
    for i in range(3):
        want = JPyramid.build(planes[i], 4, 1.3)
        for a, b in zip(stack.levels, want.levels):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))


# -- matcher and tracer -------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (3, 33), (65, 5), (40, 50)])
def test_distance_matrix_equals_jax_and_the_oracle(n, m):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    a[0] = 0
    got = distance_matrix(a, b, CPU)
    bits = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1)
    np.testing.assert_array_equal(got, bits.sum(axis=-1))
    np.testing.assert_array_equal(got, j_distances(a, b))
    assert got.dtype == np.int32
    assert distance_matrix(a[:0], b, CPU).shape == (0, m)


def test_distance_matrix_chunks_agree(monkeypatch):
    from zignal_tpu_torch.features import matcher

    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (20, 32), dtype=np.uint8)
    whole = distance_matrix(a, b, CPU)
    monkeypatch.setattr(matcher, "_CHUNK", 700)  # one query row a chunk
    np.testing.assert_array_equal(distance_matrix(a, b, CPU), whole)


def _matches(ms):
    return [(m.query_idx, m.train_idx, m.distance) for m in ms]


@pytest.mark.parametrize("cross_check,max_distance", [
    (False, None), (True, None), (True, 60), (False, 40)])
def test_matcher_equals_jax_on_orb_descriptors(wave_orb, cross_check,
                                               max_distance):
    img, (_, d1) = wave_orb
    _, d2 = JOrb(n_features=150, n_levels=4).detect_and_compute(
        np.roll(img, (3, 5), axis=(0, 1)))
    p = BruteForceMatcher(cross_check, max_distance, device=CPU)
    j = JMatcher(cross_check, max_distance)
    p1 = [BinaryDescriptor(d.bits.copy()) for d in d1]
    p2 = [BinaryDescriptor(d.bits.copy()) for d in d2]
    assert _matches(p.match(p1, p2)) == _matches(j.match(d1, d2))
    assert [_matches(r) for r in p.knn_match(p1, p2, k=3)] == \
        [_matches(r) for r in j.knn_match(d1, d2, k=3)]
    assert [_matches(r) for r in p.radius_match(p1, p2, 70)] == \
        [_matches(r) for r in j.radius_match(d1, d2, 70)]
    assert p.stats(p.match(p1, p2)) == \
        type(p.stats([]))(*j.stats(j.match(d1, d2)).__dict__.values())


def test_matcher_ties_and_empty_sets():
    d = []
    for val in (0x00, 0xFF, 0x0F, 0x00):
        b = BinaryDescriptor()
        b.bits[:] = val
        d.append(b)
    m = BruteForceMatcher(device=CPU)
    knn = m.knn_match([d[0]], d, k=2)
    assert [(x.train_idx, x.distance) for x in knn[0]] == [(0, 0.0), (3, 0.0)]
    assert {x.train_idx for x in m.radius_match([d[0]], d, 130)[0]} == \
        {0, 2, 3}
    assert m.match([], d) == [] and m.match(d, []) == []


@pytest.mark.parametrize("case", ["line", "l_shape", "noise"])
def test_tracer_copy_equals_jax(case):
    edges = np.zeros((32, 32), dtype=np.uint8)
    if case == "line":
        edges[5, 2:30] = 255
    elif case == "l_shape":
        edges[5, 5:20] = 255
        edges[5:20, 19] = 255
    else:
        edges = (_u8((32, 32), 7) > 200).astype(np.uint8) * 255
    want = JTracer(min_length=4).trace(edges)
    assert Tracer(min_length=4).trace(edges) == want
    assert Tracer(min_length=4).trace(
        zp.Image.from_numpy(edges[..., None].copy(), device=CPU)) == want


if __name__ == "__main__":
    # the angle differences quoted in this file's docstring
    import jax

    jax.config.update("jax_platforms", "cpu")
    for img, kw in ((_wave(), dict(n_features=150, n_levels=4)),
                    (_u8((96, 96), 9), dict(n_features=60, n_levels=3)),
                    (_u8((128, 128), 10), dict(n_features=80, n_levels=3,
                                               score_type="fast_score"))):
        got = Orb(**kw).detect_and_compute(img, device=CPU)[0]
        want = JOrb(**kw).detect_and_compute(img)[0]
        errs = [abs(a.angle - b.angle) for a, b in zip(got, want)]
        print(f"{img.shape} {kw}: {len(got)} keypoints, "
              f"{sum(e > 0 for e in errs)} angles differ, max "
              f"{max(errs):.3g} degrees")
