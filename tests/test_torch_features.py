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
  ``radius_match`` (with ``cross_check``): equal;
- ``Orb.detect_and_compute_tensors``: the batch entry's keypoints and
  descriptors, and JAX's, on a stack of 4 frames; ``match_tensors``:
  numpy's rules of ``BruteForceMatcher.match`` (ties, cross-check,
  ``max_distance``, rows not valid, empty sets), equal;
- the orb_stereo request at toy size against the benchmark's frozen
  reference, under the configuration's limits.
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
from zignal_tpu_torch.features.matcher import distance_matrix, match_tensors
from zignal_tpu_torch.ops import orb_describe, orb_detect
from zignal_tpu_torch.ops.fma import fma
from zignal_tpu_torch.ops.pyramid import ImagePyramid

import _orb_atlas_cases as oc

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


def _numpy_match(d, cross_check, max_distance):
    """``BruteForceMatcher.match``'s numpy rules on a distance matrix:
    (query, train, distance) of each kept query."""
    if d.size == 0:
        return []
    best, rev = d.argmin(axis=1), d.argmin(axis=0)
    out = []
    for qi, ti in enumerate(best):
        dist = int(d[qi, ti])
        if max_distance is not None and dist > max_distance:
            continue
        if cross_check and rev[ti] != qi:
            continue
        out.append((qi, int(ti), dist))
    return out


def _tied_descriptors(rng, n):
    """u8 ``[n, 32]`` drawn from a pool of 6 rows: distances tie often."""
    pool = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    return pool[rng.integers(0, 6, n)]


@pytest.mark.parametrize("cross_check,max_distance", [
    (True, None), (False, None), (True, 120), (False, 100)])
@pytest.mark.parametrize("n,m", [(7, 9), (30, 5), (1, 40), (0, 4), (5, 0)])
def test_match_tensors_follow_numpys_rules(n, m, cross_check, max_distance):
    """Three pairs at once, each with rows not valid; every pair equals
    numpy's rules on its valid rows alone, mapped back to the rows'
    places, and the matcher's single pair goes through it."""
    rng = np.random.default_rng(n * 100 + m)
    q = np.stack([_tied_descriptors(rng, n) for _ in range(3)])
    t = np.stack([_tied_descriptors(rng, m) for _ in range(3)])
    qv = rng.random((3, n)) < 0.8
    tv = rng.random((3, m)) < 0.7
    qv[0], tv[0] = True, True  # one pair all valid
    if m:
        tv[2] = False          # one pair with no valid train row
    idx, dist = match_tensors(torch.from_numpy(q), torch.from_numpy(qv),
                              torch.from_numpy(t), torch.from_numpy(tv),
                              cross_check=cross_check,
                              max_distance=max_distance)
    assert idx.dtype == torch.int64 and dist.dtype == torch.int32
    assert idx.shape == dist.shape == (3, n)
    for p in range(3):
        qi, ti = np.nonzero(qv[p])[0], np.nonzero(tv[p])[0]
        d = distance_matrix(q[p][qi], t[p][ti], CPU)
        want_idx, want_dist = np.full(n, -1), np.full(n, -1)
        for a, b, dd in _numpy_match(d, cross_check, max_distance):
            want_idx[qi[a]], want_dist[qi[a]] = ti[b], dd
        np.testing.assert_array_equal(idx[p].numpy(), want_idx)
        np.testing.assert_array_equal(dist[p].numpy(), want_dist)
    matcher = BruteForceMatcher(cross_check, max_distance, device=CPU)
    got = matcher.match([BinaryDescriptor(r) for r in q[0]],
                        [BinaryDescriptor(r) for r in t[0]])
    assert _matches(got) == [
        (a, b, float(dd)) for a, b, dd in _numpy_match(
            distance_matrix(q[0], t[0], CPU), cross_check, max_distance)]


def test_match_tensors_ties_go_to_the_lowest_row():
    """Equal train rows: the first is the match; equal queries: the
    cross-check keeps the first."""
    a = np.zeros((3, 32), np.uint8)
    a[2] = 255
    q, t = torch.from_numpy(a[None]), torch.from_numpy(a[[0, 0, 2]][None])
    ones = torch.ones((1, 3), dtype=torch.bool)
    idx, dist = match_tensors(q, ones, t, ones)
    assert idx.tolist() == [[0, -1, 2]] and dist.tolist() == [[0, -1, 0]]
    idx, _ = match_tensors(q, ones, t, ones, cross_check=False)
    assert idx.tolist() == [[0, 0, 2]]
    with pytest.raises(ValueError, match="validity"):
        match_tensors(q, ones[:, :2], t, ones)


def _stack(seed, n=4, shape=(96, 160)):
    """A stack of ``n`` textured frames."""
    return np.stack([_wave(*shape, seed=seed + i) for i in range(n)])


def test_detect_and_compute_tensors_equals_the_batch_and_jax():
    """The tensors hold exactly the batch entry's keypoints (on their
    level, with the level) and descriptors, and JAX's."""
    frames = _stack(31)
    orb = Orb(n_features=300, edge_threshold=31)
    kps, desc, valid = orb.detect_and_compute_tensors(torch.from_numpy(frames))
    ks, _ = orb._fused_params(96, 160)
    assert kps.shape == (4, sum(ks), 5) and desc.shape == (4, sum(ks), 32)
    assert valid.dtype == torch.bool and desc.dtype == torch.uint8
    batch = orb.detect_and_compute_batch(list(frames), device=CPU)
    jorb = JOrb(n_features=300, edge_threshold=31)
    for f in range(4):
        rows, bits = kps[f][valid[f]], desc[f][valid[f]]
        got = ([KeyPoint(x=float(r[1]) * 1.2 ** int(r[4]),
                         y=float(r[2]) * 1.2 ** int(r[4]),
                         size=7.0 * 1.2 ** int(r[4]), angle=float(r[3]),
                         response=float(r[0]), octave=int(r[4]))
                for r in rows], [BinaryDescriptor(b) for b in bits.numpy()])
        assert [(k.x, k.y, k.octave, k.angle, k.response) for k in got[0]] \
            == [(k.x, k.y, k.octave, k.angle, k.response)
                for k in batch[f][0]]
        _assert_same_orb(got, batch[f])
        _assert_same_orb(got, jorb.detect_and_compute(frames[f]))
    with pytest.raises(ValueError, match="u8"):
        orb.detect_and_compute_tensors(torch.from_numpy(frames[0]))
    # planes under 16 px keep no level: no rows
    kps, desc, valid = orb.detect_and_compute_tensors(
        torch.from_numpy(frames[:, :12, :15].copy()))
    assert (kps.shape, desc.shape, valid.shape) == ((4, 0, 5), (4, 0, 32),
                                                    (4, 0))


def test_orb_stereo_request_is_held_to_its_reference():
    """The benchmark's request at its toy size on the CPU, on the
    source's stereo frames and on noise, against the frozen reference
    under the configuration's limits; the matches exact."""
    import json
    from pathlib import Path

    from benchmarks.reference import orb_stereo as ref
    from benchmarks.sources import device_stereo

    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "benchmarks" / "configs" /
                      "orb_stereo.json").read_text())
    cfg = dict(cfg, **cfg["toy"])
    orb = Orb(n_features=cfg["n_features"],
              edge_threshold=cfg["edge_threshold"])
    gen = torch.Generator().manual_seed(2 ** 40 + 3)
    for x in (device_stereo.frames((4, cfg["rows"], cfg["cols"]), gen,
                                   torch.device(CPU)),
              torch.from_numpy(_u8((2, cfg["rows"], cfg["cols"]), 5))):
        kps, desc, valid = orb.detect_and_compute_tensors(x)
        out = (kps, desc, valid, match_tensors(desc[0::2], valid[0::2],
                                               desc[1::2], valid[1::2]))
        checks = ref.compare(cfg, out, ref.orb_stereo(x, cfg))
        assert checks["matches_differing"] == 0
        assert checks["keypoints_differing"] == 0
        assert checks["descriptor_bits_differing"] == 0
        assert 0 < checks["angle_max_gap_deg"] <= cfg["limits"][
            "angle_max_gap_deg"]
        assert int((out[3][0] >= 0).sum()) > 0


# csrc/orb_detect.cu's schedule: its tile, FAST's ring, the NMS's reach
_TH, _TW = orb_detect.TILE
_RING, _NEAR = 3, 4
_HALO = _RING + _NEAR


def _emulate_detect(plane, levels, n, harris):
    """The detect kernel transcribed in numpy, block by block: the levels
    that meet the tile and its NMS halo; the u8 tile staged with a 7-px
    halo, 0 off the plane; FAST over the tile and a 4-px halo on each
    level's 3-px interior; the NMS over the 68 neighbours; Harris from
    integer window sums on the kept pixels of each level's 4-px interior;
    each level's pixels written at their place in level order. A
    candidate no block writes stays NaN."""
    b, hh, ww = plane.shape
    out = np.full((b, n), np.nan, np.float32)
    f32, f64 = np.float32, np.float64
    sr, sc = _TH + 2 * _NEAR, _TW + 2 * _NEAR
    for z, y0, x0 in np.ndindex(b, -(-hh // _TH), -(-ww // _TW)):
        y0, x0 = y0 * _TH, x0 * _TW

        def meets(pad):
            return [lv for lv in levels if lv[0] < y0 + _TH + pad
                    and lv[0] + lv[2] > y0 - pad and lv[1] < x0 + _TW + pad
                    and lv[1] + lv[3] > x0 - pad]

        if not meets(0):
            continue
        src = np.zeros((_TH + 2 * _HALO, _TW + 2 * _HALO), np.int32)
        ys, xs = max(y0 - _HALO, 0), max(x0 - _HALO, 0)
        part = plane[z, ys:y0 + _TH + _HALO, xs:x0 + _TW + _HALO]
        src[ys - (y0 - _HALO):ys - (y0 - _HALO) + part.shape[0],
            xs - (x0 - _HALO):xs - (x0 - _HALO) + part.shape[1]] = part
        gy, gx = np.mgrid[y0 - _NEAR:y0 + _TH + _NEAR,
                          x0 - _NEAR:x0 + _TW + _NEAR]
        thr = np.full(gy.shape, -1)
        for r, c, h, w, t, _ in meets(_NEAR):
            thr[(gy >= r + 3) & (gy < r + h - 3) & (gx >= c + 3)
                & (gx < c + w - 3)] = t
        v = src[_RING:_RING + sr, _RING:_RING + sc]
        hi, lo = np.minimum(v + thr, 255), np.maximum(v - thr, 0)
        bright = dark = score = 0
        for k, (dx, dy) in enumerate(pfast.CIRCLE_OFFSETS):
            tap = src[_RING + dy:_RING + dy + sr, _RING + dx:_RING + dx + sc]
            bright = bright | (tap > hi).astype(np.int64) << k
            dark = dark | (tap < lo).astype(np.int64) << k
            d = np.abs(tap - v)
            score = score + np.where(d > thr, d, 0)

        def run9(m):
            r = m | m << 16
            for step in (1, 2, 4, 1):
                r = r & (r >> step)
            return r != 0

        score = np.where((thr >= 0) & (run9(bright) | run9(dark)), score, 0)
        s = score[_NEAR:_NEAR + _TH, _NEAR:_NEAR + _TW]
        best = np.zeros_like(s)
        for dx, dy in pfast._NEAR:
            best = np.maximum(best, score[_NEAR + dy:_NEAR + dy + _TH,
                                          _NEAR + dx:_NEAR + dx + _TW])
        keep = (s > 0) & (s >= best)
        ddx = src[1:-1, 2:] - src[1:-1, :-2]
        ddy = src[2:, 1:-1] - src[:-2, 1:-1]
        sums = []
        for prod in (ddx * ddx, ddy * ddy, ddx * ddy):
            o = _HALO - 1 - 3
            sums.append(sum(prod[o + i:o + i + _TH, o + j:o + j + _TW]
                            for i in range(7) for j in range(7)))
        ixx, iyy, ixy = (f32(x) * f32(0.25) for x in sums)
        det = f32(f64(ixx) * f64(iyy) + f64(-(ixy * ixy)))
        trace = ixx + iyy
        resp = f32(f64(-(f32(0.04) * trace)) * f64(trace) + f64(det))
        ty, tx = np.mgrid[y0:y0 + _TH, x0:x0 + _TW]
        for r, c, h, w, _, start in meets(0):
            inside = (ty >= r) & (ty < r + h) & (tx >= c) & (tx < c + w)
            deep = (ty >= r + 4) & (ty < r + h - 4) & (tx >= c + 4) & \
                (tx < c + w - 4)
            value = np.where(deep, resp, f32(0)) if harris else \
                s.astype(np.float32)
            value = np.where(keep, value, -np.inf).astype(np.float32)
            at = start + (ty - r) * w + (tx - c)
            out[z, at[inside]] = value[inside]
    return out


@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("name", oc.SMALL)
def test_detect_kernel_schedule_equals_the_plain_route(name, harris):
    """The detect kernel's schedule, transcribed in numpy, writes every
    candidate and gives the plain route's, bit for bit, on every case of
    ``_orb_atlas_cases`` small enough for the CPU: empty shelf space,
    one level, a flat frame, pixels planted at a level's edges and next
    to another level, arcs of 9 taps wrapping past tap 15."""
    atlas, plane = oc.case(name, CPU)
    want = atlas.candidates(plane, harris).numpy()
    got = _emulate_detect(plane.numpy(), atlas.levels, atlas.n, harris)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == "flat":
        assert np.isneginf(want).all()
    else:
        assert np.isfinite(want).sum() > 0


def test_detect_on_the_cpu_takes_the_plain_route_and_the_kernel_checks():
    """A CPU plane runs the plain route (no launch); the kernel's wrapper
    raises on a plane it does not take, before it looks for a card."""
    atlas, plane = oc.case("planted", CPU)
    before = orb_detect.LAUNCHES
    assert torch.equal(atlas.candidates(plane, True),
                       atlas.candidates_reference(plane, True))
    frames = torch.from_numpy(_stack(31))
    Orb(n_features=300).detect_and_compute_tensors(frames)
    assert orb_detect.LAUNCHES == before
    args = (atlas.levels, atlas.n, True)
    with pytest.raises(ValueError, match="uint8"):
        orb_detect.candidates(plane.to(torch.int32), *args)
    with pytest.raises(ValueError, match="uint8"):
        orb_detect.candidates(plane[0], *args)
    with pytest.raises(ValueError, match="contiguous"):
        orb_detect.candidates(plane.transpose(1, 2), *args)
    with pytest.raises(TypeError):
        orb_detect.candidates(plane.numpy(), *args)
    with pytest.raises(ValueError, match="no kernel"):
        orb_detect.candidates(plane, *args)
    assert orb_detect.LAUNCHES == before


def test_detect_plan_refuses_tables_the_kernel_cannot_take():
    """The plan checks the level table against the plane and the
    candidates: a level past the plane, past the candidates, or more
    levels than the parameter struct holds."""
    atlas, _ = oc.case("planted", CPU)
    (h, w), lv = atlas.shape, atlas.levels
    plan = orb_detect._DetectPlan(2, h, w, atlas.n, lv)
    assert len(plan.pack().raw) == 4 * (len(orb_detect._FIELDS)
                                        + 6 * orb_detect.MAX_LEVELS)
    bad = ((h - 10, 0, 11, 5, 20, 0),)
    for table, n in ((bad, atlas.n), (lv, atlas.n - 1),
                     (lv * 5, atlas.n * 5), ((), 0)):
        with pytest.raises(ValueError):
            orb_detect._DetectPlan(2, h, w, n, table)


def _emulate_describe(plane, resp, idx, table):
    """The describe kernel transcribed in numpy, for all keypoints at
    once: each keypoint's window of radius REACH staged, 0 off its level;
    the moments of the circular patch as integer sums; the angle from f32
    quotients, atan2 in f64 rounded to f32, times f32(180 / pi), 0 where
    m00 < 0.001; each rotated sample's two multiply-adds in f64, rounded
    to f32, then half to even; a sample read from the window, or from the
    plane where it lies outside it; the bits packed as the warp's 8
    ballots, bit i of word q pair 32 q + i. The transcendentals are
    torch's f64 ones, as the kernel's are the card's (numpy's differ).
    Returns the rows, descriptors and validity, and the number of samples
    that counted and were read from the plane."""
    f32, f64, r, half = np.float32, np.float64, orb_describe.REACH, \
        orb_describe.HALF
    lv, r0, c0, h, w, lo, x_end, y_end = table.T.astype(np.int64)
    y, x = idx // w, idx % w
    zb = np.arange(plane.shape[0])[:, None]

    def at(ys, xs):  # level pixels (ys, xs), [B, K, ...], clamped
        ys = np.clip(ys, 0, h[:, None] - 1) + r0[:, None]
        xs = np.clip(xs, 0, w[:, None] - 1) + c0[:, None]
        return plane[zb[..., None], ys, xs].astype(np.int64)

    off = np.arange(-r, r + 1)
    wy, wx = (np.repeat(off, off.size)[None, None],
              np.tile(off, off.size)[None, None])
    ly, lx = y[..., None] + wy, x[..., None] + wx
    inside = (ly >= 0) & (ly < h[:, None]) & (lx >= 0) & (lx < w[:, None])
    win = np.where(inside, at(ly, lx), 0)
    circle = (wy ** 2 + wx ** 2 <= half ** 2) & (np.abs(wy) <= half) & \
        (np.abs(wx) <= half)
    m00, m10, m01 = ((win * circle * m).sum(-1) for m in (1, wx, wy))
    assert max(abs(m).max() for m in (m00, m10, m01)) < 2 ** 31
    f00 = m00.astype(f32)
    safe = np.maximum(f00, f32(1e-6))
    ratio = [torch.from_numpy((m.astype(f32) / safe).astype(f64))
             for m in (m01, m10)]
    angle = torch.atan2(*ratio).numpy().astype(f32) * f32(180.0 / np.pi)
    angle = np.where(f00 < f32(0.001), f32(0), angle).astype(f32)
    rad = torch.from_numpy((angle * f32(np.pi / 180.0)).astype(f64))
    ca, sa = (fn(rad).numpy().astype(f32)[..., None]
              for fn in (torch.cos, torch.sin))
    kx, ky = x.astype(f32)[..., None], y.astype(f32)[..., None]

    def fma64(a, b, c):
        return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)

    pat = orb_describe.PAIRS.astype(f32)
    bits, outside = True, False
    for px, py, slot in ((pat[:, 0], pat[:, 1], 0), (pat[:, 2], pat[:, 3],
                                                      1)):
        rx = np.rint(fma64(-sa, py, fma64(ca, px, kx))).astype(np.int64)
        ry = np.rint(fma64(ca, py, fma64(sa, px, ky))).astype(np.int64)
        bits = bits & (rx >= 0) & (rx < w[:, None]) & (ry >= 0) & \
            (ry < h[:, None])
        vy, vx = ry - y[..., None] + r, rx - x[..., None] + r
        near = (vy >= 0) & (vy <= 2 * r) & (vx >= 0) & (vx <= 2 * r)
        cell = np.clip(vy, 0, 2 * r) * (2 * r + 1) + np.clip(vx, 0, 2 * r)
        sample = np.where(near, np.take_along_axis(win, cell, -1),
                          at(ry, rx))
        outside = outside | ~near
        if slot == 0:
            first = sample
    bits_ok = bits
    bits = bits & (first < sample)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype("<u4")
    rows = np.stack([resp, x.astype(f32), y.astype(f32), angle,
                     np.broadcast_to(lv.astype(f32), resp.shape)], -1)
    valid = np.isfinite(resp) & (x >= lo) & (x < x_end) & (y >= lo) & \
        (y < y_end)
    return rows.astype(f32), words.view(np.uint8), valid, \
        int((outside & bits_ok).sum())


@pytest.mark.parametrize("name", oc.SMALL + oc.PLACED)
def test_describe_kernel_schedule_equals_the_plain_route(name):
    """The describe kernel's schedule, transcribed in numpy, gives the
    plain route's rows, descriptors and validity bit for bit on every row,
    valid or not: the keypoints chosen on the small cases of
    ``_orb_atlas_cases`` (pixels planted next to a level's edge and next
    to another level, shelves with empty space, the top-k's -inf padding),
    keypoints anywhere on their levels, 40 levels, and samples past the
    window on a level wider than 2^20 px."""
    atlas, plane, resp, idx = oc.keypoints(name, CPU)
    want = atlas.describe(plane, resp, idx)
    got = _emulate_describe(plane.numpy(), resp.numpy(), idx.numpy(),
                            atlas.table.tensor.numpy())
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    x, y, w = want[0][..., 1], want[0][..., 2], atlas.table.tensor[:, 4]
    edge = (x < orb_describe.REACH) | (y < orb_describe.REACH) | \
        (x >= w - orb_describe.REACH)
    assert bool(edge.any()) != (name == "wide")
    assert (got[3] > 0) == (name == "wide")
    if name == "flat" or name in oc.PLACED:
        assert bool(torch.isneginf(resp).any())


def test_describe_window_covers_every_rotated_sample():
    """REACH, derived from the pattern, holds every rounded rotated sample
    of BRIEF (the plain route's arithmetic) at every angle step of 0.02
    degrees and at keypoints from 0 to 2^19, and some sample reaches it;
    it covers the orientation patch. Near 2^20 the f32 spacing moves a
    sample past it: the kernel reads such a sample from the plane."""
    assert orb_describe.HALF == porb._HALF
    assert orb_describe.REACH >= porb._HALF
    assert orb_describe.PAIRS.tolist() == [list(p) for p in ORB_PATTERN]
    angles = torch.cat([torch.arange(-180.0, 180.0, 0.02),
                        torch.tensor([180.0])]).to(torch.float32)
    rad = angles * np.float32(np.pi / 180.0)
    cos_a = porb._f32_of_f64(torch.cos, rad)[:, None]
    sin_a = porb._f32_of_f64(torch.sin, rad)[:, None]
    pat = torch.from_numpy(orb_describe.PAIRS.astype(np.float32))
    def reach(k):
        kk = torch.tensor(k, dtype=torch.float32)
        most = 0.0
        for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
            rx = torch.round(fma(-sin_a, py, fma(cos_a, px, kk)))
            ry = torch.round(fma(cos_a, py, fma(sin_a, px, kk)))
            most = max(most, float((rx - kk).abs().max()),
                       float((ry - kk).abs().max()))
        return most

    assert [reach(k) for k in (0.0, 17.0, 1240.0, 65535.0, 2.0 ** 19 - 1)] \
        == [orb_describe.REACH] * 5
    assert reach(2.0 ** 20 - 1) > orb_describe.REACH


def test_describe_on_the_cpu_takes_the_plain_route_and_the_kernel_checks():
    """A CPU plane runs the plain route (no launch); the kernel's wrapper
    raises on a plane or rows it does not take, before it looks for a
    card."""
    atlas, plane, resp, idx = oc.keypoints("planted", CPU)
    before = orb_describe.LAUNCHES
    for a, b in zip(atlas.describe(plane, resp, idx),
                    atlas.describe_reference(plane, resp, idx)):
        assert torch.equal(a, b)
    Orb(n_features=300).detect_and_compute_tensors(
        torch.from_numpy(_stack(31)))
    assert orb_describe.LAUNCHES == before
    args = (resp, idx, atlas.table)
    with pytest.raises(ValueError, match="uint8"):
        orb_describe.describe(plane.to(torch.int32), *args)
    with pytest.raises(ValueError, match="uint8"):
        orb_describe.describe(plane[0], *args)
    with pytest.raises(ValueError, match="contiguous"):
        orb_describe.describe(plane.transpose(1, 2), *args)
    with pytest.raises(TypeError):
        orb_describe.describe(plane.numpy(), *args)
    with pytest.raises(ValueError, match="no kernel"):
        orb_describe.describe(plane, *args)
    t = atlas.table
    taller = orb_describe.RowTable(t.tensor.numpy(), (t.hw[0] + 1, t.hw[1]),
                                   CPU)
    for bad in ((resp.double(), idx, t), (resp, idx.to(torch.int32), t),
                (resp[:1], idx, t), (resp, idx, t.tensor),
                (resp, idx, taller)):
        with pytest.raises(ValueError, match="contiguous|RowTable"):
            orb_describe._check_rows(plane, *bad)
    assert orb_describe.LAUNCHES == before


@pytest.mark.parametrize("field,value,inside", [
    ("row", lambda h, w, lh, lw: h - lh, True),
    ("col", lambda h, w, lh, lw: w - lw, True),
    ("row", lambda h, w, lh, lw: h - lh + 1, False),
    ("col", lambda h, w, lh, lw: w - lw + 1, False),
    ("row", lambda h, w, lh, lw: -1, False),
    ("col", lambda h, w, lh, lw: -1, False),
    ("h", lambda h, w, lh, lw: 0, False),
    ("w", lambda h, w, lh, lw: 0, False),
], ids=["bottom_edge", "right_edge", "past_bottom", "past_right",
        "above", "left", "no_rows", "no_cols"])
def test_describe_row_table_refuses_a_level_outside_the_plane(field, value,
                                                              inside):
    """The describe kernel's row table is checked on the host as it is
    built: a level that touches the plane's bottom or right edge is
    taken, one that lies past it, at a negative place or of no size is
    refused, so the kernel reads nothing outside the plane."""
    atlas, _ = oc.case("shelves", CPU)
    rows = atlas.table.tensor.numpy().astype(np.int64)
    (h, w), j = atlas.table.hw, len(rows) // 2
    col = 1 + ("row", "col", "h", "w").index(field)
    rows[j, col] = value(h, w, rows[j, 3], rows[j, 4])
    if inside:
        got = orb_describe.RowTable(rows, (h, w), CPU)
        assert torch.equal(got.tensor, torch.from_numpy(rows.astype(np.int32)))
    else:
        with pytest.raises(ValueError, match="outside"):
            orb_describe.RowTable(rows, (h, w), CPU)


def test_describe_row_table_refuses_rows_of_another_form():
    """The row table takes integer rows of 8 values that fit int32."""
    atlas, _ = oc.case("shelves", CPU)
    rows, hw = atlas.table.tensor.numpy(), atlas.table.hw
    big = rows.astype(np.int64)
    big[0, 5] = 2 ** 31
    for bad in (rows[:, :6], rows.astype(np.float64), big, rows[0]):
        with pytest.raises(ValueError, match="int32 rows"):
            orb_describe.RowTable(bad, hw, CPU)


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
