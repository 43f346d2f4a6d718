"""The port's geometry (zignal_tpu_torch/geometry/, copied host numpy) and
RunningStats against zignal_tpu's: the three transforms' ``find``,
``project``, ``inverse`` and ``homogeneous``, and ConvexHull, all equal
(the same f64 numpy arithmetic on both sides)."""

import numpy as np
import pytest

import zignal_tpu as jz
from zignal_tpu.stats import RunningStats as JRunningStats

import zignal_tpu_torch as zp

KINDS = {"SimilarityTransform": 2, "AffineTransform": 3,
         "ProjectiveTransform": 4}


def _points(n, seed):
    rng = np.random.default_rng(seed)
    src = [tuple(p) for p in rng.uniform(-50, 150, (n, 2)).tolist()]
    dst = [tuple(p) for p in rng.uniform(-50, 150, (n, 2)).tolist()]
    return src, dst


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_find_and_project_match_jax(kind, extra):
    src, dst = _points(KINDS[kind] + extra, len(kind) + extra)
    p, j = getattr(zp, kind)(src, dst), getattr(jz, kind)(src, dst)
    assert np.array_equal(p.homogeneous(), j.homogeneous())
    assert repr(p) == repr(j)
    probe = [(0.0, 0.0), (17.5, -3.25), (120.0, 80.0)]
    assert p.project(probe) == j.project(probe)
    assert p.project((4.0, 9.0)) == j.project((4.0, 9.0))
    # find() refits in place
    src2, dst2 = _points(KINDS[kind] + 1, 99)
    p.find(src2, dst2)
    j.find(src2, dst2)
    assert np.array_equal(p.homogeneous(), j.homogeneous())


def test_projective_inverse_matches_jax():
    src, dst = _points(4, 5)
    p = zp.ProjectiveTransform(src, dst).inverse()
    j = jz.ProjectiveTransform(src, dst).inverse()
    assert np.array_equal(p.homogeneous(), j.homogeneous())
    back = p.project(zp.ProjectiveTransform(src, dst).project(src))
    assert np.allclose(back, src, atol=1e-6)


@pytest.mark.parametrize("kind,f,t", [
    ("SimilarityTransform", [(0, 0), (0, 0)], [(1, 1), (1, 1)]),
    ("AffineTransform", [(0, 0), (1, 0), (2, 0)], [(0, 0), (1, 0), (2, 0)]),
    ("ProjectiveTransform", [(0, 0), (1, 0), (2, 0), (3, 0)],
     [(0, 0), (1, 0), (2, 0), (3, 0)]),
])
def test_rank_deficient_fits_raise_as_in_jax(kind, f, t):
    with pytest.raises(ValueError, match="rank deficient"):
        getattr(zp, kind)(f, t)
    with pytest.raises(ValueError, match="rank deficient"):
        getattr(jz, kind)(f, t)


@pytest.mark.parametrize("seed", range(4))
def test_convex_hull_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = [tuple(p) for p in rng.uniform(0, 100, (30 + seed, 2)).tolist()]
    p, j = zp.ConvexHull(), jz.ConvexHull()
    assert p.find(pts) == j.find(pts)
    assert p.contains((50.0, 50.0)) == j.contains((50.0, 50.0))
    assert p.contains((-1.0, 50.0)) == j.contains((-1.0, 50.0))
    pr, jr = p.get_rectangle(), j.get_rectangle()
    assert (pr.left, pr.top, pr.right, pr.bottom) == \
        (jr.left, jr.top, jr.right, jr.bottom)
    assert isinstance(pr, zp.Rectangle)


def test_convex_hull_degenerate_inputs_match_jax():
    p, j = zp.ConvexHull(), jz.ConvexHull()
    assert repr(p) == repr(j)
    for pts in ([], [(0, 0)], [(0, 0), (1, 1)], [(0, 0), (1, 1), (2, 2)]):
        assert p.find(pts) is None and j.find(pts) is None
    assert p.get_rectangle() is None
    with pytest.raises(TypeError):
        p.find("not a sequence")


def test_running_stats_match_jax():
    rng = np.random.default_rng(6)
    a, b = rng.normal(3.0, 2.0, 200), rng.normal(-1.0, 0.5, 57)
    pa, pb, ja, jb = (zp.RunningStats(), zp.RunningStats(), JRunningStats(),
                      JRunningStats())
    pa.extend(a)
    pb.extend(b)
    ja.extend(a)
    jb.extend(b)
    for p, j in ((pa, ja), (pa.combine(pb), ja.combine(jb))):
        for name in ("count", "sum", "mean", "variance", "std_dev", "min",
                     "max", "skewness", "ex_kurtosis"):
            assert getattr(p, name) == getattr(j, name), name
        assert p.scale(1.5) == j.scale(1.5)
        assert repr(p) == repr(j)
    with pytest.raises(TypeError):
        pa.combine(ja)
