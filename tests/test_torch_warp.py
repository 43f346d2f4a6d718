"""The Image / ImageBatch members on the port's geometric sampling
(ops/warp.py): rotate, crop, extract, insert and warp, against zignal_tpu
on JAX-CPU, with ``device="cpu"`` on the port's side
(tests/test_torch_sample.py holds ``sample`` itself).

Bounds: every u8 and f32 output is held equal, except a warp with a kernel
method (BICUBIC, CATMULL_ROM, MITCHELL, LANCZOS). There the JAX package
computes the coordinates on the device, the port on the host (its static
route), and JAX's own two routes differ by at most 1 at under 1 % of
pixels (tests/test_transforms.py:387-417): that is the bound here.
"""

import math

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.enums import BorderMode as JB
from zignal_tpu.enums import Interpolation as JI
from zignal_tpu.ops import warp as jw

import zignal_tpu_torch as zp
from zignal_tpu_torch import BorderMode, Interpolation
from zignal_tpu_torch.ops import warp as pw

CPU = "cpu"
METHODS = [m.name for m in Interpolation]
KERNEL_METHODS = ["BICUBIC", "CATMULL_ROM", "MITCHELL", "LANCZOS"]
BORDERS = [b.name for b in BorderMode]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _f32(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape) + rng.random(shape)).astype(
        np.float32)


def _np(x):
    if isinstance(x, (zp.Image, zp.ImageBatch, jz.Image, jz.ImageBatch)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _equal(p, j):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape and p.dtype == j.dtype
    assert np.array_equal(p, j), f"{int((p != j).sum())} values differ"


def _within_one(p, j):
    d = np.abs(_np(p).astype(np.int64) - _np(j).astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


# -- rotate ---------------------------------------------------------------------

def _pair(arr):
    return (zp.Image.from_numpy(arr.copy(), device=CPU),
            jz.Image.from_numpy(arr.copy()))


QUARTERS = [0.0, math.pi / 2, math.pi, 3 * math.pi / 2, 2 * math.pi,
            -math.pi / 2]


@pytest.mark.parametrize("angle", QUARTERS)
def test_rotate_quarter_turns_are_exact_and_match_jax(angle):
    p, j = _pair(_u8((17, 23, 3), 7))
    got = p.rotate(angle)
    _equal(got, j.rotate(angle))
    assert (got.rows, got.cols) == pw.rotate_bounds(17, 23, angle)


@pytest.mark.parametrize("method", METHODS)
def test_rotate_oblique_matches_jax(method):
    p, j = _pair(_u8((30, 41, 3), 8))
    _equal(p.rotate(0.5, Interpolation[method]),
           j.rotate(0.5, JI[method]))


@pytest.mark.parametrize("border", BORDERS)
def test_rotate_with_each_border_matches_jax(border):
    p, j = _pair(_u8((26, 34, 4), 9))
    _equal(p.rotate(-1.2, Interpolation.BILINEAR, BorderMode[border]),
           j.rotate(-1.2, JI.BILINEAR, JB[border]))


def test_rotate_f32_kernel_weights_fold_as_jax_does():
    """rotate's coordinates are constants of JAX's compiled program, so
    XLA folds the kernel weights (each op rounded alone) and divides by
    their constant sum as a multiplication: the f32 output is equal."""
    arr = _f32((24, 32, 3), 10)
    rows, cols = pw.rotate_bounds(24, 32, 0.7)
    for method in ("BICUBIC", "MITCHELL"):
        want = jw.rotate(arr, 0.7, rows, cols, JI[method], JB.REPLICATE)
        got = pw.rotate(torch.from_numpy(arr), 0.7, rows, cols,
                        Interpolation[method], BorderMode.REPLICATE)
        _equal(got, want)


def test_rotate_of_a_one_pixel_row_under_mirror_matches_jax():
    p, j = _pair(_u8((1, 30, 3), 11))
    _equal(p.rotate(0.3, Interpolation.BILINEAR, BorderMode.MIRROR),
           j.rotate(0.3, JI.BILINEAR, JB.MIRROR))


def test_rotate_rejects_a_non_finite_angle():
    p, _ = _pair(_u8((8, 8, 3), 0))
    with pytest.raises(ValueError):
        p.rotate(float("nan"))
    with pytest.raises(ValueError):
        zp.ImageBatch(_u8((1, 8, 8, 3), 0), device=CPU).rotate(float("inf"))


# -- extract and crop --------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_extract_with_an_angle_matches_jax(method):
    p, j = _pair(_u8((32, 40, 3), 12))
    rect = (4.5, 3.0, 33.0, 27.5)
    _equal(p.extract(rect, 0.35, (18, 25), Interpolation[method]),
           j.extract(rect, 0.35, (18, 25), JI[method]))


@pytest.mark.parametrize("size", [None, 9, (1, 1), (1, 12), (14, 1)])
def test_extract_sizes_match_jax(size):
    p, j = _pair(_u8((24, 30, 1), 13))
    rect = zp.Rectangle(2, 3, 20, 17)
    jrect = jz.Rectangle(2, 3, 20, 17)
    _equal(p.extract(rect, -0.4, size, Interpolation.BILINEAR,
                     BorderMode.REPLICATE),
           j.extract(jrect, -0.4, size, JI.BILINEAR, JB.REPLICATE))


@pytest.mark.parametrize("rect", [(-5, -3, 20, 30), (10, 8, 50, 40),
                                  (3.4, 2.6, 11.5, 9.5), (-30, -30, -2, -4)])
def test_crop_out_of_bounds_matches_jax(rect):
    p, j = _pair(_u8((20, 26, 4), 14))
    got = p.crop(rect)
    _equal(got, j.crop(rect))
    assert got.dtype is zp.Rgba


def test_crop_of_an_empty_rect_raises():
    p, _ = _pair(_u8((8, 8, 3), 0))
    with pytest.raises(ValueError):
        p.crop((2, 2, 2, 6))
    with pytest.raises(TypeError):
        p.crop(3)


# -- insert --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["NEAREST", "BILINEAR", "MITCHELL"])
def test_insert_without_blend_matches_jax(method):
    p, j = _pair(_u8((30, 36, 3), 15))
    src = _u8((12, 16, 1), 16)
    ps, js = _pair(src)
    p.insert(ps, (6, 4, 28, 22), 0.4, Interpolation[method])
    j.insert(js, (6, 4, 28, 22), 0.4, JI[method])
    _equal(p, j)


@pytest.mark.parametrize("mode", [m.name for m in zp.Blending])
def test_insert_rgba_with_a_blend_matches_jax(mode):
    """Image.insert runs op by op in the JAX package (one rounding an
    operation), ImageBatch.insert as one compiled program (fused
    multiply-adds): the port rounds each as its counterpart does."""
    base = _u8((26, 30, 3), 17)
    src = _u8((10, 14, 4), 18)
    src[..., 3] = np.where(src[..., 3] < 60, 0, src[..., 3])
    p, j = _pair(base)
    ps, js = _pair(src)
    p.insert(ps, (3, 5, 24, 20), -0.3, Interpolation.BILINEAR,
             zp.Blending[mode])
    j.insert(js, (3, 5, 24, 20), -0.3, JI.BILINEAR, jz.Blending[mode])
    _equal(p, j)
    pb = zp.ImageBatch(np.stack([base, base[::-1].copy()]), device=CPU)
    jb = jz.ImageBatch(np.stack([base, base[::-1].copy()]))
    _equal(pb.insert(ps, (3, 5, 24, 20), -0.3, Interpolation.BILINEAR,
                     zp.Blending[mode]),
           jb.insert(js, (3, 5, 24, 20), -0.3, JI.BILINEAR,
                     jz.Blending[mode]))


def test_batch_insert_of_per_image_sources_matches_jax():
    base = _u8((2, 24, 28, 4), 19)
    srcs = _u8((2, 8, 9, 4), 20)
    got = zp.ImageBatch(base, device=CPU).insert(
        zp.ImageBatch(srcs, device=CPU), (2, 3, 20, 18), 0.2,
        Interpolation.BILINEAR, zp.Blending.OVERLAY)
    want = jz.ImageBatch(base).insert(
        jz.ImageBatch(srcs), (2, 3, 20, 18), 0.2, JI.BILINEAR,
        jz.Blending.OVERLAY)
    _equal(got, want)
    with pytest.raises(ValueError):
        zp.ImageBatch(base, device=CPU).insert(
            zp.ImageBatch(srcs[:1], device=CPU), (2, 3, 20, 18))


# -- warp ---------------------------------------------------------------------------

SRC = [(3, 4), (40, 2), (38, 30), (5, 28)]
DST = [(0, 0), (45, 0), (45, 33), (0, 33)]
TRANSFORMS = ["SimilarityTransform", "AffineTransform", "ProjectiveTransform"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", TRANSFORMS)
def test_warp_matches_jax(kind, method):
    p, j = _pair(_u8((34, 46, 3), 21))
    pt = getattr(zp, kind)(SRC, DST)
    jt = getattr(jz, kind)(SRC, DST)
    got = p.warp(pt, (30, 40), Interpolation[method])
    want = j.warp(jt, (30, 40), JI[method])
    if method in KERNEL_METHODS:
        _within_one(got, want)
    else:
        _equal(got, want)


def test_warp_of_the_reference_projective_case_is_within_one():
    """tests/test_transforms.py:400-405's case: the port's host
    coordinates are JAX's static route, so NEAREST and BILINEAR are equal
    and BICUBIC is within 1 at under 1 % of pixels of its device route."""
    a = _u8((64, 80, 3), 8)
    src, dst = [(0, 0), (79, 0), (0, 63), (79, 63)], \
        [(4, 2), (75, 5), (-3, 60), (82, 58)]
    p, j = _pair(a)
    for method in ("NEAREST", "BILINEAR", "BICUBIC"):
        got = p.warp(zp.ProjectiveTransform(src, dst), None,
                     Interpolation[method])
        want = j.warp(jz.ProjectiveTransform(src, dst), None, JI[method])
        (_within_one if method == "BICUBIC" else _equal)(got, want)


def test_warp_rejects_other_transforms():
    p, _ = _pair(_u8((8, 8, 3), 0))
    with pytest.raises(TypeError):
        p.warp(np.eye(3))


def test_warp_coordinates_are_jax_static_routes():
    m = zp.ProjectiveTransform(SRC, DST).homogeneous()
    xs, ys = pw.warp_coords(m, 30, 40)
    ident = np.arange(30 * 40, dtype=np.int64).reshape(30, 40, 1)
    # a NEAREST warp of an index image reads back the rounded coordinates
    got = pw.sample(torch.from_numpy(ident), xs, ys, Interpolation.NEAREST,
                    BorderMode.MIRROR)
    want = jw.warp_static(ident.astype(np.float32), tuple(
        map(tuple, np.asarray(m, np.float32).tolist())), 30, 40,
        JI.NEAREST)
    assert np.array_equal(got.numpy().astype(np.float32), np.asarray(want))


# -- ImageBatch against per-image JAX Image -------------------------------------

BATCH_CALLS = {
    "rotate 0.5": (lambda t, ns: t.rotate(0.5),),
    "rotate pi/2": (lambda t, ns: t.rotate(math.pi / 2),),
    "rotate -0.9 BICUBIC WRAP": (
        lambda t, ns: t.rotate(-0.9, ns.Interpolation.BICUBIC,
                               ns.BorderMode.WRAP),),
    "extract": (lambda t, ns: t.extract((3, 2, 30, 21), 0.3, (12, 17)),),
    "crop": (lambda t, ns: t.crop((-4, 5, 20, 31)),),
    "warp projective BILINEAR": (
        lambda t, ns: t.warp(ns.ProjectiveTransform(SRC, DST)),),
    "warp affine NEAREST": (
        lambda t, ns: t.warp(ns.AffineTransform(SRC, DST), (20, 25),
                             ns.Interpolation.NEAREST),),
}


@pytest.mark.parametrize("name", list(BATCH_CALLS))
def test_image_batch_members_match_per_image_jax(name):
    fn, = BATCH_CALLS[name]
    x = _u8((3, 28, 36, 3), 22)
    got = fn(zp.ImageBatch(x, device=CPU), zp)
    assert isinstance(got, zp.ImageBatch) and got.device.type == "cpu"
    for i in range(3):
        _equal(got.device_array()[i], fn(jz.Image.from_numpy(x[i].copy()),
                                         jz))
