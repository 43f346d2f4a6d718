"""The port's Image container, colour classes, Histogram, Rectangle and
blend modes against zignal_tpu's on JAX-CPU, with ``device="cpu"`` on the
port's side. u8 outputs are held equal; the colour classes' components
(Python f64 arithmetic in both) are held equal too. Mirrors
tests/test_image.py, test_colors.py, test_histogram.py, test_rectangle.py
and test_pixel_assignment.py where they cover a ported member."""

import itertools

import numpy as np
import pytest

import zignal_tpu as jz

import zignal_tpu_torch as zp
from zignal_tpu_torch import BorderMode, Interpolation

CPU = "cpu"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _blocky(shape, seed):
    """Piecewise-flat blocks with noise, so the edge detectors and
    thresholds have structure to find."""
    h, w, c = shape
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (h // 6 + 1, w // 6 + 1, c))
    base = blocks.repeat(6, 0).repeat(6, 1)[:h, :w]
    return np.clip(base + rng.integers(-10, 11, shape), 0, 255) \
        .astype(np.uint8)


def _pair(arr):
    return (zp.Image.from_numpy(arr.copy(), device=CPU),
            jz.Image.from_numpy(arr.copy()))


def _same(p, j):
    assert type(p).__name__ == type(j).__name__
    if isinstance(p, tuple):
        for a, b in zip(p, j):
            _same(a, b)
        return
    if isinstance(p, (zp.Image, jz.Image)):
        assert p.dtype.__name__ == j.dtype.__name__
        assert np.array_equal(p.to_numpy(), j.to_numpy())
    else:
        assert p == j


# -- the colour classes ------------------------------------------------------

CLASSES = ["Gray", "Rgb", "Rgba", "Hsl", "Hsv", "Lab", "Lch", "Lms", "Oklab",
           "Oklch", "Xyb", "Xyz", "Ycbcr"]


def _samples(name, seed):
    """Seeded in-range component tuples of the class ``name``."""
    ranges = jz.color._classes._SPECS[name][3]
    ints = jz.color._classes._SPECS[name][2]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        vals = []
        for lo, hi in ranges:
            hi = min(hi, 200.0)
            vals.append(int(rng.integers(lo, hi + 1)) if ints
                        else float(rng.uniform(lo, hi)))
        out.append(tuple(vals))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_color_to_every_class_matches_jax(name):
    for i, vals in enumerate(_samples(name, CLASSES.index(name))):
        p, j = getattr(zp, name)(*vals), getattr(jz, name)(*vals)
        assert repr(p) == repr(j)
        assert format(p, "ansi") == format(j, "ansi")
        for target in CLASSES:
            got = p.to(getattr(zp, target))
            want = j.to(getattr(jz, target))
            assert type(got).__name__ == target
            assert got._v == want._v, (vals, target)
            assert hash(got) == hash(want)


@pytest.mark.parametrize("mode", list(zp.Blending), ids=lambda m: m.name)
def test_color_blend_matches_jax(mode):
    rng = np.random.default_rng(int(mode))
    for _ in range(20):
        base = tuple(int(v) for v in rng.integers(0, 256, 3))
        over = tuple(int(v) for v in rng.integers(0, 256, 4))
        for cls in ("Rgb", "Rgba"):
            args = base + ((int(rng.integers(0, 256)),) if cls == "Rgba"
                           else ())
            got = getattr(zp, cls)(*args).blend(over, mode)
            want = getattr(jz, cls)(*args).blend(over, jz.Blending(mode))
            assert type(got).__name__ == type(want).__name__
            assert got._v == want._v


def test_color_methods_and_validation_match_jax():
    for h in (0x123456, 0xABCDEF, 0x4E008E):
        assert zp.Rgb.from_hex(h)._v == jz.Rgb.from_hex(h)._v
        assert zp.Rgb.from_hex(h).hex() == h
    for h in (0x12345678, 0xFEDCBA01):
        assert zp.Rgba.from_hex(h).hex() == h
    assert zp.Rgba.transparent.hex() == 0 and zp.Rgb.white.hex() == 0xFFFFFF
    assert zp.Rgb(0, 128, 255).invert()._v == [255, 127, 0]
    assert zp.Rgba(10, 20, 30, 64).invert()._v == [245, 235, 225, 64]
    assert zp.Gray(100).invert()._v == [155]
    assert zp.Rgb(12, 200, 34).luma() == jz.Rgb(12, 200, 34).luma()
    assert zp.Rgb(1, 2, 3).with_alpha(9)._v == [1, 2, 3, 9]
    assert zp.Rgb(255, 0, 0).to(zp.Gray).y == 54
    assert zp.Lab(50, 0, 0).to(zp.Gray).y == 119
    with pytest.raises(ValueError):
        zp.Rgb(256, 0, 0)
    with pytest.raises(TypeError):
        zp.Hsv(None, 0.0, 0.0)
    with pytest.raises(TypeError):
        zp.Rgb(1.5, 0, 0)
    c = zp.Hsl(10.0, 20.0, 30.0)
    c.h = 200.0
    assert c.h == 200.0
    with pytest.raises(ValueError):
        c.s = 101.0


# -- Rectangle ----------------------------------------------------------------

def test_rectangle_matches_jax():
    p, j = zp.Rectangle(10, 20, 30, 40), jz.Rectangle(10, 20, 30, 40)
    other = (15, 25, 35, 45)
    for name, args in [("center", ()), ("top_left", ()), ("top_right", ()),
                       ("bottom_left", ()), ("bottom_right", ()),
                       ("is_empty", ()), ("area", ()), ("perimeter", ()),
                       ("diagonal", ()), ("iou", (other,)),
                       ("overlaps", (other,)), ("covers", (other,))]:
        assert getattr(p, name)(*args) == getattr(j, name)(*args), name
    for name, args in [("translate", (5, -5)), ("grow", (5,)),
                       ("shrink", (5,)), ("merge", ((0, 0, 5, 5),)),
                       ("clip", ((0, 0, 25, 35),)), ("intersect", (other,))]:
        got, want = getattr(p, name)(*args), getattr(j, name)(*args)
        assert (got.left, got.top, got.right, got.bottom) == \
            (want.left, want.top, want.right, want.bottom), name
    r2 = zp.Rectangle.init_center(20, 20, 10, 10)
    assert r2.iou(p) == jz.Rectangle.init_center(20, 20, 10, 10).iou(j)
    assert p.overlaps((30, 40, 60, 80), iou_thresh=0.0,
                      coverage_thresh=0.0) is False
    assert p.intersect((100, 100, 110, 110)) is None
    with pytest.raises(ValueError):
        zp.Rectangle(5, 5, 0, 0)


# -- Histogram ----------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 3, 4])
def test_histogram_statistics_match_jax(c):
    p, j = _pair(_u8((23, 31, c), 50 + c))
    hp, hj = p.histogram(), j.histogram()
    assert hp.channels == hj.channels
    assert hp.values.dtype == hj.values.dtype
    assert np.array_equal(hp.values, hj.values)
    assert hp.total_pixels() == hj.total_pixels()
    for name, args in [("mean", ()), ("median", ()), ("mode", ()),
                       ("variance", ()), ("percentile", (0.0,)),
                       ("percentile", (0.37,)), ("percentile", (1.0,))]:
        assert getattr(hp, name)(*args) == getattr(hj, name)(*args), name
    assert np.array_equal(hp.channel(hp.channels[-1]),
                          hj.channel(hj.channels[-1]))
    assert repr(hp) == repr(hj)


def test_histogram_incremental_and_gray_golden():
    img = zp.Image(4, 4, dtype=zp.Gray, device=CPU)
    img.to_numpy()[..., 0] = np.arange(16, dtype=np.uint8).reshape(4, 4)
    h = img.histogram()
    assert h.channels == ("y",) and h.total_pixels() == 16
    assert (h.mean(), h.median(), h.percentile(1.0)) == (7.5, 7, 15)
    h.add_value(0, 200)
    assert h.values[0, 200] == 1
    h.remove_value(0, 200)
    with pytest.raises(ValueError):
        h.remove_value(0, 200)


# -- the Image container: construction, pixels, views, host ops ---------------

def test_construction_and_dtype_autodetect_match_jax():
    for args, kw in [((2, 2), {}), ((2, 2, 7), {}), ((2, 2, (1, 2, 3)), {}),
                     ((2, 2, (1, 2, 3, 4)), {}), ((2, 2, 7), {"dtype": "Rgb"}),
                     ((3, 2, zp.Rgba(1, 2, 3, 4)), {}),
                     ((3, 2, 0.5), {"dtype": "Gray"}),
                     ((2, 3, (9, 8, 7)), {"dtype": "Gray"})]:
        jargs = tuple(jz.Rgba(*a._v) if isinstance(a, zp.Rgba) else a
                      for a in args)
        pk = {k: getattr(zp, v) for k, v in kw.items()}
        jk = {k: getattr(jz, v) for k, v in kw.items()}
        _same(zp.Image(*args, device=CPU, **pk), jz.Image(*jargs, **jk))
    img = zp.Image(5, 7, device=CPU)
    assert repr(img) == repr(jz.Image(5, 7))
    assert format(img, "") == repr(img)
    assert format(img, "sgr") == format(jz.Image(5, 7), "sgr")
    assert img.device == zp.Image(1, 1, device="cpu").device
    rect = img.get_rectangle()
    assert (rect.left, rect.top, rect.right, rect.bottom) == (0, 0, 7, 5)
    assert len(img) == 35 and img.is_contiguous()
    with pytest.raises(ValueError):
        zp.Image(0, 3, device=CPU)


def test_from_numpy_validation_and_borrowing():
    arr = np.zeros((3, 4, 4), dtype=np.uint8)
    img = zp.Image.from_numpy(arr, device=CPU)
    assert img.to_numpy() is arr
    with pytest.raises(TypeError):
        zp.Image.from_numpy(np.zeros((2, 3, 3), np.float32), device=CPU)
    with pytest.raises(ValueError):
        zp.Image.from_numpy(np.zeros((2, 3), np.uint8), device=CPU)
    with pytest.raises(ValueError):
        zp.Image.from_numpy(np.zeros((2, 3, 2), np.uint8), device=CPU)
    ro = np.zeros((2, 2, 3), np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ValueError):
        zp.Image.from_numpy(ro, device=CPU)


def test_a_write_through_the_borrowed_array_shows_in_the_next_device_op():
    arr = _u8((16, 20, 3), 1)
    img = zp.Image.from_numpy(arr, device=CPU)
    first = img.gaussian_blur(1.0).to_numpy().copy()
    arr[4:12, 5:15] = 255
    second = img.gaussian_blur(1.0)
    want = jz.Image.from_numpy(arr.copy()).gaussian_blur(1.0)
    assert not np.array_equal(first, second.to_numpy())
    _same(second, want)


def test_device_results_do_not_alias_their_source():
    arr = _u8((8, 8, 3), 2)
    img = zp.Image.from_numpy(arr, device=CPU)
    out = img.box_blur(1)
    copy = out.copy()
    out.to_numpy()[:] = 0
    assert copy.to_numpy().any()
    assert np.array_equal(img.to_numpy(), _u8((8, 8, 3), 2))


def test_equality_copy_pixels_and_iteration():
    img1 = zp.Image(3, 4, (1, 2, 3, 255), dtype=zp.Rgba, device=CPU)
    img2 = img1.copy()
    assert img1 == img2
    img2.to_numpy()[0, 0] = [9, 9, 9, 255]
    assert img1 != img2
    img = zp.Image(2, 2, (10, 20, 30), dtype=zp.Rgb, device=CPU)
    px = img[0, 0]
    assert (px.r, px.g, px.b) == (10, 20, 30)
    px.g = 99
    assert img[0, 0] == (10, 99, 30) and img[0, 0].g == 99
    assert img[0, 0].item() == zp.Rgb(10, 99, 30)
    assert repr(img[0, 0]) == repr(jz.Rgb(10, 99, 30))
    assert img[1, 1].to(zp.Hsv)._v == jz.Rgb(10, 20, 30).to(jz.Hsv)._v
    with pytest.raises(ValueError):
        px.r = 300
    with pytest.raises(IndexError):
        img[2, 0]
    seen = list(img)
    assert [s[:2] for s in seen] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert seen[3][2] == zp.Rgb(10, 20, 30)
    gray = zp.Image(2, 2, 100, dtype=zp.Gray, device=CPU)
    assert gray[0, 0] == 100 and list(gray)[0] == (0, 0, 100)


@pytest.mark.parametrize("space", ["Rgb", "Gray", "Rgba"])
def test_pixel_assignment_of_any_colour_class_matches_jax(space):
    p = zp.Image(2, 3, dtype=getattr(zp, space), device=CPU)
    j = jz.Image(2, 3, dtype=getattr(jz, space))
    values = [("Gray", (128,)), ("Hsl", (0.0, 100.0, 50.0)),
              ("Rgba", (1, 2, 3, 4)), ("Lab", (40.0, 20.0, -30.0)),
              ("Oklch", (0.5, 0.2, 45.0))]
    for i, (name, vals) in enumerate(values):
        p[i // 3, i % 3] = getattr(zp, name)(*vals)
        j[i // 3, i % 3] = getattr(jz, name)(*vals)
    p[1, 2] = (7, 8, 9)
    j[1, 2] = (7, 8, 9)
    _same(p, j)
    blended_p = p[0, 0].blend(zp.Rgba(200, 10, 10, 128)) \
        if space != "Gray" else None
    blended_j = j[0, 0].blend(jz.Rgba(200, 10, 10, 128)) \
        if space != "Gray" else None
    if blended_p is not None:
        assert blended_p._v == blended_j._v
    _same(p, j)


def test_views_fill_and_set_border_match_jax():
    p, j = _pair(_u8((9, 11, 4), 3))
    for rect in ((1, 1, 5, 7), zp.Rectangle(2, 3, 8, 6)):
        jrect = rect if isinstance(rect, tuple) else jz.Rectangle(2, 3, 8, 6)
        p.view(rect).fill((5, 6, 7, 255))
        j.view(jrect).fill((5, 6, 7, 255))
        _same(p, j)
    for rect, color in [((1, 2, 6, 7), None), ((2, 2, 9, 9), (255, 0, 0)),
                        ((20, 20, 30, 30), 77), ((-3, -3, 4, 20), 0.5)]:
        p.set_border(rect, color)
        j.set_border(rect, color)
        _same(p, j)
    p.fill(zp.Hsv(120.0, 50.0, 50.0))
    j.fill(jz.Hsv(120.0, 50.0, 50.0))
    _same(p, j)
    with pytest.raises(TypeError):
        p.set_border(None)
    with pytest.raises(ValueError):
        p.view((20, 20, 30, 30))


@pytest.mark.parametrize("src,dst", list(itertools.product(
    ["Gray", "Rgb", "Rgba"], repeat=2)))
def test_convert_and_slice_assignment_match_jax(src, dst):
    c = {"Gray": 1, "Rgb": 3, "Rgba": 4}[src]
    p, j = _pair(_u8((7, 9, c), 4 + c))
    _same(p.convert(getattr(zp, dst)), j.convert(getattr(jz, dst)))
    # a device-held image converts on the device
    _same(p.box_blur(1).convert(getattr(zp, dst)),
          j.box_blur(1).convert(getattr(jz, dst)))
    tp = zp.Image(7, 9, dtype=getattr(zp, dst), device=CPU)
    tj = jz.Image(7, 9, dtype=getattr(jz, dst))
    tp[:] = p
    tj[:] = j
    _same(tp, tj)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_invert_and_flips_match_jax(c):
    p, j = _pair(_u8((5, 6, c), 8))
    for name in ("invert", "flip_left_right", "flip_top_bottom"):
        _same(getattr(p, name)(), getattr(j, name)())


@pytest.mark.parametrize("mode", list(zp.Blending), ids=lambda m: m.name)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_image_blend_matches_jax_in_every_mode(mode, c):
    """The host path: f32 with one rounding an operation, rounded in f64;
    equal to the JAX package's in every mode."""
    p, j = _pair(_u8((12, 13, c), 9 + c))
    over = _u8((12, 13, 4), 20)
    over[0] = 0
    over[1, :, 3] = 255
    assert p.blend(zp.Image.from_numpy(over.copy(), device=CPU), mode) \
        is None
    j.blend(jz.Image.from_numpy(over.copy()), jz.Blending(mode))
    _same(p, j)


# -- the Image container: device ops ------------------------------------------

SHARPEN3 = ((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0))
_B5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
BINOMIAL5 = tuple(tuple(float(v) for v in row) for row in np.outer(_B5, _B5))

DEVICE_OPS = [
    ("resize", ((20, 30),)), ("resize", (0.5,)), ("resize", (1.7,)),
    *[("resize", ((29, 41), m)) for m in Interpolation],
    ("letterbox", ((40, 40),)), ("letterbox", (32,)),
    ("letterbox", ((30, 60), Interpolation.NEAREST)),
    ("box_blur", (2,)), ("box_blur", (0,)), ("sharpen", (2,)),
    ("gaussian_blur", (1.5,)), ("gaussian_blur", (0.6,)),
    ("convolve", (SHARPEN3,)), ("convolve", (BINOMIAL5, BorderMode.ZERO)),
    ("convolve_separable", ((1.0, 2.0, 1.0), (0.25, 0.5, 0.25))),
    ("convolve_separable", ((-0.25, 0.5, 1.5, 0.5, -0.25), (1.0,),
                            BorderMode.WRAP)),
    ("median_blur", (2,)), ("median_blur", (0,)),
    ("percentile_blur", (2, 0.7)), ("min_blur", (1,)),
    ("max_blur", (1, BorderMode.WRAP)), ("midpoint_blur", (2,)),
    ("alpha_trimmed_mean_blur", (2, 0.2)),
    ("sobel", ()), ("canny", ()), ("canny", (1.0, 20, 60)),
    ("shen_castan", ()), ("shen_castan", (0.8, 5, 0.95, 0.4, False, True)),
    ("threshold_otsu", ()), ("threshold_adaptive_mean", ()),
    ("threshold_adaptive_mean", (3, 2.0)),
    ("dilate_binary", ()), ("erode_binary", (3, 2)), ("open_binary", ()),
    ("close_binary", (5, 1)), ("dilate_binary", (3, 0)),
    ("autocontrast", ()), ("autocontrast", (0.02,)), ("equalize", ()),
]


def _id(case):
    name, args = case
    return f"{name}-" + "-".join(getattr(a, "name", str(a))[:12]
                                 for a in args)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("name,args", DEVICE_OPS,
                         ids=[_id(c) for c in DEVICE_OPS])
def test_device_op_matches_jax(name, args, c):
    p, j = _pair(_blocky((37, 53, c), 11 + c))
    _same(getattr(p, name)(*args), getattr(j, name)(*args))


def test_device_op_validation_matches_jax():
    p, j = _pair(_u8((8, 8, 3), 12))
    for name, args, exc in [
            ("resize", (0.0,), ValueError), ("resize", (float("nan"),),
                                             ValueError),
            ("resize", ((0, 3),), ValueError), ("resize", ("x",), TypeError),
            ("letterbox", ((0, 3),), ValueError),
            ("gaussian_blur", (0.0,), ValueError),
            ("box_blur", (-1,), ValueError),
            ("percentile_blur", (1, 1.5), ValueError),
            ("alpha_trimmed_mean_blur", (1, 0.5), ValueError),
            ("canny", (1.0, 60, 20), ValueError),
            ("canny", (float("inf"),), ValueError),
            ("shen_castan", (1.5,), ValueError),
            ("shen_castan", (0.5, 4), ValueError),
            ("threshold_adaptive_mean", (0,), ValueError),
            ("dilate_binary", (4,), ValueError),
            ("autocontrast", (0.5,), ValueError),
            ("convolve", (((1.0, 1.0),),), ValueError),
            ("convolve_separable", ((1.0, 1.0), (1.0,)), ValueError)]:
        with pytest.raises(exc):
            getattr(p, name)(*args)
        with pytest.raises(exc):
            getattr(j, name)(*args)


def test_resize_goldens_and_chains_match_jax():
    img = zp.Image(8, 8, (100, 150, 200), dtype=zp.Rgb, device=CPU)
    for method in Interpolation:
        out = img.resize((16, 16), method).to_numpy()
        assert np.all(out == np.array([100, 150, 200], np.uint8)), method
    src = np.zeros((4, 8, 1), np.uint8)
    src[..., 0] = np.arange(4)[:, None] * 20 + np.arange(8)[None] * 10
    a = zp.Image.from_numpy(src, device=CPU).letterbox((6, 6)).to_numpy()
    assert (a[0] == 0).all() and (a[4:] == 0).all() and a[1:4].any()
    p, j = _pair(_blocky((40, 50, 3), 13))
    _same(p.resize((30, 20)).gaussian_blur(1.2).convert(zp.Gray).equalize(),
          j.resize((30, 20)).gaussian_blur(1.2).convert(jz.Gray).equalize())


def test_save_load_and_load_from_bytes_match_jax(tmp_path):
    arr = _blocky((20, 24, 4), 14)
    p, j = _pair(arr)
    for name in ("x.png", "x.jpg", "x.bmp", "x.gif"):
        p.save(str(tmp_path / ("p" + name)))
        j.save(str(tmp_path / ("j" + name)))
        data = (tmp_path / ("p" + name)).read_bytes()
        assert data == (tmp_path / ("j" + name)).read_bytes()
        _same(zp.Image.load(str(tmp_path / ("p" + name)), device=CPU),
              jz.Image.load(str(tmp_path / ("j" + name))))
        _same(zp.Image.load_from_bytes(data, device=CPU),
              jz.Image.load_from_bytes(data))
    p.box_blur(1).save(str(tmp_path / "d.png"))
    j.box_blur(1).save(str(tmp_path / "e.png"))
    assert (tmp_path / "d.png").read_bytes() == \
        (tmp_path / "e.png").read_bytes()


@pytest.mark.parametrize("shape", [(1, 1, 3), (100, 200, 1), (128, 129, 4),
                                   (2, 5000, 70, 3), (4096, 4097, 1)])
def test_shape_buckets_match_jax(shape):
    from zignal_tpu import shapes as jshapes
    from zignal_tpu_torch import shapes as pshapes

    assert pshapes.bucket_shape(*shape[-3:-1]) == \
        jshapes.bucket_shape(*shape[-3:-1])
    assert pshapes.bucket_shape(*shape[-3:-1], buckets=(64, 96)) == \
        jshapes.bucket_shape(*shape[-3:-1], buckets=(64, 96))
    if np.prod(shape) <= 1 << 20:
        arr = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
        got, valid = pshapes.pad_to_bucket(arr)
        want, jvalid = jshapes.pad_to_bucket(arr)
        assert valid == jvalid
        np.testing.assert_array_equal(got, want)
