"""The port's Hough transform, Canvas and bitmap fonts against zignal_tpu
on JAX-CPU, ``device="cpu"`` on the port's side.

Bounds: the Hough accumulator is exact integer votes on both sides
(int32 16.16 ``rho``, exact for ``size <= 2048``): equal; ``_tables``,
``find_lines``, the fonts and Canvas are host copies: equal, over the
cases of tests/test_canvas*.py on gray, RGB and RGBA images.
"""

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.font._font8x8_data import FONT8X8_BASIC as J_FONT
from zignal_tpu.ops import hough as jhough

import zignal_tpu_torch as zp
from zignal_tpu_torch.font import BitmapFont, detect_from_bytes, ranges
from zignal_tpu_torch.font._font8x8_data import FONT8X8_BASIC
from zignal_tpu_torch.ops import hough as phough

CPU = "cpu"


def _lines_plane(n):
    """Edges of tests/test_features.py's Hough case plus a diagonal and
    noise."""
    edges = np.zeros((n, n), dtype=np.uint8)
    edges[int(0.7 * n), :] = 255
    for i in range(n):
        edges[i, min(n - 1, n // 3 + i // 8)] = 255
        edges[i, i] = 255
    rng = np.random.default_rng(n)
    edges[rng.random((n, n)) > 0.97] = 255
    return edges


# -- Hough ------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 3, 64, 97, 128])
def test_hough_tables_copy_equal(size):
    for a, b in zip(phough._tables(size), jhough._tables(size)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [64, 97, 128])
def test_hough_accumulator_equals_jax(size):
    edges = _lines_plane(size)
    got = phough.HoughTransform(size).compute(edges, device=CPU)
    want = jhough.HoughTransform(size).compute(edges)
    assert got.dtype == np.int32 and got.shape == (size, size)
    np.testing.assert_array_equal(got, want)


def test_hough_accumulator_in_theta_chunks(monkeypatch):
    edges = torch.from_numpy(_lines_plane(64))[None]
    whole = phough._vote(edges, 64)
    monkeypatch.setattr(phough, "_VOTES", 1000)  # a few thetas a chunk
    np.testing.assert_array_equal(phough._vote(edges, 64).numpy(),
                                  whole.numpy())


def test_hough_of_an_image_resized_nearest_equals_jax():
    """An RGB Image of another size: its luminance, resized NEAREST."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (90, 70, 3), np.uint8)
    p = zp.Image.from_numpy(arr.copy(), device=CPU).sobel()
    j = jz.Image.from_numpy(arr.copy()).sobel()
    np.testing.assert_array_equal(p.to_numpy(), j.to_numpy())
    got = phough.HoughTransform(64).compute(p)
    want = jhough.HoughTransform(64).compute(j)
    np.testing.assert_array_equal(got, want)
    # a tensor runs on its device; channel 0 of a raw [H, W, C]
    np.testing.assert_array_equal(
        phough.HoughTransform(64).compute(torch.from_numpy(arr)),
        jhough.HoughTransform(64).compute(arr))
    with pytest.raises(ValueError, match="device"):
        phough.HoughTransform(64).compute(arr)


@pytest.mark.parametrize("threshold", [20, 48, 64])
def test_find_lines_copy_equals_jax(threshold):
    edges = _lines_plane(96)
    acc = jhough.HoughTransform(96).compute(edges)
    got = phough.HoughTransform(96).find_lines(acc, threshold)
    want = jhough.HoughTransform(96).find_lines(acc, threshold)
    assert [vars(a) for a in got] == [vars(b) for b in want]


def test_hough_rho_fits_int32_up_to_2048():
    """JAX's comment (hough.py:80): 16.16 rho stays in int32 for
    size <= 2048; the port votes with the same int32 arithmetic."""
    cos_t, sin_t, _, _ = phough._tables(2048)
    v = 2 * 2047 - 2047
    worst = np.max(np.abs(cos_t) + np.abs(sin_t)) * v
    assert worst < 2 ** 31


def test_hough_rejects_a_tiny_size():
    with pytest.raises(ValueError):
        phough.HoughTransform(1)


# -- fonts --------------------------------------------------------------------

def test_font_data_copy_equal():
    assert FONT8X8_BASIC == J_FONT


@pytest.mark.parametrize("text,scale", [("Zig!", 1), ("tpu\nAB", 2),
                                        ("~{|}", 3)])
def test_bitmap_font_masks_equal_jax(text, scale):
    p, j = BitmapFont.font8x8(), jz.BitmapFont.font8x8()
    np.testing.assert_array_equal(p.render_mask(text, scale),
                                  j.render_mask(text, scale))
    assert p.text_bounds(text) == j.text_bounds(text)


def test_bitmap_font_bdf_and_pcf_roundtrip_equal_jax(tmp_path):
    p = BitmapFont.font8x8()
    for ext in ("bdf", "bdf.gz", "pcf"):
        path = str(tmp_path / f"f.{ext}")
        p.save(path)
        jpath = str(tmp_path / f"j.{ext}")
        jz.BitmapFont.font8x8().save(jpath)
        with open(path, "rb") as f, open(jpath, "rb") as g:
            assert f.read() == g.read()
        back = BitmapFont.load(path)
        np.testing.assert_array_equal(back.glyphs[ord("A")],
                                      p.glyphs[ord("A")])
    with open(str(tmp_path / "f.bdf"), "rb") as f:
        assert detect_from_bytes(f.read(16)).value == "bdf"
    # a load filter of a Unicode block keeps only its glyphs
    ascii_only = BitmapFont.load(str(tmp_path / "f.bdf"), ranges.ascii)
    assert set(ascii_only.glyphs) <= set(range(0x80))


# -- Canvas -------------------------------------------------------------------

def _draw(canvas_of, mod, name):
    """One case of tests/test_canvas*.py on a fresh image from
    ``canvas_of``; returns the canvas."""
    c = canvas_of()
    soft = mod.DrawMode.SOFT
    if name == "lines_fast":
        c.draw_line((2, 2), (60, 40), (255, 0, 0), width=1)
        c.draw_line((5, 60), (60, 5), (0, 255, 0, 128), width=3)
        c.draw_line((0, 10), (63, 10), (9, 9, 9))
        c.draw_line((-20, -5), (200, 90), (200, 100, 50), width=5)
    elif name == "lines_soft":
        c.draw_line((2, 2), (60, 40), (255, 0, 0), width=2, mode=soft)
        c.draw_line((5, 60), (60, 5), (0, 128, 255), width=4, mode=soft)
    elif name == "circles":
        c.draw_circle((32, 32), 20, (255, 255, 0))
        c.draw_circle((10, 50), 6.5, (255, 0, 0), width=3, mode=soft)
        c.fill_circle((20, 44), 10, (255, 0, 255, 200))
        c.fill_circle((44, 20), 8, (0, 255, 255), mode=soft)
    elif name == "polygons":
        pts = [(32, 4), (60, 24), (49, 58), (15, 58), (4, 24)]
        c.fill_polygon(pts, (64, 128, 255))
        c.draw_polygon(pts, (255, 255, 255), width=1)
        c.fill_polygon([(5, 5), (30, 8), (12, 28)], (10, 200, 10, 160),
                       mode=soft)
    elif name == "rectangles":
        c.fill_rectangle((3, 4, 20, 18), (1, 2, 3))
        c.fill_rectangle((10.5, 12.25, 40.5, 30.75), (0, 0, 255, 128),
                         mode=soft)
        c.draw_rectangle(zp.Rectangle(5, 5, 50, 40) if mod is zp
                         else jz.Rectangle(5, 5, 50, 40), (250, 0, 0),
                         width=2)
    elif name == "arcs":
        c.draw_arc((32, 32), 15, 0.0, 2.0, (255, 128, 0), width=2)
        c.fill_arc((32, 32), 10, 2.5, -2.5, (0, 128, 255), mode=soft)
        c.draw_arc((20, 40), 9, -1.0, 4.0, (90, 90, 90), mode=soft)
    elif name == "bezier_spline":
        c.draw_quadratic_bezier((4, 60), (32, -20), (60, 60), (255, 64, 64),
                                width=2)
        c.draw_cubic_bezier((4, 10), (20, 50), (44, -30), (60, 30),
                            (64, 255, 64), width=1)
        pts = [(10, 10), (50, 12), (40, 50), (12, 40)]
        c.draw_spline_polygon(pts, (200, 200, 0), width=2, mode=soft)
        c.fill_spline_polygon(pts, (0, 100, 100, 90), tension=0.3)
    elif name == "text":
        c.draw_text("Zig!", (4, 4), (255, 255, 255), scale=2)
        c.draw_text("tpu", (8, 40), (255, 200, 0))
        c.draw_text("A", (40, 44), (9, 99, 199), scale=1.5)
    elif name == "fill":
        c.fill((10, 20, 30))
        c.draw_line((0, 0), (10, 10), mod.Rgba(7, 8, 9, 255))
        c.fill_circle((10, 10), 3, mod.Hsl(200.0, 50.0, 50.0))
    return c


CANVAS_CASES = ["lines_fast", "lines_soft", "circles", "polygons",
                "rectangles", "arcs", "bezier_spline", "text", "fill"]


@pytest.mark.parametrize("space", ["gray", "rgb", "rgba"])
@pytest.mark.parametrize("name", CANVAS_CASES)
def test_canvas_copy_equals_jax(name, space):
    base = np.random.default_rng(len(name)).integers(
        0, 256, (64, 64, {"gray": 1, "rgb": 3, "rgba": 4}[space]), np.uint8)
    p_img = zp.Image.from_numpy(base.copy(), device=CPU)
    j_img = jz.Image.from_numpy(base.copy())
    _draw(lambda: zp.Canvas(p_img), zp, name)
    _draw(lambda: jz.Canvas(j_img), jz, name)
    np.testing.assert_array_equal(p_img.to_numpy(), j_img.to_numpy())


@pytest.mark.parametrize("mode", ["NONE", "NORMAL", "MULTIPLY", "SCREEN",
                                  "OVERLAY", "SOFT_LIGHT", "DIFFERENCE"])
def test_canvas_draw_image_blends_equal_jax(mode):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (40, 48, 3), np.uint8)
    sprite = rng.integers(0, 256, (20, 18, 4), np.uint8)
    p_img = zp.Image.from_numpy(base.copy(), device=CPU)
    j_img = jz.Image.from_numpy(base.copy())
    for img, mod in ((p_img, zp), (j_img, jz)):
        spr = mod.Image.from_numpy(sprite.copy(), **(
            {"device": CPU} if mod is zp else {}))
        c = img.canvas()
        c.draw_image(spr, (2.0, 3.0), blend_mode=getattr(mod.Blending, mode))
        c.draw_image(spr, (30.4, 28.6), (2, 3, 15, 17),
                     getattr(mod.Blending, mode))
    np.testing.assert_array_equal(p_img.to_numpy(), j_img.to_numpy())


def test_canvas_draws_on_a_device_resident_image():
    img = zp.Image._from_device(torch.zeros((16, 16, 3), dtype=torch.uint8),
                                "rgb")
    c = img.canvas()
    assert (c.rows, c.cols) == (16, 16) and c.image is img
    c.fill_rectangle((2, 2, 6, 6), (255, 0, 0))
    assert img.to_numpy()[3, 3].tolist() == [255, 0, 0]
    with pytest.raises(TypeError):
        zp.Canvas(np.zeros((4, 4, 3), np.uint8))
