"""The port's QR codec and terminal renderings against zignal_tpu on
JAX-CPU, ``device="cpu"`` on the port's side.

Bounds: all exact. The encoder, tables, GF(256) and matrix code are host
copies: module matrices and ``qrcode_encode`` images equal. The decoder
binarizes on the image's device through the port's adaptive mean and Otsu
thresholds, then runs the copied host scan: the dark mask and every field
of the result (text, version, level, mask, corrected errors, data,
corners) equal JAX's, on JAX-encoded codes, damaged, coloured, rotated,
mirrored and missing ones. Every display string (sgr, braille, sixel,
kitty, iTerm2, and ``format(img, spec)``) equals JAX's for the same image;
sixel's profile holds wall-clock times and is not compared.
"""

import importlib

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.qrcode import decoder as jdec
from zignal_tpu.qrcode import encode_to_matrix as jenc
from zignal_tpu.terminal import display as jdisp
from zignal_tpu.terminal import sixel as jsixel

import zignal_tpu_torch as zp
from zignal_tpu_torch.qrcode import QrEncodeError, decode_image
from zignal_tpu_torch.qrcode import decoder as pdec
from zignal_tpu_torch.qrcode import encode_to_matrix as penc
from zignal_tpu_torch.terminal import detect, display as pdisp
from zignal_tpu_torch.terminal import iterm2_from_image, kitty_from_image
from zignal_tpu_torch.terminal import sixel as psixel

CPU = "cpu"
LEVELS = list(zp.EcLevel)
TEXTS = ["01234567890123", "HELLO WORLD $%*+-./:", "hello, world",
         "héllo wörld ✓", "x" * 120, b"\x00\x01\xfe\xff binary"]


def _same_result(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    for field in ("text", "version", "mask", "corrected_errors", "data",
                  "corners"):
        assert getattr(got, field) == getattr(want, field), field
    assert int(got.ec_level) == int(want.ec_level)


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 9.0) * np.cos(yy / 5.0),
                     128 + 80 * np.cos(xx / 6.0 + yy / 4.0),
                     128 + 70 * np.sin((xx + yy) / 15.0)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0,
                   255).astype(np.uint8)


# -- QR -----------------------------------------------------------------------

@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
@pytest.mark.parametrize("level", LEVELS)
def test_encoder_matrices_equal_jax(text, level):
    mat, ver, mask = penc(text, level)
    jmat, jver, jmask = jenc(text, jz.EcLevel(int(level)))
    assert (ver, mask) == (jver, jmask)
    np.testing.assert_array_equal(mat, jmat)


@pytest.mark.parametrize("kw", [dict(), dict(module_size=3, quiet_zone=0),
                                dict(version=7, ec_level=3),
                                dict(ec_level=zp.EcLevel.LOW, module_size=1)],
                         ids=str)
def test_qrcode_encode_images_equal_jax(kw):
    got = zp.qrcode_encode("zignal on the card", device=CPU, **kw)
    want = jz.qrcode_encode("zignal on the card", **kw)
    assert got.dtype is zp.Gray and got.device == torch.device(CPU)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_qrcode_encode_errors_match_jax():
    for kw, exc in [(dict(version=0), QrEncodeError),
                    (dict(module_size=0), ValueError),
                    (dict(quiet_zone=-1), ValueError)]:
        with pytest.raises(exc):
            zp.qrcode_encode("x", device=CPU, **kw)
    with pytest.raises(QrEncodeError):
        zp.qrcode_encode("x" * 3000, ec_level=3, device=CPU)
    with pytest.raises(TypeError):
        zp.qrcode_encode(42, device=CPU)
    with pytest.raises(TypeError):
        zp.qrcode_encode("x")  # device is required
    with pytest.raises(TypeError):
        zp.qrcode_decode("not an image")


@pytest.mark.parametrize("text,level", [("HELLO", 0), ("zignal", 1),
                                        ("x" * 90, 2), ("01234" * 9, 3)])
def test_qrcode_decode_of_jax_codes_equals_jax(text, level):
    jimg = jz.qrcode_encode(text, ec_level=level, module_size=4)
    img = zp.Image.from_numpy(jimg.to_numpy().copy(), device=CPU)
    got, want = zp.qrcode_decode(img), jz.qrcode_decode(jimg)
    _same_result(got, want)
    assert got.text == text


def _variants():
    base = jz.qrcode_encode("DAMAGE TEST", ec_level=3, module_size=4)
    arr = base.to_numpy().copy()
    damaged = arr.copy()
    c = arr.shape[0] // 2
    damaged[c:c + 16, c:c + 16] = 0
    rgb = jz.qrcode_encode("colour conversion").convert(jz.Rgb).to_numpy()
    photo = _photo(320, 360, 1)
    small = jz.qrcode_encode("in a photo", module_size=3).to_numpy()
    photo[40:40 + small.shape[0], 60:60 + small.shape[1]] = small
    return {"damaged": damaged, "rgb": rgb.copy(),
            "rotated": np.ascontiguousarray(np.rot90(arr)),
            "mirrored": np.ascontiguousarray(arr[:, ::-1]),
            "in-photo": photo, "blank": np.full((64, 64, 1), 255, np.uint8),
            "noise": np.random.default_rng(2).integers(
                0, 256, (96, 96, 3), np.uint8)}


VARIANTS = _variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_qrcode_decode_variants_equal_jax(name):
    arr = VARIANTS[name]
    got = zp.qrcode_decode(zp.Image.from_numpy(arr.copy(), device=CPU))
    want = jz.qrcode_decode(jz.Image.from_numpy(arr.copy()))
    _same_result(got, want)
    if name == "damaged":
        assert got.corrected_errors > 0
    if name in ("blank", "noise"):
        assert got is None


@pytest.mark.parametrize("name", ["damaged", "in-photo", "blank"])
def test_binarize_and_raw_arrays_equal_jax(name):
    arr = VARIANTS[name]
    gray = arr[..., 0]
    np.testing.assert_array_equal(pdec._binarize(torch.from_numpy(gray)),
                                  jdec._binarize(gray))
    got = decode_image(arr, device=CPU)
    want = jdec.decode_image(arr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_result(g, w)
    assert [r.text for r in decode_image(torch.from_numpy(arr))] == \
        [r.text for r in want]
    with pytest.raises(ValueError, match="device="):
        decode_image(arr)


def test_qr_result_types_are_exported():
    assert zp.EcLevel is importlib.import_module(
        "zignal_tpu_torch.qrcode.tables").EcLevel
    result = zp.qrcode_decode(zp.qrcode_encode("repr", device=CPU))
    assert isinstance(result, zp.QrDecodeResult)
    assert "QrDecodeResult" in repr(result)


# -- terminal -----------------------------------------------------------------

def _images(dtype):
    arr = _photo(13, 22, 7)
    arr[:6, :5] = (255, 0, 0)
    pimg = zp.Image.from_numpy(arr.copy(), device=CPU)
    jimg = jz.Image.from_numpy(arr.copy())
    return (pimg.convert(getattr(zp, dtype)),
            jimg.convert(getattr(jz, dtype)))


@pytest.mark.parametrize("dtype", ["Gray", "Rgb", "Rgba"])
@pytest.mark.parametrize("spec", ["sgr", "braille", "sixel", "kitty",
                                  "iterm2", "SGR", "auto", "", "none"])
def test_format_and_display_equal_jax(dtype, spec):
    pimg, jimg = _images(dtype)
    assert format(pimg, spec) == format(jimg, spec)
    if spec not in ("", "none"):
        assert pimg.display(spec) == jimg.display(spec)


def test_unknown_display_format_raises():
    pimg, _ = _images("Rgb")
    with pytest.raises(ValueError, match="unknown display format"):
        format(pimg, "png")


@pytest.mark.parametrize("kw", [dict(threshold=0.3), dict(color=False),
                                dict(palette="fixed_vga16"),
                                dict(palette="adaptive")], ids=str)
def test_braille_options_equal_jax(kw):
    pimg, jimg = _images("Rgb")
    assert pdisp.braille_from_image(pimg, **kw) == \
        jdisp.braille_from_image(jimg, **kw)


@pytest.mark.parametrize("opts", [
    dict(), dict(dither="none"), dict(dither="floyd_steinberg"),
    dict(dither="atkinson", max_colors=8), dict(palette="fixed_vga16"),
    dict(palette="fixed_web216", dither="ordered"),
    dict(palette="fixed_6x7x6", dither="none")], ids=str)
def test_sixel_strings_equal_jax_and_the_fallback(opts):
    pimg, jimg = _images("Rgb")
    prof = psixel.Profile()
    got = psixel.sixel_from_image(pimg, psixel.SixelOptions(**opts), prof)
    assert got == jsixel.sixel_from_image(jimg, jsixel.SixelOptions(**opts))
    assert prof.emit_ns > 0
    arr = pimg.to_numpy()
    idx = np.random.default_rng(1).integers(0, 40, arr.shape[:2], np.uint8)
    assert psixel._emit_bands_native(idx) == psixel._emit_bands_py(idx)


def _busy_bands(bands=10, w=120):
    """Every band holds each of the 256 colours once or twice, scattered:
    the densest sixel bands there are."""
    rng = np.random.default_rng(2)
    return np.concatenate([rng.permutation(
        np.arange(6 * w) % 256).astype(np.uint8).reshape(6, w)
        for _ in range(bands)])


@pytest.mark.parametrize("idx", [
    _busy_bands(), _busy_bands(1, 300),
    np.random.default_rng(3).integers(0, 2, (13, 1), np.uint8),
    np.zeros((1, 1), np.uint8)], ids=["busy", "wide", "column", "pixel"])
def test_sixel_library_takes_busy_bands(idx):
    """The JAX package's output buffer is too small for busy bands, which
    then go to its Python emitter (the same string, slowly); the port
    sizes the buffer for the worst case, so its library takes them."""
    body = psixel._emit_bands_native(idx)
    assert body is not None and body == psixel._emit_bands_py(idx)
    if idx.shape == (60, 120):  # needs 44,941 bytes; JAX's cap 31,472
        assert jsixel._emit_bands_native(idx) is None


@pytest.mark.parametrize("kw", [
    dict(), dict(width=11), dict(height=5), dict(width=30, height=9),
    dict(width=8, interpolation=zp.Interpolation.NEAREST),
    dict(image_id=7, placement_id=3, delete_after=True, quiet=2),
    dict(enable_chunking=True)], ids=str)
def test_kitty_and_iterm2_equal_jax(kw):
    from zignal_tpu.terminal import iterm2_from_image as jiterm2
    from zignal_tpu.terminal import kitty_from_image as jkitty

    pimg, jimg = _images("Rgb")
    if "interpolation" in kw:
        jkw = dict(kw, interpolation=jz.Interpolation(int(kw["interpolation"])))
    else:
        jkw = kw
    assert kitty_from_image(pimg, **kw) == jkitty(jimg, **jkw)
    scale = {k: v for k, v in kw.items()
             if k in ("width", "height", "interpolation")}
    jscale = {k: v for k, v in jkw.items()
              if k in ("width", "height", "interpolation")}
    assert iterm2_from_image(pimg, **scale) == jiterm2(jimg, **jscale)


def test_kitty_chunks_a_large_payload_as_jax_does():
    from zignal_tpu.terminal import kitty_from_image as jkitty

    arr = np.random.default_rng(3).integers(0, 256, (64, 64, 3), np.uint8)
    got = kitty_from_image(zp.Image.from_numpy(arr.copy(), device=CPU),
                           enable_chunking=True)
    assert got.count("\x1b_G") > 1
    assert got == jkitty(jz.Image.from_numpy(arr.copy()),
                         enable_chunking=True)


def test_detect_without_a_tty_does_not_block():
    sup = detect.detect_terminal_support()
    if not sup.is_tty:
        assert detect._query(b"\x1b[c", b"c", timeout=0.01) == b""
    w, h = detect.cell_size()
    assert w > 0 and h > 0
