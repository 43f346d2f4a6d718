"""The port's quantize and dither ops and its GIF codec (host copies on the
port's own native library) against zignal_tpu's, on seeded arrays:
palettes, lookup tables, dithered pixels and indices, encoded GIF bytes
and decoded frames are all required equal. Both packages run the same C++
(copied byte for byte) and the same Python, so any difference is a copying
error. The library and the Python fallbacks are also held equal to each
other, since a caller cannot tell which one ran."""

import struct

import numpy as np
import pytest

import zignal_tpu as jz
from zignal_tpu.codecs import gif as jgif
from zignal_tpu.ops import dither as jdither
from zignal_tpu.ops import quantize as jquant

import zignal_tpu_torch as zp
from zignal_tpu_torch import native
from zignal_tpu_torch.codecs import gif as pgif
from zignal_tpu_torch.ops import dither as pdither
from zignal_tpu_torch.ops import quantize as pquant

CPU = "cpu"
MODES = ("none", "ordered", "floyd_steinberg", "atkinson", "auto")


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _photo(h, w, seed):
    """Smooth structure and grain: many colours, long runs."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 9.0) * np.cos(yy / 5.0),
                     128 + 80 * np.cos(xx / 6.0 + yy / 4.0),
                     128 + 70 * np.sin((xx + yy) / 15.0)], -1)
    noise = np.random.default_rng(seed).normal(0, 12, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _gradient(n=64):
    g = np.linspace(0, 255, n, dtype=np.uint8)
    return np.stack([np.tile(g, (n, 1))] * 3, -1)


def _two_colours():
    arr = np.zeros((8, 8, 3), np.uint8)
    arr[:4] = (250, 10, 10)
    arr[4:] = (10, 10, 250)
    return arr


INPUTS = {"random": _rand((32, 32, 3), 1), "photo": _photo(40, 56, 2),
          "gradient": _gradient(), "two": _two_colours(),
          "flat": np.full((5, 7, 3), 77, np.uint8)}


def test_library_is_loaded_with_the_new_signatures():
    lib = native.get_lib()
    assert lib is not None
    for name in ("zt_gif_lzw_decode", "zt_gif_lzw_encode", "zt_median_cut",
                 "zt_clt_build", "zt_sixel_emit",
                 "zt_dither_error_diffusion"):
        restype, argtypes = native._SIGNATURES[name]
        fn = getattr(lib, name)
        assert fn.restype is restype and fn.argtypes == argtypes


# -- quantize -----------------------------------------------------------------

def test_fixed_palettes_equal_jax():
    np.testing.assert_array_equal(pquant.fixed_6x7x6_palette(),
                                  jquant.fixed_6x7x6_palette())
    np.testing.assert_array_equal(pquant.web216_palette(),
                                  jquant.web216_palette())
    np.testing.assert_array_equal(pquant.VGA16_PALETTE, jquant.VGA16_PALETTE)
    for mode in ("fixed_6x7x6", "fixed_vga16", "fixed_web216"):
        np.testing.assert_array_equal(pquant.build_palette(None, mode),
                                      jquant.build_palette(None, mode))
    with pytest.raises(ValueError):
        pquant.build_palette(None, "nope")


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("k", [2, 16, 256])
def test_median_cut_equals_jax_and_the_fallback(name, k):
    arr = INPUTS[name]
    got = pquant.median_cut(arr, k)
    np.testing.assert_array_equal(got, jquant.median_cut(arr, k))
    np.testing.assert_array_equal(
        pquant._median_cut_py(arr.reshape(-1, 3), k), got)
    np.testing.assert_array_equal(
        pquant.build_palette(arr, "adaptive", k),
        jquant.build_palette(arr, "adaptive", k))


@pytest.mark.parametrize("palette", [
    "vga16", "web216", "6x7x6", "adaptive", "one"])
def test_lookup_table_equals_jax_and_the_fallback(palette):
    pal = {"vga16": pquant.VGA16_PALETTE,
           "web216": pquant.web216_palette(),
           "6x7x6": pquant.fixed_6x7x6_palette(),
           "adaptive": pquant.median_cut(INPUTS["photo"], 37),
           "one": np.array([[9, 200, 31]], np.uint8)}[palette]
    lut = pquant.ColorLookupTable(pal)
    np.testing.assert_array_equal(lut.table,
                                  jquant.ColorLookupTable(pal).table)
    np.testing.assert_array_equal(pquant._clt_table_py(pal), lut.table)
    arr = INPUTS["random"]
    np.testing.assert_array_equal(lut.lookup_array(arr),
                                  jquant.ColorLookupTable(pal)
                                  .lookup_array(arr))
    assert lut.lookup((250, 3, 40)) == \
        jquant.ColorLookupTable(pal).lookup((250, 3, 40))


# -- dither -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["random", "photo", "gradient"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [2, 16, 200])
def test_every_dither_mode_equals_jax(name, mode, k):
    arr = INPUTS[name]
    pal = pquant.median_cut(arr, k)
    got_img, want_img = arr.copy(), arr.copy()
    got = pdither.apply_dither(got_img, pal, mode=mode)
    want = jdither.apply_dither(want_img, pal, mode=mode)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_img, want_img)


@pytest.mark.parametrize("mode", ["floyd_steinberg", "atkinson"])
def test_error_diffusion_library_equals_the_fallback(mode):
    arr = INPUTS["photo"][:24, :20]
    pal = pquant.median_cut(arr, 12)
    lut = pquant.ColorLookupTable(pal)
    lib_img, py_img = arr.copy(), arr.copy()
    pdither.apply_dither(lib_img, pal, lut, mode)
    pdither._error_diffusion_py(py_img, pal, lut, mode)
    np.testing.assert_array_equal(lib_img, py_img)


def test_resolve_auto_equals_jax():
    for n, w, h in [(256, 512, 512), (256, 100, 100), (16, 512, 512),
                    (64, 600, 600), (128, 511, 513)]:
        assert pdither.resolve_auto(n, w, h) == jdither.resolve_auto(n, w, h)
    with pytest.raises(ValueError):
        pdither.apply_dither(INPUTS["flat"].copy(), pquant.VGA16_PALETTE,
                             mode="nope")


# -- GIF ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("mode", MODES)
def test_gif_encode_bytes_equal_jax(name, mode):
    arr = INPUTS[name]
    data = pgif.encode(arr, dither=mode)
    assert data == jgif.encode(arr, dither=mode)
    frame, info = pgif.decode(data)
    want, winfo = jgif.decode(data)
    np.testing.assert_array_equal(frame, want)
    assert info == pgif.GifInfo(winfo.width, winfo.height,
                                winfo.frame_count, winfo.loop_count)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("k", [2, 5, 64])
def test_gif_encode_channels_and_palette_sizes_equal_jax(c, k):
    arr = _rand((9, 13, c), c + k)
    assert pgif.encode(arr, max_colors=k, dither="none") == \
        jgif.encode(arr, max_colors=k, dither="none")
    with pytest.raises(ValueError):
        pgif.encode(arr.astype(np.int16))


@pytest.mark.parametrize("mode", ["none", "ordered", "floyd_steinberg"])
def test_gif_animated_bytes_and_frames_equal_jax(mode):
    frames = [_photo(24, 30, s) for s in range(3)] + [_rand((24, 30, 1), 9)]
    delays = [10, 20, 0, 7]
    data = pgif.encode_animated(frames, delays, loop_count=3, dither=mode)
    assert data == jgif.encode_animated(frames, delays, loop_count=3,
                                        dither=mode)
    got, want = pgif.decode_animated(data), jgif.decode_animated(data)
    assert got.frame_count == want.frame_count == 4
    assert got.delays == want.delays == delays
    assert got.loop_count == want.loop_count == 3
    for a, b in zip(got.frames, want.frames):
        np.testing.assert_array_equal(a, b)
    assert pgif.get_info(data) == pgif.GifInfo(30, 24, 4, 3)
    with pytest.raises(ValueError):
        pgif.encode_animated([], [])


def _crafted_gif(frames, size=(12, 10), version=b"GIF89a"):
    """A GIF whose frames exercise the decoder: each is (indices [h, w],
    left, top, disposal, transparent index or None, local palette or None,
    interlaced). A 4-colour global table; LZW from the JAX package."""
    w, h = size
    gct = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]],
                   np.uint8)
    out = bytearray(version)
    out += struct.pack("<HHBBB", w, h, 0x80 | 1, 0, 0) + gct.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 5) + b"\x00"
    for idx, left, top, disposal, transparent, local, interlaced in frames:
        flags = (disposal << 2) | (1 if transparent is not None else 0)
        out += b"\x21\xf9\x04" + struct.pack(
            "<BHB", flags, 4, transparent or 0) + b"\x00"
        fh, fw = idx.shape
        desc = 0x40 if interlaced else 0
        if local is not None:
            desc |= 0x80 | 1
        out += b"\x2c" + struct.pack("<HHHHB", left, top, fw, fh, desc)
        if local is not None:
            out += local.tobytes()
        rows = idx
        if interlaced:
            order = (list(range(0, fh, 8)) + list(range(4, fh, 8))
                     + list(range(2, fh, 4)) + list(range(1, fh, 2)))
            rows = idx[order]
        out.append(2)
        lzw = jgif._lzw_encode_py(np.ascontiguousarray(rows).reshape(-1), 2)
        for i in range(0, len(lzw), 255):
            out.append(len(lzw[i:i + 255]))
            out += lzw[i:i + 255]
        out.append(0)
    return bytes(out + b"\x3b")


def test_gif_disposal_transparency_and_interlace_equal_jax():
    rng = np.random.default_rng(5)
    local = np.array([[9, 9, 9], [200, 100, 50], [1, 2, 3], [7, 77, 177]],
                     np.uint8)
    frames = [
        (rng.integers(0, 4, (10, 12)).astype(np.uint8), 0, 0, 1, None,
         None, False),
        (rng.integers(0, 4, (4, 5)).astype(np.uint8), 3, 2, 2, 1, None,
         False),                                   # restore to background
        (rng.integers(0, 4, (6, 7)).astype(np.uint8), 1, 1, 3, 0, local,
         True),                                    # restore to previous
        (rng.integers(0, 4, (9, 3)).astype(np.uint8), 8, 0, 0, 2, None,
         True),
        (rng.integers(0, 4, (2, 2)).astype(np.uint8), 0, 8, 1, None, None,
         False),
    ]
    for version in (b"GIF89a", b"GIF87a"):
        data = _crafted_gif(frames, version=version)
        got, want = pgif.decode_animated(data), jgif.decode_animated(data)
        assert got.frame_count == want.frame_count == 5
        assert got.delays == want.delays and got.loop_count == 5
        for a, b in zip(got.frames, want.frames):
            np.testing.assert_array_equal(a, b)
        # frame 1's region, cleared to the background, shows through
        # frame 2's transparent pixels
        assert (got.frames[2][..., 3] == 0).any()
        assert pgif.get_info(data) == pgif.GifInfo(12, 10, 5, 5)


def test_gif_decode_limits_and_errors_match_jax():
    data = pgif.encode(INPUTS["photo"], dither="none")
    small = pgif.DecodeLimits(max_width=8)
    for mod, lim in ((pgif, small), (jgif, jgif.DecodeLimits(max_width=8))):
        with pytest.raises(ValueError, match="decode limits"):
            mod.decode_animated(data, lim)
    for bad in (b"GIF89a" + bytes(3), b"PNG..."):
        with pytest.raises((ValueError, struct.error)):
            pgif.decode(bad)
    with pytest.raises(pgif.GifError):
        pgif._lzw_decode_py(bytes([0xFF, 0xFF, 0xFF]), 2, 100)


LZW_CASES = [
    (np.zeros(300, np.uint8), 2),                                 # KwKwK
    (np.random.default_rng(7).integers(0, 4, 64).astype(np.uint8), 2),
    (np.random.default_rng(8).integers(0, 256, 30000).astype(np.uint8), 8),
    (np.tile(np.arange(256, dtype=np.uint8), 100), 8),            # resets
    (np.zeros(0, np.uint8), 4),
]


@pytest.mark.parametrize("case", range(len(LZW_CASES)))
def test_lzw_library_and_fallbacks_agree_with_jax(case):
    data, mcs = LZW_CASES[case]
    enc = pgif._lzw_encode(data, mcs)
    assert enc == pgif._lzw_encode_py(data, mcs) == jgif._lzw_encode(data,
                                                                     mcs)
    np.testing.assert_array_equal(pgif._lzw_decode(enc, mcs, len(data)),
                                  data)
    np.testing.assert_array_equal(pgif._lzw_decode_py(enc, mcs, len(data)),
                                  data)


def test_gif_decode_without_the_library_equals_with_it(monkeypatch):
    data = pgif.encode_animated([_photo(17, 23, 1), _photo(17, 23, 2)],
                                [5, 5], dither="atkinson")
    want = pgif.decode_animated(data)
    monkeypatch.setattr(pgif, "get_lib", lambda: None)
    got = pgif.decode_animated(data)
    for a, b in zip(got.frames, want.frames):
        np.testing.assert_array_equal(a, b)
    assert pgif.encode(INPUTS["gradient"], dither="none") == \
        jgif.encode(INPUTS["gradient"], dither="none")


@pytest.mark.parametrize("dtype", ["Gray", "Rgb", "Rgba"])
def test_image_load_and_save_gif_equal_jax(tmp_path, dtype):
    arr = _photo(20, 26, 3)
    pimg = zp.Image.from_numpy(arr.copy(), device=CPU).convert(
        getattr(zp, dtype))
    jimg = jz.Image.from_numpy(arr.copy()).convert(getattr(jz, dtype))
    pimg.save(str(tmp_path / "p.gif"))
    jimg.save(str(tmp_path / "j.gif"))
    assert (tmp_path / "p.gif").read_bytes() == \
        (tmp_path / "j.gif").read_bytes()
    back = zp.Image.load(str(tmp_path / "p.gif"), device=CPU)
    want = jz.Image.load(str(tmp_path / "j.gif"))
    assert back.dtype is zp.Rgba and want.dtype is jz.Rgba
    np.testing.assert_array_equal(back.to_numpy(), want.to_numpy())
    data = (tmp_path / "p.gif").read_bytes()
    np.testing.assert_array_equal(
        zp.Image.load_from_bytes(data, device=CPU).to_numpy(),
        want.to_numpy())
    from zignal_tpu_torch import codecs as pc

    assert pc.detect_format(data) is pc.ImageFormat.GIF
    np.testing.assert_array_equal(pc.load_array(str(tmp_path / "p.gif")),
                                  want.to_numpy())


def test_animated_image_is_exported():
    assert zp.AnimatedImage is pgif.AnimatedImage
    anim = zp.AnimatedImage([np.zeros((2, 2, 4), np.uint8)], [3])
    assert anim.frame_count == 1 and anim.loop_count == 0
