"""Sixel encoder (reference: src/terminal/sixel.zig).

Pipeline: palette build (quantize) -> auto dither selection -> per-band
(6 rows) per-color bit columns -> RLE-compressed sixel stream. Band
encoding is vectorized numpy; optional Profile mirrors the reference's
per-stage timing struct (sixel.zig:59-105).

Copied from zignal_tpu/terminal/sixel.py, on the port's own library
(zignal_tpu_torch/native.py); the Python band emitter
(``_emit_bands_py``) stands in when it cannot be built.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..ops.dither import DitherMode, apply_dither, resolve_auto
from ..ops.quantize import ColorLookupTable, PaletteMode, build_palette

__all__ = ["SixelOptions", "Profile", "sixel_from_image", "sixel_from_array"]


@dataclasses.dataclass
class SixelOptions:
    palette: str = PaletteMode.ADAPTIVE
    max_colors: int = 256
    dither: str = DitherMode.AUTO


@dataclasses.dataclass
class Profile:
    """Per-stage nanoseconds (reference: sixel.zig Profile)."""

    palette_ns: int = 0
    lut_ns: int = 0
    convert_ns: int = 0
    dither_ns: int = 0
    emit_ns: int = 0


def _rle(chars: np.ndarray) -> str:
    """Run-length encode a row of sixel characters (!n<c> for runs > 3)."""
    out = []
    n = len(chars)
    i = 0
    # find run boundaries vectorized
    if n == 0:
        return ""
    changes = np.nonzero(np.diff(chars))[0] + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [n]])
    for s, e in zip(starts, ends):
        ch = chr(chars[s] + 63)
        run = e - s
        if run > 3:
            out.append(f"!{run}{ch}")
        else:
            out.append(ch * run)
    del i
    return "".join(out)


def _emit_bands_native(indices: np.ndarray) -> str | None:
    """Native band emitter (byte-identical to ``_emit_bands_py``; the
    per-(band, color) RLE in python was ~0.5 s per 512^2 frame)."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    h, w = indices.shape
    src = np.ascontiguousarray(indices, dtype=np.uint8)
    # the most a band can take: per colour used, "$#ddd" and at most one
    # char a column (a run "!n<c>" is never longer than the run), then
    # "-". The JAX package's cap, bands * (256 * 8 + 6 * w) + 1024, is
    # smaller for a busy image, whose bands then go to the Python emitter
    colours = min(int(src.max(initial=0)) + 1, 6 * w)
    cap = (h // 6 + 1) * (colours * (5 + w) + 1)
    # np.empty, not create_string_buffer: the latter zero-fills the
    # whole cap; .raw[:rc] would also materialize it in full (r4)
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.zt_sixel_emit(src.ctypes.data_as(ctypes.c_char_p), h, w,
                           out.ctypes.data_as(ctypes.c_char_p), cap)
    if rc < 0:
        return None
    return out[:rc].tobytes().decode("ascii")


def _emit_bands_py(indices: np.ndarray) -> str:
    """The sixel bands of [H, W] palette indices in numpy (zt_sixel_emit's
    fallback)."""
    h = indices.shape[0]
    out = []
    for band_start in range(0, h, 6):
        band = indices[band_start:band_start + 6]
        rows_in_band = band.shape[0]
        used = np.unique(band)
        first_color = True
        for color in used:
            # bits: per column, OR of (1 << row) where idx == color
            eq = band == color  # [rows, w]
            weights = (1 << np.arange(rows_in_band,
                                      dtype=np.uint8))[:, None]
            bits = (eq * weights).sum(axis=0).astype(np.uint8)
            if not first_color:
                out.append("$")  # carriage return within band
            first_color = False
            out.append(f"#{color}")
            # trim trailing zero-bit columns
            nz = np.nonzero(bits)[0]
            end = nz[-1] + 1 if len(nz) else 0
            out.append(_rle(bits[:end]))
        out.append("-")  # next band
    if out and out[-1] == "-":
        out.pop()
    return "".join(out)


def sixel_from_array(arr: np.ndarray, options: SixelOptions | None = None,
                     profile: Profile | None = None) -> str:
    """Encode a uint8 [H, W, 3] array as a sixel escape sequence."""
    options = options or SixelOptions()
    h, w = arr.shape[:2]

    t0 = time.perf_counter_ns()
    palette = build_palette(arr, options.palette, options.max_colors)
    t1 = time.perf_counter_ns()
    lut = ColorLookupTable(palette)
    t2 = time.perf_counter_ns()

    mode = options.dither
    if mode == DitherMode.AUTO:
        mode = resolve_auto(len(palette), w, h)
    work = np.ascontiguousarray(arr[..., :3]).copy()
    indices = apply_dither(work, palette, lut, mode)
    t3 = time.perf_counter_ns()

    out = [f'\x1bPq"1;1;{w};{h}']
    for i, p in enumerate(palette):
        r = (int(p[0]) * 100 + 127) // 255
        g = (int(p[1]) * 100 + 127) // 255
        b = (int(p[2]) * 100 + 127) // 255
        out.append(f"#{i};2;{r};{g};{b}")

    body = _emit_bands_native(indices)
    out.append(body if body is not None else _emit_bands_py(indices))
    out.append("\x1b\\")
    result = "".join(out)
    t4 = time.perf_counter_ns()
    if profile is not None:
        profile.palette_ns += t1 - t0
        profile.lut_ns += t2 - t1
        profile.dither_ns += t3 - t2
        profile.emit_ns += t4 - t3
    return result


def sixel_from_image(image, options: SixelOptions | None = None,
                     profile: Profile | None = None) -> str:
    from ..image import _convert_array_u8

    arr = _convert_array_u8(image._host(), image._space, "rgb")
    return sixel_from_array(arr, options, profile)
