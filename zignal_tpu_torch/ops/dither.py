"""Dithering (reference: src/image/dither.zig): none, Floyd-Steinberg,
Atkinson, ordered (Bayer 8x8), with the sixel auto heuristic.

Ordered dithering is vectorized numpy on the host; error diffusion
(inherently sequential) runs in the native C++ core
(``zt_dither_error_diffusion``) with a Python fallback
(``_error_diffusion_py``).

Copied from zignal_tpu/ops/dither.py, on the port's own library
(zignal_tpu_torch/native.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import get_lib
from .quantize import ColorLookupTable

__all__ = ["DitherMode", "apply_dither", "resolve_auto"]

_BAYER8 = np.array([
    [0, 32, 8, 40, 2, 34, 10, 42],
    [48, 16, 56, 24, 50, 18, 58, 26],
    [12, 44, 4, 36, 14, 46, 6, 38],
    [60, 28, 52, 20, 62, 30, 54, 22],
    [3, 35, 11, 43, 1, 33, 9, 41],
    [51, 19, 59, 27, 49, 17, 57, 25],
    [15, 47, 7, 39, 13, 45, 5, 37],
    [63, 31, 55, 23, 61, 29, 53, 21],
], dtype=np.int32)


class DitherMode:
    NONE = "none"
    FLOYD_STEINBERG = "floyd_steinberg"
    ATKINSON = "atkinson"
    ORDERED = "ordered"
    AUTO = "auto"


def resolve_auto(palette_size: int, width: int, height: int) -> str:
    """Sixel auto heuristic (terminal/sixel.zig:156-165)."""
    if palette_size >= 128 and width * height >= 512 * 512:
        return DitherMode.NONE
    if palette_size <= 16:
        return DitherMode.ATKINSON
    return DitherMode.ORDERED


def _ordered(img: np.ndarray, palette: np.ndarray, lut: ColorLookupTable):
    h, w = img.shape[:2]
    offs = (_BAYER8 - 32) >> 1
    tiled = np.tile(offs, ((h + 7) // 8, (w + 7) // 8))[:h, :w]
    adjusted = np.clip(img.astype(np.int32) + tiled[..., None], 0, 255).astype(np.uint8)
    idx = lut.lookup_array(adjusted)
    img[:] = palette[idx]


def _error_diffusion_py(img, palette, lut, mode):
    taps = ([(1, 0, 7, 4), (-1, 1, 3, 4), (0, 1, 5, 4), (1, 1, 1, 4)]
            if mode == DitherMode.FLOYD_STEINBERG
            else [(1, 0, 1, 3), (2, 0, 1, 3), (-1, 1, 1, 3),
                  (0, 1, 1, 3), (1, 1, 1, 3), (0, 2, 1, 3)])
    h, w = img.shape[:2]
    buf = img.astype(np.int32)

    def div_trunc_pow2(v, s):
        return v >> s if v >= 0 else (v + (1 << s) - 1) >> s

    for r in range(h):
        for c in range(w):
            px = np.clip(buf[r, c], 0, 255)
            idx = int(lut.table[px[0] >> 3, px[1] >> 3, px[2] >> 3])
            q = palette[idx].astype(np.int32)
            err = px - q
            buf[r, c] = q
            for dx, dy, wt, sh in taps:
                nr, nc = r + dy, c + dx
                if 0 <= nr < h and 0 <= nc < w:
                    cur = np.clip(buf[nr, nc], 0, 255)
                    buf[nr, nc] = np.clip(
                        cur + np.array([div_trunc_pow2(int(e) * wt, sh) for e in err]),
                        0, 255,
                    )
    img[:] = np.clip(buf, 0, 255).astype(np.uint8)


def apply_dither(img: np.ndarray, palette: np.ndarray,
                 lut: ColorLookupTable | None = None,
                 mode: str = DitherMode.AUTO) -> np.ndarray:
    """In-place dither of a [H, W, 3] u8 array to palette colors;
    returns the palette-index array [H, W]."""
    palette = np.asarray(palette, dtype=np.uint8)
    if lut is None:
        lut = ColorLookupTable(palette)
    if mode == DitherMode.AUTO:
        mode = resolve_auto(len(palette), img.shape[1], img.shape[0])
    if mode == DitherMode.ORDERED:
        _ordered(img, palette, lut)
    elif mode in (DitherMode.FLOYD_STEINBERG, DitherMode.ATKINSON):
        lib = get_lib()
        if lib is not None and img.flags["C_CONTIGUOUS"]:
            flat_lut = np.ascontiguousarray(lut.table.reshape(-1))
            pal = np.ascontiguousarray(palette)
            lib.zt_dither_error_diffusion(
                img.ctypes.data_as(ctypes.c_char_p),
                img.shape[0], img.shape[1],
                pal.ctypes.data_as(ctypes.c_char_p), len(pal),
                flat_lut.ctypes.data_as(ctypes.c_char_p),
                0 if mode == DitherMode.FLOYD_STEINBERG else 1,
            )
        else:
            _error_diffusion_py(img, palette, lut, mode)
    elif mode != DitherMode.NONE:
        raise ValueError(f"unknown dither mode {mode!r}")
    return lut.lookup_array(img)
