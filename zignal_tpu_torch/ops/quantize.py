"""Color quantization: median-cut adaptive palettes, fixed palettes, and
the 32x32x32 5-bit RGB lookup table (reference: src/image/quantize.zig).

Host-side (display/GIF path): the LUT build and median cut run in the
native library (``zt_clt_build``, ``zt_median_cut``), with numpy fallbacks
(``_clt_table_py``, ``_median_cut_py``) when it cannot be built; the LUT
fallback computes all 32768 cells' distances to the palette at once with
the reference's tie-break score ``(dist << 8) | index``.

Copied from zignal_tpu/ops/quantize.py, on the port's own library
(zignal_tpu_torch/native.py); each fallback is a function of its own so
that a caller can tell which path ran.
"""

from __future__ import annotations

import ctypes
import heapq

import numpy as np

from ..native import get_lib

__all__ = ["ColorLookupTable", "median_cut", "build_palette",
           "fixed_6x7x6_palette", "web216_palette", "VGA16_PALETTE",
           "PaletteMode"]

QUANTIZE_BITS = 5

VGA16_PALETTE = np.array([
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
    (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
    (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
], dtype=np.uint8)


def fixed_6x7x6_palette() -> np.ndarray:
    """252-color 6x7x6 palette (quantize.zig fixed6x7x6Palette)."""
    out = np.empty((252, 3), dtype=np.uint8)
    i = 0
    for r in range(6):
        for g in range(7):
            for b in range(6):
                out[i] = ((r * 255 + 2) // 5, (g * 255 + 3) // 6, (b * 255 + 2) // 5)
                i += 1
    return out


def web216_palette() -> np.ndarray:
    out = np.empty((216, 3), dtype=np.uint8)
    i = 0
    for r in range(6):
        for g in range(6):
            for b in range(6):
                out[i] = (r * 51, g * 51, b * 51)
                i += 1
    return out


class PaletteMode:
    """Palette strategy names (quantize.zig PaletteMode)."""

    FIXED_6X7X6 = "fixed_6x7x6"
    FIXED_VGA16 = "fixed_vga16"
    FIXED_WEB216 = "fixed_web216"
    ADAPTIVE = "adaptive"


class ColorLookupTable:
    """5-bit RGB cube -> nearest palette index
    (quantize.zig ColorLookupTable:62-168)."""

    __slots__ = ("palette", "table")

    def __init__(self, palette: np.ndarray):
        self.palette = np.asarray(palette, dtype=np.uint8)
        lib = get_lib()
        if lib is not None and self.palette.ndim == 2 \
                and self.palette.shape[1] == 3:
            table = np.empty(32 * 32 * 32, np.uint8)
            pal = np.ascontiguousarray(self.palette)
            rc = lib.zt_clt_build(
                pal.ctypes.data_as(ctypes.c_char_p), len(pal),
                table.ctypes.data_as(ctypes.c_char_p))
            if rc == 0:
                self.table = table.reshape(32, 32, 32)
                return
        self.table = _clt_table_py(self.palette)

    def lookup(self, rgb) -> int:
        r, g, b = int(rgb[0]) >> 3, int(rgb[1]) >> 3, int(rgb[2]) >> 3
        return int(self.table[r, g, b])

    def lookup_array(self, arr: np.ndarray) -> np.ndarray:
        """[.., 3] u8 -> [..] palette indices."""
        return self.table[arr[..., 0] >> 3, arr[..., 1] >> 3, arr[..., 2] >> 3]


def _clt_table_py(palette: np.ndarray) -> np.ndarray:
    """The [32, 32, 32] nearest-index table in numpy (zt_clt_build's
    fallback)."""
    q = np.arange(32, dtype=np.int32)
    c8 = (q << 3) | (q >> 2)  # cell center reconstruction to 8-bit
    rr, gg, bb = np.meshgrid(c8, c8, c8, indexing="ij")
    cells = np.stack([rr, gg, bb], axis=-1).reshape(-1, 3)  # [32768, 3]
    # |c - p|^2 = |c|^2 + |p|^2 - 2 c.p in FLOAT32: every term is an
    # integer < 2^24 (max 3*255^2), so f32 BLAS sgemm is bit-exact
    # while running ~10x faster than the int32 path numpy lowers to
    # scalar loops; chunking keeps each [4096, n] distance block in
    # cache for the argmin. np.argmin takes the FIRST minimum,
    # matching the reference's (dist << 8) | index lowest-index
    # tie-break (quantize.zig:62)
    pal = palette.astype(np.float32)
    cf = cells.astype(np.float32)
    pp = (pal * pal).sum(axis=1)[None, :]
    palT = np.ascontiguousarray(pal.T)
    idx = np.empty(cells.shape[0], np.uint8)
    for o in range(0, cells.shape[0], 4096):
        blk = cf[o:o + 4096]
        dist = (blk * blk).sum(axis=1)[:, None] + pp - 2.0 * (blk @ palT)
        idx[o:o + 4096] = np.argmin(dist, axis=1).astype(np.uint8)
    return idx.reshape(32, 32, 32)


def median_cut(arr: np.ndarray, max_colors: int) -> np.ndarray:
    """Adaptive palette from [H, W, 3] u8 (quantize.zig medianCut:175-410).

    Colors are first binned to the 5-bit cube; boxes split at the weighted
    median of their largest dimension, prioritized by volume*population.
    """
    a = arr.reshape(-1, 3)
    lib = get_lib()
    if lib is not None and len(a) > 0:
        pal = np.empty((min(max_colors, 256), 3), np.uint8)
        src = np.ascontiguousarray(a, dtype=np.uint8)
        rc = lib.zt_median_cut(
            src.ctypes.data_as(ctypes.c_char_p), len(a),
            min(max_colors, 256), pal.ctypes.data_as(ctypes.c_char_p))
        if rc > 0:
            return pal[:rc].copy()
    return _median_cut_py(a, max_colors)


def _median_cut_py(a: np.ndarray, max_colors: int) -> np.ndarray:
    """median_cut of [N, 3] u8 colours in numpy (zt_median_cut's
    fallback)."""
    keys = ((a[:, 0].astype(np.int64) >> 3) << 10) | \
           ((a[:, 1].astype(np.int64) >> 3) << 5) | (a[:, 2].astype(np.int64) >> 3)
    uniq, counts = np.unique(keys, return_counts=True)
    r5 = (uniq >> 10) & 0x1F
    g5 = (uniq >> 5) & 0x1F
    b5 = uniq & 0x1F
    # int32 throughout: half the memory traffic of int64 in the
    # sort/gather loop; population sums stay < 2^31 for any real image
    colors = np.stack([(r5 << 3) | (r5 >> 2), (g5 << 3) | (g5 >> 2),
                       (b5 << 3) | (b5 >> 2)], axis=-1).astype(np.int32)
    counts = counts.astype(np.int32)
    palette_size = min(len(colors), max_colors, 256)
    if palette_size == 0:
        raise ValueError("no colors to quantize")
    if len(colors) == 1:
        return colors.astype(np.uint8)

    def make_box(cols, cnts, pop=None):
        """Stats are cached per box — recomputing them for every box on
        every iteration made the loop O(boxes^2) in numpy calls."""
        lo = cols.min(axis=0)
        hi = cols.max(axis=0)
        splittable = len(cols) > 1 and bool((hi > lo).any())
        if pop is None:
            pop = int(cnts.sum())
        score = int(np.prod(hi - lo + 1)) * pop if splittable else 0
        return (cols, cnts, lo, hi, score, pop)

    # max-heap on (score, seq): seq is a deterministic tie-break that
    # replicates the old linear max() (first-inserted wins ties is NOT
    # what max() did — max() keeps the earliest index among equals, and
    # heap insertion order preserves that for our push order)
    boxes = []
    heap = []
    seq = 0

    def push(box):
        nonlocal seq
        boxes.append(box)
        heapq.heappush(heap, (-box[4], seq, len(boxes) - 1))
        seq += 1

    push(make_box(colors, counts))
    n_live = 1
    dead = set()
    while n_live < palette_size and heap:
        neg_score, _, bi = heapq.heappop(heap)
        if bi in dead:
            continue
        if -neg_score == 0:
            heapq.heappush(heap, (neg_score, seq, bi))  # keep the leaf
            break
        cols, cnts, lo, hi, _, pop = boxes[bi]
        dead.add(bi)
        n_live -= 1
        dim = int(np.argmax(hi - lo))
        order = np.argsort(cols[:, dim], kind="stable")
        cols, cnts = cols[order], cnts[order]
        half = pop // 2
        acc = np.cumsum(cnts)
        cut = int(np.argmax(acc >= half)) + 1
        cut = max(1, min(cut, len(cols) - 1))
        left_pop = int(acc[cut - 1])
        push(make_box(cols[:cut], cnts[:cut], left_pop))
        push(make_box(cols[cut:], cnts[cut:], pop - left_pop))
        n_live += 2
    boxes = [b for i, b in enumerate(boxes) if i not in dead]

    palette = np.zeros((len(boxes), 3), dtype=np.uint8)
    for i, (cols, cnts, *_rest) in enumerate(boxes):
        w = cnts.astype(np.uint64)
        palette[i] = (cols.astype(np.uint64) * w[:, None]).sum(axis=0) // w.sum()
    return palette


def build_palette(arr: np.ndarray, mode: str = PaletteMode.ADAPTIVE,
                  max_colors: int = 256) -> np.ndarray:
    """Palette per mode (quantize.zig buildPalette:502-530)."""
    if mode == PaletteMode.FIXED_6X7X6:
        return fixed_6x7x6_palette()
    if mode == PaletteMode.FIXED_VGA16:
        return VGA16_PALETTE.copy()
    if mode == PaletteMode.FIXED_WEB216:
        return web216_palette()
    if mode == PaletteMode.ADAPTIVE:
        return median_cut(arr, max_colors)
    raise ValueError(f"unknown palette mode {mode!r}")
