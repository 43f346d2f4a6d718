"""The least time an H100 could take for the colorspace deployment's two
stages, on the peaks of ``roofline.py``: K3's u8 sRGB -> f32 CIELAB route
and the equalization ahead of it. Frozen here with the configuration.

Each function returns ``(ms, "bytes" or "operations")``.
"""

from __future__ import annotations

from benchmarks.roofline import CBRTF_OPS, bound

# f32 ops a pixel of the rgb -> lab route past its input table (the sRGB
# curve is a lookup): the 3x3 mix (9 multiplies, 6 adds), x100 (3), the
# white point (3 multiplies), the epsilon compares (3), L (multiply,
# subtract, clamp), a and b (subtract and multiply each); and all three
# cube roots, though a channel under epsilon takes a multiply-add instead:
# an upper count
LAB_OPS = 15 + 3 + 3 + 3 + 3 + 2 + 2 + 3 * CBRTF_OPS


def k3_lab_bound(b: int, rows: int, cols: int):
    """u8 sRGB -> f32 Lab of ``b`` images of rows x cols: 3 bytes in and
    12 out a pixel, ``LAB_OPS`` operations."""
    pixels = b * rows * cols
    return bound(15 * pixels, LAB_OPS * pixels)


def equalize_bound(b: int, rows: int, cols: int, channels: int = 3):
    """Histogram equalization of ``b`` u8 images: each value read twice
    (the histograms, then the lookup) and written once; the histograms,
    tables and lookups are no more than a few operations a value."""
    values = b * rows * cols * channels
    return bound(3 * values, 4 * values)
