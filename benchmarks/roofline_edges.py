"""The least time an H100 could take for the lane_hough request's work, on
the peaks of ``roofline.py``, whatever kernels implement it: each frame's
Canny edges, the Hough transform of the edges and its peaks. Frozen here
with the configuration. The votes are left out, since their number
depends on the frames: the bound is a floor.

Each function returns ``(ms, "bytes" or "operations")``.
"""

from __future__ import annotations

from benchmarks.roofline import bound

# a pixel of a frame: the Gaussian's two passes of 11 multiply-adds (sigma
# 1.4, radius 5; 2 ops each), Sobel's 12 taps, the magnitude (two
# products, a sum, a square root), the quantized NMS (about 12 compares
# and selects) and one hysteresis growth step (8 ORs of the 3x3 window
# and an AND)
GAUSS_OPS = 2 * 11 * 2
SOBEL_OPS = 12
MAGNITUDE_OPS = 4
NMS_OPS = 12
GROWTH_OPS = 9
PIXEL_OPS = GAUSS_OPS + SOBEL_OPS + MAGNITUDE_OPS + NMS_OPS + GROWTH_OPS
# a bin of an accumulator: the compares with its 8 neighbours
PEAK_OPS = 8


def request_bound(frames: int, rows: int, cols: int, size: int):
    """Canny, the Hough votes and the peaks of ``frames`` u8 frames of rows
    x cols with a size x size accumulator. Bytes: each frame read once,
    each u8 edge mask written once and read once, each u8 resized plane
    written once and read once, each int32 accumulator written once and
    read once. Operations: ``PIXEL_OPS`` a pixel, ``PEAK_OPS`` a bin."""
    pixels, bins = frames * rows * cols, frames * size * size
    nbytes = pixels + 2 * pixels + 2 * bins + 2 * 4 * bins
    ops = pixels * PIXEL_OPS + bins * PEAK_OPS
    return bound(nbytes, ops)
