"""The least time an H100 could take for the orb_stereo request's work, on
the peaks of ``roofline.py``, whatever kernels implement it: each frame's
ORB (the pyramid, FAST and the Harris map on every level, each
keypoint's orientation and descriptor) and the Hamming match of each
stereo pair. Frozen here with the configuration.

Each function returns ``(ms, "bytes" or "operations")``.
"""

from __future__ import annotations

import math

from benchmarks.roofline import bound

# a pixel of a level: FAST's 16 circle compares each way, and its arc
# test on the two 16-bit masks (16)
FAST_OPS = 16 * 2 + 16
# a pixel of a level: Harris's gradients (2 differences, 2 halvings), the
# three products, three 7x7 box sums by running sums (an add and a
# subtract a pass, two passes each), the response (det 2, trace 1,
# k trace^2 2, the difference 1)
HARRIS_OPS = 4 + 3 + 3 * 2 * 2 + 6
# a keypoint's orientation: each value of the radius-15 patch adds to the
# mass and, times its x and its y, to the two moments
PATCH_RADIUS = 15
PATCH_VALUES = sum(1 for y in range(-PATCH_RADIUS, PATCH_RADIUS + 1)
                   for x in range(-PATCH_RADIUS, PATCH_RADIUS + 1)
                   if x * x + y * y <= PATCH_RADIUS ** 2)
MOMENT_OPS = 1 + 2 + 2
# a keypoint's descriptor: 256 pairs of rotated samples (two coordinates
# of two multiply-adds each, a sample) and one compare
BRIEF_OPS = 256 * (2 * 2 * 2 * 2 + 1)
# a pair of 256-bit descriptors: 8 xors of 32-bit words, 8 popcounts and
# 8 adds
MATCH_OPS = 8 + 8 + 8


def level_shapes(rows: int, cols: int, scale: float, n_levels: int):
    """The pyramid's level sizes, level 0 the frame's."""
    return [(rows, cols)] + [
        (max(1, math.trunc(rows / scale ** i)),
         max(1, math.trunc(cols / scale ** i))) for i in range(1, n_levels)]


def request_bound(frames: int, rows: int, cols: int, n_features: int,
                  scale: float, n_levels: int):
    """ORB of ``frames`` u8 frames of rows x cols at ``n_features`` a
    frame, then a match of each of the ``frames / 2`` stereo pairs.
    Bytes: each frame read once, each further level written once and read
    once. Operations: ``FAST_OPS + HARRIS_OPS`` a pixel of every level,
    ``PATCH_VALUES * MOMENT_OPS + BRIEF_OPS`` a keypoint of the budget,
    ``MATCH_OPS`` a pair of descriptors."""
    shapes = level_shapes(rows, cols, scale, n_levels)
    pixels = sum(h * w for h, w in shapes)
    nbytes = frames * (rows * cols + 2 * (pixels - rows * cols))
    ops = (frames * pixels * (FAST_OPS + HARRIS_OPS)
           + frames * n_features * (PATCH_VALUES * MOMENT_OPS + BRIEF_OPS)
           + frames // 2 * n_features ** 2 * MATCH_OPS)
    return bound(nbytes, ops)
