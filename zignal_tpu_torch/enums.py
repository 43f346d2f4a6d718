"""Public enums (reference: registered via bindings/python/src/main.zig:103-110).

Values follow the reference Zig enum field order.
"""

from __future__ import annotations

import enum

__all__ = ["Interpolation", "BorderMode", "DrawMode", "ThresholdMode"]


class Interpolation(enum.IntEnum):
    """Interpolation methods (reference: src/image/interpolation.zig:53-68)."""

    NEAREST = 0
    BILINEAR = 1
    BICUBIC = 2
    CATMULL_ROM = 3
    MITCHELL = 4
    LANCZOS = 5


class BorderMode(enum.IntEnum):
    """Border handling (reference: src/image/border.zig:10-27)."""

    ZERO = 0
    REPLICATE = 1
    MIRROR = 2
    WRAP = 3


class DrawMode(enum.IntEnum):
    """Canvas rendering mode (reference: src/canvas/Canvas.zig DrawMode)."""

    FAST = 0
    SOFT = 1


class ThresholdMode(enum.IntEnum):
    """Flood-fill threshold comparison mode
    (reference: src/image/flood_fill.zig FloodFillOptions.ThresholdMode)."""

    SEED = 0
    NEIGHBOR = 1
