"""MotionBlur configuration factory (reference:
bindings/python/src/motion_blur.zig; src/image/motion_blur.zig:12-56).

Copied from zignal_tpu/motion_blur.py; the blurs themselves are
ops/motion_blur_ops.py.
"""

from __future__ import annotations

__all__ = ["MotionBlur"]


class MotionBlur:
    """Factory for motion blur configurations; pass to Image.motion_blur."""

    __slots__ = ("kind", "angle", "distance", "center_x", "center_y", "strength")

    def __init__(self, kind, **kwargs):
        self.kind = kind
        self.angle = kwargs.get("angle", 0.0)
        self.distance = kwargs.get("distance", 0)
        self.center_x = kwargs.get("center_x", 0.5)
        self.center_y = kwargs.get("center_y", 0.5)
        self.strength = kwargs.get("strength", 0.5)

    @classmethod
    def linear(cls, angle: float = 0.0, distance: int = 10) -> "MotionBlur":
        """Straight-line motion blur; angle in radians."""
        distance = int(distance)
        if distance < 0:
            raise ValueError("distance must be non-negative")
        return cls("linear", angle=float(angle), distance=distance)

    @classmethod
    def radial_zoom(cls, center=(0.5, 0.5), strength: float = 0.5) -> "MotionBlur":
        return cls._radial("zoom", center, strength)

    @classmethod
    def radial_spin(cls, center=(0.5, 0.5), strength: float = 0.5) -> "MotionBlur":
        return cls._radial("spin", center, strength)

    @classmethod
    def _radial(cls, kind, center, strength):
        cx, cy = float(center[0]), float(center[1])
        strength = float(strength)
        if not (0.0 <= cx <= 1.0 and 0.0 <= cy <= 1.0):
            raise ValueError("center must be normalized to [0, 1]")
        if not 0.0 <= strength <= 1.0:
            raise ValueError("strength must be in [0, 1]")
        return cls(kind, center_x=cx, center_y=cy, strength=strength)

    def __repr__(self):
        if self.kind == "linear":
            return f"MotionBlur.linear(angle={self.angle:g}, distance={self.distance})"
        return (f"MotionBlur.radial_{self.kind}(center=({self.center_x:g}, "
                f"{self.center_y:g}), strength={self.strength:g})")
