"""Image pyramid for multi-scale detection (reference:
src/image/pyramid.zig), the counterpart of zignal_tpu/ops/pyramid.py.

Level 0 is the source plane. One u8 Gaussian blur of the source (the
separable kernel on a card), then each level is a bilinear resize of the
blurred plane (the fused resize kernel on a card) to
``max(1, trunc(h / scale_factor**i))`` rows and likewise columns. A
``[B, H, W]`` stack of planes builds its levels together: one blur launch
and one resize launch a level on a card, not one a plane.
"""

from __future__ import annotations

import numpy as np

from ..enums import Interpolation
from .convolution import gaussian_blur
from .interpolation import resize

__all__ = ["ImagePyramid"]


class ImagePyramid:
    """Multi-scale levels of a u8 ``[..., H, W]`` plane (leading dims are
    a batch of planes); level 0 is the source."""

    def __init__(self, levels, scale_factor: float, blur_sigma: float):
        self.levels = levels  # list of u8 [..., H, W] tensors
        self.scale_factor = scale_factor
        self.blur_sigma = blur_sigma

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @classmethod
    def build(cls, plane, n_levels: int = 8, scale_factor: float = 1.2,
              blur_sigma: float = 1.6) -> "ImagePyramid":
        """plane: u8 ``[..., H, W]`` tensor on any device."""
        if n_levels < 1 or scale_factor <= 1.0:
            raise ValueError("need n_levels >= 1 and scale_factor > 1")
        h, w = plane.shape[-2:]
        levels = [plane]
        blurred = gaussian_blur(plane[..., None], blur_sigma)
        for i in range(1, n_levels):
            scale = scale_factor ** i
            rows = max(1, int(np.trunc(h / scale)))
            cols = max(1, int(np.trunc(w / scale)))
            levels.append(resize(blurred, rows, cols,
                                 Interpolation.BILINEAR)[..., 0])
        return cls(levels, scale_factor, blur_sigma)

    def scale_of(self, level: int) -> float:
        return self.scale_factor ** level

    def to_original(self, level: int, x: float, y: float):
        """Map level coordinates to original-image coordinates
        (pyramid.zig:125-140)."""
        s = self.scale_of(level)
        return (x * s, y * s)

    def to_level(self, level: int, x: float, y: float):
        s = self.scale_of(level)
        return (x / s, y / s)
