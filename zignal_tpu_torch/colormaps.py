"""Colormaps: jet, heat, turbo, viridis, inferno
(reference: src/image/colormaps.zig).

LUT-based: 256-entry tables applied as a gather on the plane's device
after range normalization. jet/heat are evaluated from their dlib-ported
formulas, turbo from Google's polynomial approximation, viridis/inferno
from the committed CC0 matplotlib data (_colormap_data.py).

Copied from zignal_tpu/colormaps.py but for ``apply_plane``, which runs on
torch and rounds as either of the JAX package's two callers does
(``compiled=``).
"""

from __future__ import annotations

import numpy as np
import torch

from ._colormap_data import INFERNO_LUT, VIRIDIS_LUT

__all__ = ["Colormap"]


def _round(x):
    return int(np.floor(x + 0.5))


def _jet_eval(t: float):
    """dlib jet (colormaps.zig:94-121)."""
    gray = 8.0 * t
    s = 0.5
    if gray <= 1:
        return (0, 0, _round((gray + 1) * s * 255.0))
    if gray <= 3:
        return (0, _round((gray - 1) * s * 255.0), 255)
    if gray <= 5:
        return (_round((gray - 3) * s * 255.0), 255, _round((5 - gray) * s * 255.0))
    if gray <= 7:
        return (255, _round((7 - gray) * s * 255.0), 0)
    return (_round((9 - gray) * s * 255.0), 0, 0)


def _heat_eval(t: float):
    """dlib heat (colormaps.zig:133-146)."""
    r = _round(min(t / 0.4, 1.0) * 255.0)
    g = _round(min((t - 0.4) / 0.4, 1.0) * 255.0) if t > 0.4 else 0
    b = _round(min((t - 0.8) / 0.2, 1.0) * 255.0) if t > 0.8 else 0
    return (r, g, b)


def _turbo_eval(t: float):
    """Google's turbo polynomial (colormaps.zig:157-180)."""
    rc = (0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943)
    gc = (0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604)
    bc = (0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973)
    v = tuple(t**i for i in range(6))

    def dot(c):
        return _round(min(max(sum(a * b for a, b in zip(v, c)), 0.0), 1.0) * 255.0)

    return (dot(rc), dot(gc), dot(bc))


def _build_lut(eval_fn):
    return tuple(eval_fn(i / 255.0) for i in range(256))


_LUTS = {
    "jet": _build_lut(_jet_eval),
    "heat": _build_lut(_heat_eval),
    "turbo": _build_lut(_turbo_eval),
    "viridis": VIRIDIS_LUT,
    "inferno": INFERNO_LUT,
}


class Colormap:
    """Colormap configuration: type + optional value range
    (reference: bindings colormaps factory; Colormap.Range)."""

    __slots__ = ("type", "min", "max")

    def __init__(self, type_name: str, min=None, max=None):
        if type_name not in _LUTS:
            raise ValueError(f"unknown colormap {type_name!r}")
        self.type = type_name
        self.min = None if min is None else float(min)
        self.max = None if max is None else float(max)

    @classmethod
    def jet(cls, min=None, max=None):
        return cls("jet", min, max)

    @classmethod
    def heat(cls, min=None, max=None):
        return cls("heat", min, max)

    @classmethod
    def turbo(cls, min=None, max=None):
        return cls("turbo", min, max)

    @classmethod
    def viridis(cls, min=None, max=None):
        return cls("viridis", min, max)

    @classmethod
    def inferno(cls, min=None, max=None):
        return cls("inferno", min, max)

    def lut(self) -> np.ndarray:
        """[256, 3] uint8 lookup table."""
        return np.asarray(_LUTS[self.type], dtype=np.uint8)

    def apply_plane(self, plane: torch.Tensor, compiled: bool = False):
        """Map a u8 [..., H, W] plane -> [..., H, W, 3] rgb on its device
        via normalize + LUT gather (colormaps.zig per-map functions). The
        auto range is each [H, W] plane's own min and max.

        ``compiled`` picks the rounding of the JAX package's caller:
        ``Image.apply_colormap`` runs its ops one by one (a true division
        by the range), ``ImageBatch.apply_colormap`` compiles them, and
        XLA then multiplies by the f32 reciprocal of a fixed range (it
        differs at (0, 50), for one). A runtime (auto) range stays a
        division either way, and the multiply-add before the floor gives
        the same index whether it is contracted or not (every u8 input at
        every integer range and 20,000 float ranges)."""
        x = plane.to(torch.float32)
        fixed = self.min is not None and self.max is not None
        lo = (torch.tensor(self.min, dtype=torch.float32, device=x.device)
              if self.min is not None else x.amin(dim=(-2, -1), keepdim=True))
        hi = (torch.tensor(self.max, dtype=torch.float32, device=x.device)
              if self.max is not None else x.amax(dim=(-2, -1), keepdim=True))
        rng = torch.where(hi > lo, hi - lo, 1.0)
        if compiled and fixed:
            t = (x - lo) * (1.0 / rng)  # the reciprocal, rounded to f32
        else:
            t = (x - lo) / rng  # a device tensor: a true division
        t = torch.clamp(t, 0.0, 1.0)
        idx = torch.floor(t * 255.0 + 0.5).to(torch.int64)
        lut = torch.from_numpy(self.lut()).to(x.device)
        return lut[idx]

    def __repr__(self):
        return f"Colormap.{self.type}(min={self.min}, max={self.max})"
