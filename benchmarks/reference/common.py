"""The u8 arithmetic that the north star and the filter chain share, as
the upstream library defines it: MIRROR borders, 8.8 fixed-point taps
from an f32 Gaussian, int32 sums and a symmetric rounding division."""

from __future__ import annotations

import numpy as np
import torch

SCALE = 256  # 8.8 fixed point, for the resize and the blur taps


def mirror(idx, n: int) -> np.ndarray:
    """MIRROR-resolved positions of ``idx`` on an axis of length ``n``
    (..., 2, 1, 0, 1, 2, ..., n-2, n-1, n-2, ...)."""
    idx = np.asarray(idx, dtype=np.int64)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m >= n, period - m, m)


def gaussian_taps(sigma: float) -> np.ndarray:
    """The 8.8 taps of a Gaussian of radius ceil(3 sigma): the kernel
    normalised in f32, times 256, rounded half to even."""
    f32 = np.float32
    s = f32(sigma)
    radius = int(np.ceil(f32(3) * s))
    x = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    k = np.exp(-(x * x) / (f32(2) * s * s)).astype(f32)
    k = (k / k.sum()).astype(f32)
    return np.round(k * f32(SCALE)).astype(np.int32)


def div_round_u8(acc, scale: int):
    """``acc / scale`` rounded half away from zero, clamped to u8."""
    half = scale // 2
    rounded = torch.where(acc >= 0, acc + half, acc - half)
    q = torch.div(rounded.abs(), scale, rounding_mode="floor")
    return torch.where(rounded < 0, -q, q).clamp(0, 255).to(torch.uint8)


def _pass(x, taps: np.ndarray, axis: int):
    """One int32 pass of ``taps`` along ``axis`` with MIRROR borders."""
    n, r = x.shape[axis], len(taps) // 2
    pos = np.arange(n)
    total = None
    for k, w in enumerate(taps.tolist()):
        if w == 0:
            continue
        src = torch.from_numpy(mirror(pos + k - r, n)).to(x.device)
        term = x.index_select(axis, src) * w
        total = term if total is None else total + term
    return total


def blur_u8(x, sigma: float):
    """Gaussian blur of u8 ``[..., H, W, C]``: a width and a height pass
    of the 8.8 taps in int32, then divided by 256^2 and rounded."""
    if sigma == 0:
        return x
    taps = gaussian_taps(sigma)
    acc = _pass(_pass(x.to(torch.int32), taps, x.ndim - 2), taps, x.ndim - 3)
    return div_round_u8(acc, SCALE * SCALE)
