"""Plain reference of the filter chain on u8 ``[..., H, W]`` planes:
Gaussian blur (MIRROR, 8.8 taps) -> unsharp mask ``2 x - box mean`` over
clamped windows -> threshold (> thr, compared in f32) -> 3x3 dilate ->
3x3 erode (zero outside the plane) -> u8 mask of 0 and 255.

The sharpen follows the upstream library's two forms: where its window
sums are exact in f32, the mean is ``sums * f32(1 / area)`` in f32 and
rounded half up; otherwise the integer quotient and remainder. ``dtype``
is the f32 form's precision: float32, or bfloat16 for the control."""

from __future__ import annotations

import numpy as np
import torch

from .common import blur_u8

_F32_EXACT = 1 << 24


def _digit_bound(row_sum: int, x_bound: int):
    """(bound, fits f32) of a band of entries <= 256 with largest row sum
    ``row_sum`` applied in base-256 digits to values in [0, x_bound]."""
    n_digits, b = 1, x_bound
    while b > 256:
        b //= 256
        n_digits += 1
    if n_digits == 1:
        xd_max = [min(256, x_bound)]
    else:
        xd_max = [min(255, x_bound // (256 ** j)) for j in range(n_digits)]
    total, fits = 0, True
    for j, xd in enumerate(xd_max):
        term = row_sum * xd * 256 ** j
        total += term
        fits = fits and term < _F32_EXACT
    return total, fits and total < _F32_EXACT


def sums_fit_f32(h: int, w: int, radius: int) -> bool:
    """Whether the window sums of an ``h x w`` plane take the f32 form."""
    rows, _ = _digit_bound(min(2 * radius + 1, h), 255)
    return _digit_bound(min(2 * radius + 1, w), rows)[1]


def _extent(n: int, radius: int) -> np.ndarray:
    i = np.arange(n)
    return (np.minimum(i + radius, n - 1) - np.maximum(i - radius, 0)
            + 1).astype(np.float32)


def _window_sums(x, radius: int):
    """Exact int64 sums of ``[..., H, W]`` over windows clamped to the
    plane."""
    for axis in (-2, -1):
        n = x.shape[axis]
        i = np.arange(n)
        lo = torch.from_numpy(np.maximum(i - radius, 0)).to(x.device)
        hi = torch.from_numpy(np.minimum(i + radius, n - 1) + 1).to(x.device)
        cs = torch.cumsum(x, dim=axis, dtype=torch.int64)
        shape = list(cs.shape)
        shape[axis] = 1
        cs = torch.cat([cs.new_zeros(shape), cs], dim=axis)
        x = cs.index_select(axis, hi) - cs.index_select(axis, lo)
    return x


def sharpen_u8(x, radius: int, dtype=torch.float32):
    """``2 x - box mean`` of u8 ``[..., H, W]``, rounded half up and
    clamped."""
    if radius == 0:
        return x
    h, w = x.shape[-2:]
    area = _extent(h, radius)[:, None] * _extent(w, radius)[None, :]
    sums = _window_sums(x, radius)
    if sums_fit_f32(h, w, radius):
        recip = torch.from_numpy(np.float32(1) / area).to(x.device, dtype)
        vals = 2 * x.to(dtype) - sums.to(dtype) * recip
        return torch.floor(vals + 0.5).clamp(0, 255).to(torch.uint8)
    a = torch.from_numpy(area.astype(np.int64)).to(x.device)
    q = torch.div(sums, a, rounding_mode="floor")
    rem = sums - q * a
    return (2 * x.to(torch.int64) - q - (2 * rem > a).to(torch.int64)) \
        .clamp(0, 255).to(torch.uint8)


def _pool3(m, op):
    """3x3 max or min of a 0/1 plane, zero outside it."""
    for axis in (-2, -1):
        n = m.shape[axis]
        shape = list(m.shape)
        shape[axis] = 1
        pad = torch.cat([m.new_zeros(shape), m, m.new_zeros(shape)], dim=axis)
        m = op(op(pad.narrow(axis, 0, n), pad.narrow(axis, 1, n)),
               pad.narrow(axis, 2, n))
    return m


def filter_chain(x, sigma: float, radius: int, thr: float,
                 dtype=torch.float32):
    """The chain on u8 ``[..., H, W]``; a u8 mask of 0 and 255."""
    s = sharpen_u8(blur_u8(x[..., None], sigma)[..., 0], radius, dtype)
    m = (s.to(torch.float32) > float(np.float32(thr))).to(torch.uint8)
    m = _pool3(_pool3(m, torch.maximum), torch.minimum)
    return m * 255
