"""Integral image, box blur and sharpen over clamped windows (reference:
src/image/integral.zig), the counterpart of zignal_tpu/ops/integral.py.

Window sums are exact int32 sums over the window clamped to the image;
the area is ``extent_h * extent_w`` in f32. Each op takes the JAX
package's branch by its rule: where ``exact_axis_apply`` reports that the
sums fit f32 (below 2^24), the f32 form; otherwise the integer
quotient/remainder form (zignal_tpu/ops/integral.py:100-108, 131-137).
Both are plain PyTorch ops on the tensor's device.

In the f32 form the JAX package writes ``sums / area``, but the area is a
constant of the compiled program and XLA rewrites the division into a
multiplication by the constant's f32 reciprocal. A true division differs
from that at a few pixels in 10^4 (3570 / 28 = 127.5 exactly, while
3570 * f32(1/28) = 127.50001 rounds the other way), so the port multiplies
by ``f32(1) / area`` too.

The JAX package's float paths read window sums off an f32 summed-area
table, which is exact only while every entry stays below 2^24 (for a
255-valued plane, about 256 x 256 pixels). The port's table is exact
wherever that one is and device-independent beyond it: int64 prefix sums
of an integer input, f64 of a float input, cast to f32 once
(``window_sums``).
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import extents, window_bounds

__all__ = ["integral_image", "window_sums", "box_blur", "sharpen"]

_F32_EXACT = 1 << 24


def _digit_bound(row_sum: int, x_bound: int):
    """(bound, fits f32) that zignal_tpu/ops/mxu_resample.py:_exact_core
    reports for a band of entries <= 256 and max row sum ``row_sum``
    applied to values in [0, x_bound]: its base-256 digit bound, term by
    term, copied op for op."""
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
    """Whether the JAX package's ``_box_sums_exact`` returns f32 sums for
    an ``[h, w]`` plane: its row pass bounds the column pass's input."""
    rows, _ = _digit_bound(min(2 * radius + 1, h), 255)
    return _digit_bound(min(2 * radius + 1, w), rows)[1]


def _accumulator(x):
    return torch.float64 if x.is_floating_point() else torch.int64


def window_sums(x, radius: int, axes=(-3, -2)):
    """Sums of ``x`` over the windows clamped to the plane spanned by
    ``axes``, by prefix sums per axis in int64 (integer ``x``: exact) or
    f64 (float ``x``); the result keeps that dtype."""
    for axis in axes:
        lo, hi = (torch.from_numpy(t).long().to(x.device)
                  for t in window_bounds(x.shape[axis], radius))
        cs = torch.cumsum(x, dim=axis, dtype=_accumulator(x))
        shape = list(cs.shape)
        shape[axis] = 1
        cs = torch.cat([cs.new_zeros(shape), cs], dim=axis)
        x = cs.index_select(axis, hi + 1) - cs.index_select(axis, lo)
    return x


def _area(h: int, w: int, radius: int):
    """f32 window areas ``[H, W, 1]`` (numpy)."""
    return (extents(h, radius)[:, None] * extents(w, radius)[None, :])[
        ..., None]


def _box_sums_exact(arr, radius: int):
    """Exact int32 window sums of u8 ``[..., H, W, C]`` and the f32 area
    ``[H, W, 1]`` as a numpy array."""
    sums = window_sums(arr, radius).to(torch.int32)
    return sums, _area(arr.shape[-3], arr.shape[-2], radius)


def _mean_f32(sums, area):
    """``sums / area`` as the JAX package's compiled program computes it:
    ``sums * f32(1 / area)``."""
    recip = torch.from_numpy(np.float32(1) / area).to(sums.device)
    return sums.to(torch.float32) * recip


def integral_image(arr):
    """SAT of ``[..., H, W, C]`` -> f32: ``sat[r, c]`` sums ``[0..r, 0..c]``,
    accumulated exactly (or in f64) and rounded to f32 once."""
    acc = _accumulator(arr)
    return arr.cumsum(-3, dtype=acc).cumsum(-2).to(torch.float32)


def _box_sums_float(arr, radius: int):
    """Clamped-window sums of a float ``[..., H, W, C]`` in f64, rounded
    to f32 once, and the f32 area ``[H, W, 1]`` (numpy)."""
    sums = window_sums(arr, radius).to(torch.float32)
    return sums, _area(arr.shape[-3], arr.shape[-2], radius)


def _check(arr, radius: int, op: str):
    if arr.is_complex():
        raise NotImplementedError(f"{op} of {arr.dtype} is not ported")
    if arr.ndim < 3:
        raise ValueError(f"{op} expects a [..., H, W, C] tensor")
    if radius < 0:
        raise ValueError("radius must be non-negative")


def _as_dtype(vals, dtype):
    """f32 ``vals`` in ``dtype`` as XLA converts: a float dtype rounded,
    an integer one truncated toward zero and saturated at its range."""
    if dtype.is_floating_point:
        return vals.to(dtype)
    if dtype == torch.bool:
        return vals != 0
    info = torch.iinfo(dtype)
    return vals.double().clamp(info.min, info.max).to(dtype)


def _quot_rem(sums, area):
    a = torch.from_numpy(area.astype(np.int32)).to(sums.device)
    q = sums // a
    return q, sums - q * a, a


def box_blur(arr, radius: int):
    """Box blur of ``[..., H, W, C]``: the clamped-window mean, rounded
    half up for u8, in the input's dtype for a float input; for another
    integer input the f32 mean converted as XLA converts (truncated,
    saturated), the JAX package's float route."""
    radius = int(radius)
    _check(arr, radius, "box_blur")
    if radius == 0:
        return arr
    if arr.dtype != torch.uint8:  # float, and the JAX package's float route
        return _as_dtype(_mean_f32(*_box_sums_float(arr, radius)), arr.dtype)
    sums, area = _box_sums_exact(arr, radius)
    if sums_fit_f32(arr.shape[-3], arr.shape[-2], radius):
        vals = torch.floor(_mean_f32(sums, area) + 0.5)
        return vals.clamp(0, 255).to(torch.uint8)
    q, rem, a = _quot_rem(sums, area)
    return (q + (2 * rem >= a).to(torch.int32)).clamp(0, 255) \
        .to(torch.uint8)


def sharpen(arr, radius: int):
    """Unsharp mask of ``[..., H, W, C]``: ``2 * x - box mean``; for u8
    ``floor(v + 0.5)``, clipped (integral.zig sharpen)."""
    radius = int(radius)
    _check(arr, radius, "sharpen")
    if radius == 0:
        return arr
    if arr.dtype != torch.uint8:  # float, and the JAX package's float route
        mean = _mean_f32(*_box_sums_float(arr, radius))
        return _as_dtype(2.0 * arr.to(torch.float32) - mean, arr.dtype)
    sums, area = _box_sums_exact(arr, radius)
    if sums_fit_f32(arr.shape[-3], arr.shape[-2], radius):
        vals = 2.0 * arr.to(torch.float32) - _mean_f32(sums, area)
        return torch.floor(vals + 0.5).clamp(0, 255).to(torch.uint8)
    q, rem, a = _quot_rem(sums, area)
    t2 = 2 * arr.to(torch.int32)
    return (t2 - q - (2 * rem > a).to(torch.int32)).clamp(0, 255) \
        .to(torch.uint8)
