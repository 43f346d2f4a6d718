"""Order-statistic blurs: median, percentile, min, max, midpoint and
alpha-trimmed mean (reference: src/image/order_statistic_blur.zig), the
counterpart of zignal_tpu/ops/order_stat.py.

Order statistics are exact, so the values are ported and not the JAX
package's sorting networks: each (2r+1)^2 window is gathered through
resolved tap indices into a trailing axis and sorted (``torch.sort``, or
``kthvalue`` for one rank), a few images at a time so the window stack
stays small. min and max are separable pools over the same taps.

Border rule: every tap contributes a value; out-of-bounds taps under ZERO
contribute 0 (order_statistic_blur.zig getPixel:338).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from .convolution import _tap_reader

__all__ = ["percentile_blur", "median_blur", "min_blur", "max_blur",
           "midpoint_blur", "alpha_trimmed_mean_blur"]

_STACK_ELEMS = 1 << 28  # window-stack elements gathered at a time


def _readers(arr, radius: int, border: BorderMode):
    """``read(x, k)`` along the rows and along the columns: the slab that
    tap ``k`` of the ``2r + 1`` window reads, 0 where a ZERO-border tap
    falls outside."""
    k = 2 * radius + 1
    return [_tap_reader(arr.shape[axis], k, border, axis, arr.device)
            for axis in (-3, -2)]


def _chunks(arr, k2: int):
    """``[..., H, W, C]`` -> views of ``[b, H, W, C]`` whose window stack
    of ``k2`` samples holds at most ``_STACK_ELEMS`` elements."""
    x = arr.reshape(-1, *arr.shape[-3:])
    per = max(1, _STACK_ELEMS // max(1, x[0].numel() * k2))
    return [x[i:i + per] for i in range(0, x.shape[0], per)]


def _window_stack(x, radius: int, border: BorderMode):
    """``[b, H, W, C]`` -> ``[b, H, W, C, k*k]`` window samples."""
    read_y, read_x = _readers(x, radius, border)
    k = 2 * radius + 1
    rows = [read_y(x, i) for i in range(k)]
    return torch.stack([read_x(r, j) for r in rows for j in range(k)], -1)


def _over_windows(arr, radius: int, border: BorderMode, reduce):
    """``reduce`` of each window stack chunk, concatenated back to
    ``arr``'s shape."""
    border = BorderMode(border)
    k2 = (2 * radius + 1) ** 2
    parts = [reduce(_window_stack(x, radius, border))
             for x in _chunks(arr, k2)]
    return torch.cat(parts).reshape(arr.shape)


def _rank_of(percentile: float, total: int) -> int:
    """reference: histogram.zig percentile():586-610."""
    rank_f = percentile * float(total - 1)
    rank = int(np.trunc(np.floor(rank_f + 1e-12)))
    return min(max(rank, 0), total - 1)


def _check(arr, radius: int):
    if arr.ndim < 3:
        raise ValueError("order-statistic blurs expect a [..., H, W, C] "
                         "tensor")
    if radius < 0:
        raise ValueError("radius must be non-negative")


def percentile_blur(arr, radius: int, percentile: float,
                    border: BorderMode = BorderMode.MIRROR):
    """The window value of rank ``_rank_of(percentile, (2r+1)^2)``."""
    radius = int(radius)
    _check(arr, radius)
    rank = _rank_of(percentile, (2 * radius + 1) ** 2)
    return _over_windows(
        arr, radius, border,
        lambda win: win.kthvalue(rank + 1, dim=-1).values)


def median_blur(arr, radius: int):
    return percentile_blur(arr, radius, 0.5, BorderMode.MIRROR)


def _pool(arr, radius: int, border: BorderMode, is_max: bool):
    """Separable window min or max over the border-resolved taps."""
    radius = int(radius)
    _check(arr, radius)
    op = torch.maximum if is_max else torch.minimum
    acc = arr
    for read in _readers(arr, radius, BorderMode(border)):
        src, acc = acc, read(acc, 0)
        for t in range(1, 2 * radius + 1):
            acc = op(acc, read(src, t))
    return acc


def min_blur(arr, radius: int, border: BorderMode = BorderMode.MIRROR):
    return _pool(arr, radius, border, is_max=False)


def max_blur(arr, radius: int, border: BorderMode = BorderMode.MIRROR):
    return _pool(arr, radius, border, is_max=True)


def midpoint_blur(arr, radius: int, border: BorderMode = BorderMode.MIRROR):
    """``(window_min + window_max + 1) // 2`` (MidpointReducer:357-364)."""
    lo = _pool(arr, radius, border, is_max=False).to(torch.int32)
    hi = _pool(arr, radius, border, is_max=True).to(torch.int32)
    return ((lo + hi + 1) // 2).to(arr.dtype)


def alpha_trimmed_mean_blur(arr, radius: int, trim_fraction: float,
                            border: BorderMode = BorderMode.MIRROR):
    """Mean of the window after trimming ``trim_each`` samples a side
    (AlphaTrimmedMeanReducer:366-410): the exact integer sum of the kept
    samples, ``floor((sum + n // 2) * f32(1 / n))``, at most 255 — the JAX
    package multiplies by the f32 reciprocal of the count, not divides."""
    radius = int(radius)
    _check(arr, radius)
    total = (2 * radius + 1) ** 2
    trim = min(int(np.trunc(np.floor(trim_fraction * total))), total // 2)
    count = total - 2 * trim
    recip = float(np.float32(1.0 / count))

    def reduce(win):
        kept = win.sort(dim=-1).values[..., trim:total - trim]
        s = kept.to(torch.int32).sum(-1).to(torch.float32)
        return torch.floor((s + count // 2) * recip).clamp(max=255)

    return _over_windows(arr, radius, border, reduce).to(torch.uint8)
