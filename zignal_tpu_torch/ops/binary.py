"""Histograms, LUTs, Otsu, binary threshold and morphology (reference:
src/image/binary.zig), the counterpart of zignal_tpu/ops/binary.py.

Histogram counts are integer ``bincount``s (exact in any order, so the
card's atomics give the JAX package's counts); a LUT is an index gather.
The JAX package's nibble one-hot einsums exist to get these integers from
the TPU's matrix unit and are not carried over. Otsu's 256-entry variance
sweep runs on the host in f64, op for op as the JAX package runs it.

Morphology with the square all-ones structuring element is two separable
min/max passes with zero padding (background), on ``[..., H, W]`` planes:
dilate ignores out-of-bounds pixels, erode treats them as background.
The adaptive mean threshold compares each pixel with its clamped-window
mean, formed from exact window sums by the JAX package's rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .integral import _box_sums_exact, _mean_f32, _quot_rem, sums_fit_f32

__all__ = ["histogram256", "histogram256_multi", "histogram256_batch",
           "lut_apply_u8", "lut_apply_u8_per_channel", "otsu_threshold",
           "otsu_from_hists", "threshold_apply", "dilate", "erode",
           "open_morph", "close_morph", "adaptive_mean_threshold",
           "adaptive_from_sums"]


def histogram256(plane, weights=None):
    """int32 [256] histogram of a u8/int plane of any shape; ``weights``
    (same shape, small non-negative ints) makes it a weighted count.
    Values outside [0, 255] are not counted, as in the JAX package."""
    x = plane.reshape(-1).to(torch.int64)
    valid = (x >= 0) & (x < 256)
    w = valid.to(torch.int64)
    if weights is not None:
        w = w * weights.reshape(-1).to(torch.int64)
    counts = torch.zeros(256, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, torch.where(valid, x, 0), w)
    return counts.to(torch.int32)


def histogram256_batch(arr):
    """[B, ..., C] u8 -> int32 [B, C, 256]: each image's per-channel
    histograms in one ``bincount`` over ``x + 256 * (c + C * b)``."""
    b, c = arr.shape[0], arr.shape[-1]
    x = arr.reshape(b, -1, c).to(torch.int64)
    offs = 256 * torch.arange(b * c, device=arr.device,
                              dtype=torch.int64).reshape(b, 1, c)
    counts = torch.bincount((x + offs).reshape(-1), minlength=256 * b * c)
    return counts.reshape(b, c, 256).to(torch.int32)


def histogram256_multi(arr):
    """[..., C] u8 -> int32 [C, 256] per-channel histograms."""
    return histogram256_batch(arr.reshape(1, -1, arr.shape[-1]))[0]


def lut_apply_u8(plane, lut):
    """``lut[plane]`` for a u8/int plane and a [256] or [256, C] u8 LUT
    (out ``plane.shape`` or ``plane.shape + (C,)``)."""
    return lut.to(torch.uint8)[plane.to(torch.int64)]


def lut_apply_u8_per_channel(arr, luts):
    """``out[..., c] = luts[..., c, arr[..., c]]`` for u8 ``arr [..., C]``
    and ``luts [C, 256]``, or ``[B, C, 256]`` for a batch ``[B, ..., C]``
    (one table per image and channel)."""
    luts = luts.to(torch.uint8)
    c = arr.shape[-1]
    if luts.ndim == 2:
        return luts[torch.arange(c, device=arr.device), arr.to(torch.int64)]
    b = arr.shape[0]
    flat = luts.reshape(b * c, 256)
    row = (torch.arange(b, device=arr.device)[:, None] * c
           + torch.arange(c, device=arr.device)[None, :])
    row = row.reshape((b,) + (1,) * (arr.ndim - 2) + (c,))
    return flat[row, arr.to(torch.int64)]


def otsu_from_hists(hists) -> np.ndarray:
    """Otsu's between-class-variance maximisation (binary.zig:38-85) over
    histograms ``[..., 256]``, on the host in f64 (the JAX package's math,
    op for op): int32 thresholds ``[...]``."""
    hists = np.asarray(hists, dtype=np.float64)
    total = hists.sum(axis=-1, keepdims=True)
    intensities = np.arange(256, dtype=np.float64)
    sum_total = (hists * intensities).sum(axis=-1, keepdims=True)
    wb = hists.cumsum(axis=-1)
    sb = (hists * intensities).cumsum(axis=-1)
    wf = total - wb
    valid = (wb > 0) & (wf > 0)
    mean_b = sb / np.where(wb == 0, 1, wb)
    mean_f = (sum_total - sb) / np.where(wf == 0, 1, wf)
    variance = wb * wf * (mean_b - mean_f) ** 2
    variance = np.where(valid, variance, -1.0)
    return variance.argmax(axis=-1).astype(np.int32)


def otsu_threshold(plane) -> int:
    """Otsu threshold of a u8 [H, W] plane, as a Python int: the histogram
    on the plane's device, the sweep on the host."""
    return int(otsu_from_hists(histogram256(plane).cpu().numpy()))


def threshold_apply(plane, threshold):
    """255 where ``plane > threshold``, else 0, compared in f32 as the
    JAX package compares a u8 plane with a float: ``threshold`` is
    rounded to f32, never to an integer."""
    thr = float(np.float32(threshold))
    return (plane.to(torch.float32) > thr).to(torch.uint8) * 255


def _pool_pass(mask, ksize: int, is_max: bool, axis: int):
    """Separable window max/min with zero (background) padding."""
    half = ksize // 2
    n = mask.shape[axis]
    shape = list(mask.shape)
    shape[axis] = half
    zeros = mask.new_zeros(shape)
    padded = torch.cat([zeros, mask, zeros], dim=axis)
    op = torch.maximum if is_max else torch.minimum
    acc = padded.narrow(axis, 0, n)
    for k in range(1, ksize):
        acc = op(acc, padded.narrow(axis, k, n))
    return acc


def _pool(mask, ksize: int, is_max: bool):
    return _pool_pass(_pool_pass(mask, ksize, is_max, -2), ksize, is_max, -1)


def _morph(plane, ksize: int, iterations: int, order):
    m = (plane != 0).to(torch.uint8)
    for is_max in order:
        for _ in range(iterations):
            m = _pool(m, ksize, is_max)
    return m * 255


def dilate(plane, ksize: int = 3, iterations: int = 1):
    return _morph(plane, ksize, iterations, (True,))


def erode(plane, ksize: int = 3, iterations: int = 1):
    return _morph(plane, ksize, iterations, (False,))


def open_morph(plane, ksize: int = 3, iterations: int = 1):
    return _morph(plane, ksize, iterations, (False, True))


def close_morph(plane, ksize: int = 3, iterations: int = 1):
    return _morph(plane, ksize, iterations, (True, False))


def adaptive_mean_threshold(plane, radius: int, c: float):
    """255 where ``plane > window_mean - c``, else 0 (binary.zig:86-118),
    for a u8 ``[..., H, W]`` plane. The mean is the JAX package's
    (integral.py ``_mean_parts``): ``sums * f32(1 / area)`` where its
    window sums are f32, else ``q + rem * f32(1 / area)`` from the exact
    integer quotient and remainder."""
    sums, area = _box_sums_exact(plane[..., None], int(radius))
    return adaptive_from_sums(
        plane, sums, area,
        sums_fit_f32(plane.shape[-2], plane.shape[-1], int(radius)), c)


def adaptive_from_sums(plane, sums, area, fits: bool, c: float):
    """The threshold of ``plane`` from its exact window sums ``[..., H, W,
    1]`` and areas, the mean in the form ``fits`` picks."""
    if fits:
        mean = _mean_f32(sums, area)
    else:
        q, rem, _ = _quot_rem(sums, area)
        mean = q.to(torch.float32) + _mean_f32(rem, area)
    thr = mean[..., 0] - float(np.float32(c))
    return (plane.to(torch.float32) > thr).to(torch.uint8) * 255
