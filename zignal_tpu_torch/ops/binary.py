"""Binary threshold and morphology (reference: src/image/binary.zig), the
counterpart of the threshold and morphology part of
zignal_tpu/ops/binary.py.

Morphology with the square all-ones structuring element is two separable
min/max passes with zero padding (background), on ``[..., H, W]`` planes:
dilate ignores out-of-bounds pixels, erode treats them as background.
Histograms, Otsu and the adaptive thresholds are ROADMAP items 8 and 12.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threshold_apply", "dilate", "erode", "open_morph",
           "close_morph"]


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
