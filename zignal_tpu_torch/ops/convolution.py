"""Separable and 2-D convolution, Gaussian blur and Sobel (reference:
src/image/convolution.zig, edges.zig), the counterpart of
zignal_tpu/ops/convolution.py.

The 8.8 fixed point of the reference: 1-D weights are ``round(k * 256)``
int32; the width pass accumulates int32 "temp" planes, the height pass
accumulates temp * weight, then divClampU8 divides by 256^2 with
symmetric rounding. There is no division between the passes.

Borders follow the band semantics of the JAX package's banded path
(``build_tap_matrix`` over ``resolve_index_np``): a ZERO-border tap that
falls outside the axis reads 0. On a CUDA tensor the two passes and the
epilogue are one kernel (ops/separable_conv.py); a CPU tensor runs the
plain PyTorch version below.

Float inputs accumulate their taps in the JAX package's order, skipping
zero weights, each multiply-add rounded once as XLA's CPU backend
contracts it (ops/fma.py). ``convolve2d`` is plain PyTorch on every
device: a u8 input sums int32 taps with a single 8.8 scale, exact where
the JAX package's f32 form is; ``F.conv2d`` is not used, since cuDNN's
summation order and TF32 would move the float result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..enums import BorderMode
from .fma import fma_sum
from .tables import SCALE, _kernel_to_int, border_tap_table, \
    build_tap_matrix, gaussian_kernel

__all__ = ["convolve_separable", "convolve_separable_reference",
           "gaussian_blur", "gaussian_blur_reference", "convolve2d",
           "sobel_magnitude", "sobel_gradients"]


def _div_clamp_u8(accum, scale: int):
    """Symmetric-rounding divide + clamp (reference: convolution.zig:18-23)."""
    half = scale // 2
    rounded = torch.where(accum >= 0, accum + half, accum - half)
    q = rounded.abs() // scale
    q = torch.where(rounded < 0, -q, q)
    return q.clamp(0, 255).to(torch.uint8)


def _tap_reader(n: int, ksize: int, border: BorderMode, axis: int, device):
    """``read(x, k)``: the ``[..., n, ...]`` slab of ``x`` that tap ``k`` of
    a ``ksize``-tap filter reads along ``axis`` (0 where a ZERO-border tap
    falls outside the axis). The table stays on the host to decide which
    taps need the mask."""
    table = border_tap_table(n, ksize, border)
    taps = torch.from_numpy(np.maximum(table, 0)).to(device)
    inside = torch.from_numpy(table >= 0).to(device)

    def read(x, k: int):
        part = x.index_select(axis, taps[:, k])
        if (table[:, k] < 0).any():
            shape = [1] * x.ndim
            shape[axis] = n
            part = part * inside[:, k].to(x.dtype).view(shape)
        return part

    return read


def _sep_pass(x, kint: np.ndarray, axis: int, border: BorderMode):
    """One u8 pass along ``axis``: each tap's resolved source positions,
    weighted and summed in int32; ZERO taps outside the axis weigh 0."""
    read = _tap_reader(x.shape[axis], len(kint), border, axis, x.device)
    total = None
    for k, w in enumerate(kint.tolist()):
        if w == 0:
            continue
        term = read(x, k) * w
        total = term if total is None else total + term
    return torch.zeros_like(x) if total is None else total


def _sep_pass_float(x, weights: np.ndarray, axis: int, border: BorderMode):
    """One float pass, as the JAX package's ``_sep_pass``: taps in kernel
    order, fused multiply-adds. Zero taps are skipped where the JAX
    package pads the axis (``0 < radius < n``) and kept on shorter axes,
    where it gathers every tap; there a ZERO border keeps the band
    semantics (ROADMAP §3)."""
    n, ksize = x.shape[axis], len(weights)
    read = _tap_reader(n, ksize, border, axis, x.device)
    keep = [k for k in range(ksize)
            if weights[k] != 0 or not 0 < ksize // 2 < n]
    if not keep:
        return torch.zeros_like(x)
    w = torch.from_numpy(weights).to(x.device, x.dtype)
    return fma_sum((read(x, k), w[k]) for k in keep)


def _check_overflow(bound: int):
    if bound >= 2 ** 31:
        raise ValueError("kernel weights overflow the int32 accumulator")


def _check(arr, op: str):
    if arr.is_complex():
        raise NotImplementedError(f"{op} of {arr.dtype} is not ported")
    if arr.ndim < 3:
        raise ValueError(f"{op} expects a [..., H, W, C] tensor")


def _as_float(arr):
    """Integer inputs other than u8 (and bool) take the JAX package's
    float route: their taps multiply f32 weights, so the values go to f32
    first (exactly, up to 2^24) and the result is f32."""
    if arr.dtype == torch.uint8 or arr.is_floating_point():
        return arr
    return arr.to(torch.float32)


@functools.lru_cache(maxsize=256)
def _separable_int_cached(kernel_x: tuple, kernel_y: tuple):
    kx, ky = _kernel_to_int(kernel_x), _kernel_to_int(kernel_y)
    _check_overflow(255 * int(np.abs(kx).sum()) * int(np.abs(ky).sum())
                    + SCALE * SCALE // 2)
    kx.flags.writeable = ky.flags.writeable = False
    return kx, ky


def _separable_int(kernel_x, kernel_y):
    """The 8.8 integer taps of both kernels (checked against the int32
    bound), cached by the kernels' values: the conversion costs more host
    time than a small launch."""
    return _separable_int_cached(tuple(float(v) for v in kernel_x),
                                 tuple(float(v) for v in kernel_y))


def convolve_separable_reference(arr, kernel_x: tuple, kernel_y: tuple,
                                 border: BorderMode = BorderMode.MIRROR):
    """Plain PyTorch version, on any device: width pass, height pass,
    divClampU8 by 256^2 (u8); the float passes for a float input."""
    border = BorderMode(border)
    _check(arr, "convolve_separable")
    arr = _as_float(arr)
    if arr.is_floating_point():
        kx = np.asarray(kernel_x, dtype=np.float32)
        ky = np.asarray(kernel_y, dtype=np.float32)
        temp = _sep_pass_float(arr, kx, arr.ndim - 2, border)
        return _sep_pass_float(temp, ky, arr.ndim - 3, border)
    kx, ky = _separable_int(kernel_x, kernel_y)
    temp = _sep_pass(arr.to(torch.int32), kx, arr.ndim - 2, border)
    accum = _sep_pass(temp, ky, arr.ndim - 3, border)
    return _div_clamp_u8(accum, SCALE * SCALE)


def _band(n: int, kint: np.ndarray, border: BorderMode) -> np.ndarray:
    return build_tap_matrix(border_tap_table(n, len(kint), border), kint,
                            n, n)


def convolve_separable(arr, kernel_x: tuple, kernel_y: tuple,
                       border: BorderMode = BorderMode.MIRROR):
    """Separable convolution of a ``[..., H, W, C]`` tensor with odd 1-D
    float kernels. u8 is bit-exact with the JAX package's banded path: a
    CUDA tensor runs the separable kernel (or raises), a CPU tensor the
    plain version. A float input runs the float passes on its device, and
    any other integer input too, as f32 (the JAX package's route)."""
    _check(arr, "convolve_separable")
    if arr.device.type == "cpu" or arr.dtype != torch.uint8:
        return convolve_separable_reference(arr, kernel_x, kernel_y, border)
    kx, ky = _separable_int(kernel_x, kernel_y)
    from . import separable_conv

    h, w, c = arr.shape[-3:]
    x = arr.contiguous().view(-1, h, w, c)
    return separable_conv.run_conv(x, kx, ky, border).view(arr.shape)


def gaussian_blur(arr, sigma: float, border: BorderMode = BorderMode.MIRROR):
    if sigma == 0:
        return arr
    k = gaussian_kernel(sigma)
    return convolve_separable(arr, k, k, border)


def gaussian_blur_reference(arr, sigma: float,
                            border: BorderMode = BorderMode.MIRROR):
    """``gaussian_blur`` through the plain version, on any device."""
    if sigma == 0:
        return arr
    k = gaussian_kernel(sigma)
    return convolve_separable_reference(arr, k, k, border)


def convolve2d(arr, kernel, border: BorderMode = BorderMode.MIRROR):
    """2-D convolution of ``[..., H, W, C]`` with an odd ``[kh, kw]``
    kernel, taps in row-major order, zero weights skipped. u8: 8.8 integer
    weights ``round(k * 256)``, int32 sums and divClampU8 by 256 (exact in
    int32, equal to the JAX package's f32 sums of integers). Float: the
    taps' fused multiply-adds in the input's dtype; other integers as f32."""
    border = BorderMode(border)
    _check(arr, "convolve2d")
    arr = _as_float(arr)
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        raise ValueError("kernel must be 2-D with odd dimensions")
    ay, ax = arr.ndim - 3, arr.ndim - 2
    read_y = _tap_reader(arr.shape[ay], k.shape[0], border, ay, arr.device)
    read_x = _tap_reader(arr.shape[ax], k.shape[1], border, ax, arr.device)
    if arr.dtype == torch.uint8:
        kint = _kernel_to_int(k)
        _check_overflow(255 * int(np.abs(kint).sum()) + SCALE // 2)
        if not kint.any():
            return torch.zeros_like(arr)
        taps = _taps2d(arr.to(torch.int32), kint, read_y, read_x)
        return _div_clamp_u8(sum(px * int(kint[i, j]) for px, i, j in taps),
                             SCALE)
    if not k.any():
        return torch.zeros_like(arr)
    w = torch.from_numpy(k).to(arr.device, arr.dtype)
    return fma_sum((px, w[i, j])
                   for px, i, j in _taps2d(arr, k, read_y, read_x))


def _taps2d(x, k: np.ndarray, read_y, read_x):
    """``(pixels, ky, kx)`` of each nonzero tap of ``k`` in row-major
    order, each kernel row's source rows gathered once."""
    for i in range(k.shape[0]):
        if k[i].any():
            rows = read_y(x, i)
            for j in np.nonzero(k[i])[0]:
                yield read_x(rows, j), i, j


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel_gradients(gray_f32, border: BorderMode = BorderMode.REPLICATE):
    """Raw Sobel gradients ``(gx, gy)`` of a float ``[..., H, W]`` plane."""
    a = gray_f32[..., None]
    return (convolve2d(a, _SOBEL_X, border)[..., 0],
            convolve2d(a, _SOBEL_Y, border)[..., 0])


def gradient_magnitude(gx, gy):
    """``sqrt(gx * gx + gy * gy)``, the sum contracted as XLA contracts
    it: ``fma(gx, gx, gy * gy)``."""
    return torch.sqrt(fma_sum(((gx, gx), (gy, gy))))


def sobel_magnitude(gray_f32):
    """Sobel gradient magnitude of a 0-255 float ``[..., H, W]`` plane as
    u8 (edges.zig:29-73: magnitude / 4, truncated, clamped)."""
    gx, gy = sobel_gradients(gray_f32, BorderMode.REPLICATE)
    mag = gradient_magnitude(gx, gy) / 4.0
    return torch.trunc(mag.clamp(0.0, 255.0)).to(torch.uint8)
