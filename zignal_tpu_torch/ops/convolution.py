"""u8 separable convolution and Gaussian blur (reference:
src/image/convolution.zig), the counterpart of
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
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from .tables import SCALE, _kernel_to_int, border_tap_table, \
    build_tap_matrix, gaussian_kernel

__all__ = ["convolve_separable", "convolve_separable_reference",
           "gaussian_blur", "gaussian_blur_reference"]


def _div_clamp_u8(accum, scale: int):
    """Symmetric-rounding divide + clamp (reference: convolution.zig:18-23)."""
    half = scale // 2
    rounded = torch.where(accum >= 0, accum + half, accum - half)
    q = rounded.abs() // scale
    q = torch.where(rounded < 0, -q, q)
    return q.clamp(0, 255).to(torch.uint8)


def _sep_pass(x, kint: np.ndarray, axis: int, border: BorderMode):
    """One pass along ``axis``: a gather of each tap's resolved source
    positions, weighted and summed in int32; ZERO taps outside the axis
    weigh 0."""
    n = x.shape[axis]
    taps = torch.from_numpy(border_tap_table(n, len(kint), border))
    taps = taps.to(x.device)
    shape = [1] * x.ndim
    shape[axis] = n
    total = None
    for k, w in enumerate(kint.tolist()):
        if w == 0:
            continue
        col = taps[:, k]
        term = x.index_select(axis, col.clamp(min=0))
        if bool((col < 0).any()):
            term = term * (col >= 0).to(x.dtype).view(shape)
        term = term * w
        total = term if total is None else total + term
    return torch.zeros_like(x) if total is None else total


def _check(arr, kint_x, kint_y):
    if arr.dtype != torch.uint8:
        raise NotImplementedError(
            f"convolve_separable of {arr.dtype} is not ported yet (ROADMAP "
            "item 9); only uint8 is")
    if arr.ndim < 3:
        raise ValueError("convolve_separable expects a [..., H, W, C] "
                         "tensor")
    bound = 255 * int(np.abs(kint_x).sum()) * int(np.abs(kint_y).sum())
    if bound + SCALE * SCALE // 2 >= 2 ** 31:
        raise ValueError("kernel weights overflow the int32 accumulator")


def convolve_separable_reference(arr, kernel_x: tuple, kernel_y: tuple,
                                 border: BorderMode = BorderMode.MIRROR):
    """Plain PyTorch version, on any device: width pass, height pass,
    divClampU8 by 256^2."""
    border = BorderMode(border)
    kx = _kernel_to_int(kernel_x)
    ky = _kernel_to_int(kernel_y)
    _check(arr, kx, ky)
    temp = _sep_pass(arr.to(torch.int32), kx, arr.ndim - 2, border)
    accum = _sep_pass(temp, ky, arr.ndim - 3, border)
    return _div_clamp_u8(accum, SCALE * SCALE)


def _band(n: int, kint: np.ndarray, border: BorderMode) -> np.ndarray:
    return build_tap_matrix(border_tap_table(n, len(kint), border), kint,
                            n, n)


def convolve_separable(arr, kernel_x: tuple, kernel_y: tuple,
                       border: BorderMode = BorderMode.MIRROR):
    """Separable convolution of a u8 ``[..., H, W, C]`` tensor with odd
    1-D float kernels, bit-exact with the JAX package's banded path. A
    CUDA tensor runs the separable kernel (or raises); a CPU tensor runs
    the plain version. Float inputs are ROADMAP item 9."""
    if arr.device.type == "cpu":
        return convolve_separable_reference(arr, kernel_x, kernel_y, border)
    border = BorderMode(border)
    kx = _kernel_to_int(kernel_x)
    ky = _kernel_to_int(kernel_y)
    _check(arr, kx, ky)
    from . import separable_conv

    h, w, c = arr.shape[-3:]
    key = ("conv", h, w, kx.tobytes(), ky.tobytes(), border)
    x = arr.contiguous().view(-1, h, w, c)
    out = separable_conv.run_cached(
        x, key, lambda: (_band(w, kx, border), _band(h, ky, border)))
    return out.view(arr.shape)


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
