"""u8 separable convolution and Gaussian blur (reference:
src/image/convolution.zig), the counterpart of
zignal_tpu/ops/convolution.py.

The 8.8 fixed point of the reference: 1-D weights are ``round(k * 256)``
int32; the width pass accumulates int32 "temp" planes, the height pass
accumulates temp * weight, then divClampU8 divides by 256^2 with
symmetric rounding. There is no division between the passes. This is
the plain PyTorch version only: on the card the blur of the main path
runs inside the fused kernel (ops/fused_pipeline.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from .tables import SCALE, _kernel_to_int, blur_tap_table, gaussian_kernel

__all__ = ["convolve_separable", "gaussian_blur"]


def _div_clamp_u8(accum, scale: int):
    """Symmetric-rounding divide + clamp (reference: convolution.zig:18-23)."""
    half = scale // 2
    rounded = torch.where(accum >= 0, accum + half, accum - half)
    q = rounded.abs() // scale
    q = torch.where(rounded < 0, -q, q)
    return q.clamp(0, 255).to(torch.uint8)


def _sep_pass(x, kint: np.ndarray, axis: int):
    """One MIRROR-bordered pass along ``axis``: a gather of each tap's
    resolved source positions, weighted and summed in int32."""
    taps = torch.from_numpy(blur_tap_table(x.shape[axis], len(kint)))
    taps = taps.to(x.device)
    total = None
    for k, w in enumerate(kint.tolist()):
        if w == 0:
            continue
        term = x.index_select(axis, taps[:, k]) * w
        total = term if total is None else total + term
    return torch.zeros_like(x) if total is None else total


def convolve_separable(arr, kernel_x: tuple, kernel_y: tuple,
                       border: BorderMode = BorderMode.MIRROR):
    """Separable convolution of a u8 ``[..., H, W, C]`` tensor with 1-D
    float kernels, bit-exact with the JAX package. Only the u8 MIRROR
    path is ported; float inputs and other borders are ROADMAP item 9."""
    border = BorderMode(border)
    if arr.dtype != torch.uint8 or border != BorderMode.MIRROR:
        raise NotImplementedError(
            f"convolve_separable of {arr.dtype} with {border.name} border "
            "is not ported yet (ROADMAP item 9); only uint8 MIRROR is")
    kx = _kernel_to_int(kernel_x)
    ky = _kernel_to_int(kernel_y)
    bound = 255 * int(np.abs(kx).sum()) * int(np.abs(ky).sum())
    if bound + SCALE * SCALE // 2 >= 2 ** 31:
        raise ValueError("kernel weights overflow the int32 accumulator")
    temp = _sep_pass(arr.to(torch.int32), kx, arr.ndim - 2)
    accum = _sep_pass(temp, ky, arr.ndim - 3)
    return _div_clamp_u8(accum, SCALE * SCALE)


def gaussian_blur(arr, sigma: float, border: BorderMode = BorderMode.MIRROR):
    if sigma == 0:
        return arr
    k = gaussian_kernel(sigma)
    return convolve_separable(arr, k, k, border)
