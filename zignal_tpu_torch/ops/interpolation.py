"""u8 bilinear resize (reference: src/image/interpolation.zig,
channel_ops.zig:144-191), the counterpart of zignal_tpu/ops/interpolation.py.

Coordinates and 8.8 taps come from host numpy tables (ops/tables.py); the
device work is gathers and int32 multiply-adds, bit-exact with the JAX
package. A CUDA tensor goes to the fused kernel (ops/fused_pipeline.py)
with the blur and the Oklab epilogue off.
"""

from __future__ import annotations

import torch

from ..enums import Interpolation
from .tables import SCALE, bilinear_axis_table

__all__ = ["resize"]


def _axis_taps(src_n: int, dst_n: int, device):
    a, b, f = torch.from_numpy(bilinear_axis_table(src_n, dst_n)).to(device)
    return a.long(), b.long(), f


def _resize_bilinear_u8(arr, rows: int, cols: int):
    """Plain u8 bilinear on ``[..., H, W, C]``: rows then columns, int32
    sums of at most 255 * 256 * 256 < 2^31, truncated ``>> 16``."""
    ya, yb, fy = _axis_taps(arr.shape[-3], rows, arr.device)
    xa, xb, fx = _axis_taps(arr.shape[-2], cols, arr.device)
    x = arr.to(torch.int32)
    wy1 = fy[:, None, None]
    t = x.index_select(-3, ya) * (SCALE - wy1) + x.index_select(-3, yb) * wy1
    wx1 = fx[:, None]
    acc = t.index_select(-2, xa) * (SCALE - wx1) + t.index_select(-2, xb) * wx1
    return (acc >> 16).clamp(0, 255).to(torch.uint8)


def resize(arr, rows: int, cols: int, method=Interpolation.BILINEAR):
    """Resize a u8 ``[..., H, W, C]`` tensor to ``[..., rows, cols, C]``
    on the tensor's own device. Only u8 BILINEAR is ported; the other
    methods and float inputs are ROADMAP item 9."""
    method = Interpolation(method)
    if arr.shape[-3] == rows and arr.shape[-2] == cols:
        return arr
    if arr.dtype != torch.uint8 or method != Interpolation.BILINEAR:
        raise NotImplementedError(
            f"resize of {arr.dtype} with {method.name} is not ported yet "
            "(ROADMAP item 9); only uint8 BILINEAR is")
    if arr.device.type == "cpu":
        return _resize_bilinear_u8(arr, rows, cols)
    from .fused_pipeline import fused_resize_blur_oklab  # imports this module

    if arr.ndim not in (3, 4):
        raise ValueError("resize on the device expects [H, W, C] or "
                         "[B, H, W, C]")
    out = fused_resize_blur_oklab(arr.reshape(-1, *arr.shape[-3:]), rows,
                                  cols, 0.0, oklab=False)
    return out if arr.ndim == 4 else out[0]
