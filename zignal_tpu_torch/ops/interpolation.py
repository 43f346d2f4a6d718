"""Resize (reference: src/image/interpolation.zig, channel_ops.zig:144-560),
the counterpart of zignal_tpu/ops/interpolation.py.

Coordinates and taps come from host numpy tables (ops/tables.py); the
device work is gathers and multiply-adds. u8 outputs are bit-exact with the
JAX package: bilinear and the cubic family in int32 with the reference's
truncating divisions, Lanczos with the JAX package's f32 weights. A CUDA u8
bilinear resize goes to the fused kernel (ops/fused_pipeline.py) with the
blur and the Oklab epilogue off.

The Lanczos and float paths accumulate their taps in the JAX package's
order, with each multiply-add rounded once as XLA's CPU backend contracts
it (ops/fma.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import Interpolation
from ._build import cached
from .fma import fma, fma_sum
from .tables import CUBIC_KERNELS, SCALE, _axis_coords, \
    bilinear_axis_table, cubic_axis_table, lanczos_axis_table, \
    nearest_indices, resolve_index_np

__all__ = ["resize", "resize_plane_f32"]


def _dev(table, device):
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def _axis_taps(src_n: int, dst_n: int, device):
    a, b, f = _dev(bilinear_axis_table(src_n, dst_n), device)
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


def _nearest_tables(src_rows: int, src_cols: int, rows: int, cols: int,
                    device):
    return (_dev(nearest_indices(src_rows, rows), device),
            _dev(nearest_indices(src_cols, cols), device))


def _resize_nearest(arr, rows: int, cols: int):
    """NEAREST source rows, then columns; the index tables go to the
    device once a shape, since an upload waits for the card."""
    y, x = cached(_nearest_tables, arr.shape[-3], arr.shape[-2], rows, cols,
                  arr.device)
    return arr.index_select(-3, y).index_select(-2, x)


def _tap_tables(arr, rows: int, cols: int, method, integer: bool):
    """Host source indices (int64 ``[rows, k]``, ``[cols, k]``) and the
    weight plane ``[rows, cols]`` of each tap on ``arr``'s device,
    ky-outer and kx-inner, of a cubic-family or Lanczos resize. The cubic
    family's weights are ``trunc(wy * wx / 256)`` in int32 when
    ``integer`` (the u8 path, zignal_tpu/ops/interpolation.py:314-316),
    else ``(wy / 256) * (wx / 256)`` in f32; Lanczos weights are
    ``wy * wx`` in f32."""
    axes = ((arr.shape[-3], rows), (arr.shape[-2], cols))
    if method == Interpolation.LANCZOS:
        (yi, wy), (xi, wx) = (lanczos_axis_table(n, d) for n, d in axes)
    else:
        kern = CUBIC_KERNELS[method]
        (yi, wy), (xi, wx) = (cubic_axis_table(n, d, kern) for n, d in axes)
        if not integer:
            wy, wx = wy.astype(np.float32) / SCALE, wx.astype(np.float32) / SCALE
    wy, wx = _dev(wy, arr.device), _dev(wx, arr.device)
    k = yi.shape[1]
    planes = [wy[:, ky, None] * wx[None, :, kx]
              for ky in range(k) for kx in range(k)]
    if planes[0].dtype == torch.int32:
        planes = [torch.div(w, SCALE, rounding_mode="trunc") for w in planes]
    return yi.astype(np.int64), xi.astype(np.int64), planes


def _tap_terms(x, yi, xi, planes):
    """``(pixels, weight)`` of each tap in the JAX package's order: the
    source rows gathered once per ky, then each kx's columns."""
    k = yi.shape[1]
    for ky in range(k):
        row = x.index_select(-3, _dev(yi[:, ky], x.device))
        for kx in range(k):
            yield (row.index_select(-2, _dev(xi[:, kx], x.device)),
                   planes[ky * k + kx][..., None])


def _sum_in_order(planes):
    """The taps' weight sum accumulated in order, first tap first."""
    total = planes[0]
    for plane in planes[1:]:
        total = total + plane
    return total


def _resize_cubic_u8(arr, rows: int, cols: int, method):
    """4x4 integer-weight resampling (bicubic, Catmull-Rom, Mitchell):
    int32 sums (|total| <= 16 * 255 * 2^10), a truncating division by the
    weight sum, 0 where it is 0 (the JAX package's f32 ``_divtrunc`` on
    exact integers, in int32)."""
    yi, xi, planes = _tap_tables(arr, rows, cols, method, integer=True)
    total = sum(px * w for px, w in
                _tap_terms(arr.to(torch.int32), yi, xi, planes))
    wsum = _sum_in_order(planes)[..., None]
    out = torch.div(total, torch.where(wsum != 0, wsum, 1),
                    rounding_mode="trunc")  # Zig @divTrunc
    return torch.where(wsum != 0, out, 0).clamp(0, 255).to(torch.uint8)


def _resize_lanczos_u8(arr, rows: int, cols: int):
    """6x6 Lanczos3 with f32 weights ``wy * wx`` (channel_ops.zig:438-494):
    fused multiply-adds ky-outer, kx-inner, divided by the weight sum,
    ``floor(x + 0.5)`` and clipped."""
    yi, xi, planes = _tap_tables(arr, rows, cols, Interpolation.LANCZOS,
                                 integer=False)
    total = fma_sum(_tap_terms(arr.to(torch.float32), yi, xi, planes))
    wsum = _sum_in_order(planes)[..., None]
    result = torch.where(wsum != 0, total / wsum, 0.0)
    return torch.floor(result + 0.5).clamp(0, 255).to(torch.uint8)


def _resize_float(arr, rows: int, cols: int, method: Interpolation):
    """Float resize with normalized float weights (channel_ops.zig
    resizePlaneF32), in the input's dtype, each multiply-add fused."""
    if method == Interpolation.NEAREST:
        return _resize_nearest(arr, rows, cols)
    dev = arr.device
    if method == Interpolation.BILINEAR:
        taps = []
        for src_n, dst_n in ((arr.shape[-3], rows), (arr.shape[-2], cols)):
            _, i0, f = _axis_coords(src_n, dst_n)
            taps.append((_dev(resolve_index_np(i0, src_n), dev),
                         _dev(resolve_index_np(i0 + 1, src_n), dev),
                         _dev(f, dev).to(arr.dtype),
                         _dev(np.float32(1) - f, dev).to(arr.dtype)))
        (ya, yb, fy, gy), (xa, xb, fx, gx) = taps

        def lerp(lo, hi, g, f):  # lo * (1 - f) + hi * f, contracted
            return fma(lo, g, hi * f)

        top_rows, bot_rows = arr.index_select(-3, ya), arr.index_select(-3, yb)
        top = lerp(top_rows.index_select(-2, xa),
                   top_rows.index_select(-2, xb), gx[:, None], fx[:, None])
        bot = lerp(bot_rows.index_select(-2, xa),
                   bot_rows.index_select(-2, xb), gx[:, None], fx[:, None])
        return lerp(top, bot, gy[:, None, None], fy[:, None, None])
    yi, xi, planes = _tap_tables(arr, rows, cols, method, integer=False)
    total = fma_sum(_tap_terms(arr, yi, xi,
                               [w.to(arr.dtype) for w in planes]))
    # the weight sums are constants of the JAX package's compiled program,
    # and XLA turns the division by a constant into a multiplication by
    # its f32 reciprocal
    wsum = _sum_in_order(planes)
    recip = torch.where(wsum != 0, wsum.reciprocal(), 0.0)
    return total * recip.to(arr.dtype)[..., None]


def resize(arr, rows: int, cols: int, method=Interpolation.BILINEAR):
    """Resize a ``[..., H, W, C]`` tensor to ``[..., rows, cols, C]`` on
    the tensor's own device (leading dims are batch). u8 inputs take the
    reference's fixed-point paths, bit-exact with the JAX package; float
    inputs take normalized float weights, and so do other integer inputs,
    as f32 (nearest keeps their dtype). On a CUDA tensor u8 BILINEAR is
    the fused kernel; every other case is plain PyTorch there too."""
    method = Interpolation(method)
    if arr.shape[-3] == rows and arr.shape[-2] == cols:
        return arr
    if arr.dtype != torch.uint8:
        if arr.is_complex():
            raise NotImplementedError(f"resize of {arr.dtype} is not ported")
        if not arr.is_floating_point():
            # the JAX package's float route: nearest keeps the dtype, the
            # other methods weigh the values in f32
            if method == Interpolation.NEAREST:
                return _resize_nearest(arr, rows, cols)
            arr = arr.to(torch.float32)
        return _resize_float(arr, rows, cols, method)
    if method == Interpolation.NEAREST:
        return _resize_nearest(arr, rows, cols)
    if method == Interpolation.LANCZOS:
        return _resize_lanczos_u8(arr, rows, cols)
    if method != Interpolation.BILINEAR:
        return _resize_cubic_u8(arr, rows, cols, method)
    if arr.device.type == "cpu":
        return _resize_bilinear_u8(arr, rows, cols)
    from .fused_pipeline import fused_resize_blur_oklab  # imports this module

    x = arr.reshape(-1, *arr.shape[-3:]).contiguous()
    out = fused_resize_blur_oklab(x, rows, cols, 0.0, oklab=False)
    return out.reshape(*arr.shape[:-3], rows, cols, arr.shape[-1])


def resize_plane_f32(arr, rows: int, cols: int,
                     method=Interpolation.BILINEAR):
    """Resize a float ``[..., H, W]`` plane (adds and removes the channel
    axis)."""
    return _resize_float(arr[..., None], rows, cols,
                         Interpolation(method))[..., 0]
