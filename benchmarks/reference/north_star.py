"""Plain reference of the north star: u8 sRGB ``[B, H, W, 3]`` ->
bilinear resize (8.8 fixed-point taps, truncating ``>> 16``) -> Gaussian
blur (MIRROR, 8.8 taps) -> sRGB -> Oklab. The u8 stages are exact
integers; the Oklab stage is computed in ``dtype``: float64 for the
reference, bfloat16 for the control, the precision below the float32
that the configuration states."""

from __future__ import annotations

import numpy as np
import torch

from .common import SCALE, blur_u8, mirror

# sRGB transfer curve and the upstream library's matrices, row-major
# (out, in): linear sRGB -> XYZ (x100 dropped), XYZ -> Oklab's LMS, and
# LMS' -> Lab
SRGB_GAMMA_THRESHOLD = 0.04045
SRGB_GAMMA_OFFSET = 0.055
SRGB_GAMMA_SCALE = 1.055
SRGB_LINEAR_SLOPE = 12.92
SRGB_GAMMA_EXPONENT = 2.4
RGB2XYZ = ((0.4124, 0.3576, 0.1805),
           (0.2126, 0.7152, 0.0722),
           (0.0193, 0.1192, 0.9505))
XYZ2OKLMS = ((0.8189330101, 0.3618667424, -0.1288597137),
             (0.0329845436, 0.9293118715, 0.0361456387),
             (0.0482003018, 0.2643662691, 0.6338517070))
OKLMS2LAB = ((0.2104542553, 0.7936177850, -0.0040720468),
             (1.9779984951, -2.4285922050, 0.4505937099),
             (0.0259040371, 0.7827717662, -0.8086757660))


def axis_taps(src_n: int, dst_n: int):
    """(a, b, f) of each output position: it reads source ``a`` with
    weight 256 - f and ``b`` with weight f, f = trunc(frac * 256) of the
    f32 source coordinate (dst + 0.5) * src / dst - 0.5."""
    f32 = np.float32
    ratio = f32(src_n) / f32(dst_n)
    src = (np.arange(dst_n, dtype=f32) + f32(0.5)) * ratio - f32(0.5)
    i0 = np.floor(src).astype(np.int64)
    f = np.trunc((src - np.floor(src)) * f32(SCALE)).astype(np.int64)
    return mirror(i0, src_n), mirror(i0 + 1, src_n), f


def resize_u8(x, rows: int, cols: int):
    """Bilinear u8 ``[..., H, W, C]`` -> ``[..., rows, cols, C]``: rows
    then columns in int32, truncated ``>> 16``."""
    dev = x.device
    ya, yb, fy = (torch.from_numpy(t).to(dev)
                  for t in axis_taps(x.shape[-3], rows))
    xa, xb, fx = (torch.from_numpy(t).to(dev)
                  for t in axis_taps(x.shape[-2], cols))
    v = x.to(torch.int32)
    wy = fy.to(torch.int32)[:, None, None]
    t = v.index_select(-3, ya) * (SCALE - wy) + v.index_select(-3, yb) * wy
    wx = fx.to(torch.int32)[:, None]
    acc = t.index_select(-2, xa) * (SCALE - wx) + t.index_select(-2, xb) * wx
    return (acc >> 16).clamp(0, 255).to(torch.uint8)


def _mix(v, m, dtype):
    mat = torch.tensor(m, dtype=dtype, device=v.device)
    return torch.einsum("...i,oi->...o", v, mat)


def srgb_to_oklab(x, dtype=torch.float64):
    """u8 sRGB ``[..., 3]`` -> Oklab ``[..., 3]`` in ``dtype``."""
    c = x.to(dtype) / 255
    lin = torch.where(c > SRGB_GAMMA_THRESHOLD,
                      ((c + SRGB_GAMMA_OFFSET) / SRGB_GAMMA_SCALE)
                      ** SRGB_GAMMA_EXPONENT,
                      c / SRGB_LINEAR_SLOPE)
    rgb2lms = (np.asarray(XYZ2OKLMS) @ np.asarray(RGB2XYZ)).tolist()
    lms = _mix(lin, rgb2lms, dtype)
    root = torch.sign(lms) * lms.abs() ** (1 / 3)
    return _mix(root, OKLMS2LAB, dtype)


def north_star(x, rows: int, cols: int, sigma: float,
               dtype=torch.float64):
    """The pipeline on u8 ``[B, H, W, 3]``; Oklab in ``dtype``."""
    return srgb_to_oklab(blur_u8(resize_u8(x, rows, cols), sigma), dtype)
