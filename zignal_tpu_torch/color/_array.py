"""Batched sRGB -> Oklab on channel-last float32 tensors ``[..., 3]``, and
u8 RGB -> gray.

The counterpart of the rgb -> oklab edge and ``rgb_to_gray_u8`` of
zignal_tpu/color/_array.py: the same constants, the same f64-composed
``_RGB2OKLMS`` matrix and the same order of f32 multiply-adds. Other colour
spaces are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ._constants import (
    LUMA_B, LUMA_G, LUMA_R, SRGB_GAMMA_EXPONENT, SRGB_GAMMA_OFFSET,
    SRGB_GAMMA_SCALE, SRGB_GAMMA_THRESHOLD, SRGB_LINEAR_SLOPE,
)

__all__ = ["convert_array", "gamma_to_linear", "rgb_to_oklab_fused",
           "rgb_to_gray_u8"]


def _T(m):
    return tuple(zip(*m))


def _mix3(a, m):
    """Per-pixel 3x3 channel mix as explicit f32 multiply-adds (not a
    matmul), in the JAX package's order; ``m`` is (in, out)."""
    c0, c1, c2 = a[..., 0], a[..., 1], a[..., 2]
    return torch.stack(
        [
            c0 * m[0][0] + c1 * m[1][0] + c2 * m[2][0],
            c0 * m[0][1] + c1 * m[1][1] + c2 * m[2][1],
            c0 * m[0][2] + c1 * m[1][2] + c2 * m[2][2],
        ],
        dim=-1,
    )


def _cbrt(x):
    """Cube root of a non-negative tensor. torch has no ``cbrt``; every
    caller here passes ``lms >= 0`` (all entries of ``_RGB2OKLMS`` are
    positive), where ``pow(1/3)`` is defined."""
    return x.pow(1.0 / 3.0)


def gamma_to_linear(c):
    return torch.where(
        c > SRGB_GAMMA_THRESHOLD,
        ((c + SRGB_GAMMA_OFFSET) / SRGB_GAMMA_SCALE) ** SRGB_GAMMA_EXPONENT,
        c / SRGB_LINEAR_SLOPE,
    )


# matrices written row-major (out, in); _T -> (in, out) for _mix3
_RGB2XYZ = _T([[0.4124, 0.3576, 0.1805],
               [0.2126, 0.7152, 0.0722],
               [0.0193, 0.1192, 0.9505]])

_XYZ2OKLMS = _T([[0.8189330101, 0.3618667424, -0.1288597137],
                 [0.0329845436, 0.9293118715, 0.0361456387],
                 [0.0482003018, 0.2643662691, 0.6338517070]])

_OKLMS2LAB = _T([[0.2104542553, 0.7936177850, -0.0040720468],
                 [1.9779984951, -2.4285922050, 0.4505937099],
                 [0.0259040371, 0.7827717662, -0.8086757660]])


def _np_compose(b_t, a_t):
    return _T((np.asarray(b_t, dtype=np.float64).T
               @ np.asarray(a_t, dtype=np.float64).T).tolist())


# the xyz hop's *100 and /100 cancel: one matrix, composed in f64
_RGB2OKLMS = _np_compose(_XYZ2OKLMS, _RGB2XYZ)


def rgb_to_oklab_fused(a):
    lms = _mix3(gamma_to_linear(a), _RGB2OKLMS)
    return _mix3(_cbrt(lms), _OKLMS2LAB)


def convert_array(arr, src: str, dst: str):
    """Convert a float32 ``[..., 3]`` tensor between colour spaces. Only
    rgb -> oklab is ported; the rest of the conversion graph is ROADMAP
    item 8."""
    if (src, dst) != ("rgb", "oklab"):
        raise NotImplementedError(
            f"convert_array({src!r} -> {dst!r}) is not ported yet "
            "(ROADMAP item 8); only rgb -> oklab is")
    if arr.dtype != torch.float32 or arr.shape[-1] != 3:
        raise ValueError("convert_array expects a float32 [..., 3] tensor")
    return rgb_to_oklab_fused(arr)


def rgb_to_gray_u8(a):
    """u8 ``[..., 3]`` -> u8 ``[..., 1]``, BT.709 16.16 fixed point
    (color.zig:1031): ``floor((r*wr + g*wg + b*wb + 2^15) / 2^16)`` in
    int32. The sum is at most 65536*255 + 2^15, so the JAX package's f32
    form of the same expression gives the same integers."""
    wr, wg, wb = (round(v * 65536) for v in (LUMA_R, LUMA_G, LUMA_B))
    x = a.to(torch.int32)
    y = (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb + 32768) >> 16
    return y.clamp(0, 255).to(torch.uint8)[..., None]
