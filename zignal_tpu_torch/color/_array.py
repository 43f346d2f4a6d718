"""Batched colour-space conversion on channel-last tensors ``[..., C]``.

The counterpart of zignal_tpu/color/_array.py: the same hub-and-spoke
routing (``_path.conversion_path``), the same matrices (the rgb <-> oklab
ones composed in f64), and the same f32 ops in the same order, each one a
PyTorch op. ``jnp.select`` becomes nested ``torch.where`` in JAX's order,
``%`` is ``torch.remainder`` (floor mod in both frameworks), and
``degrees``/``radians`` are multiplications by the same f32 constants.
The integer-backed edges among gray, rgb, rgba and ycbcr also have exact
u8 fixed-point paths (``convert_u8_array``; reference:
src/color.zig:987-1007,1031-1043,1057-1078).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._scalar import (
    D65_X, D65_Y, D65_Z,
    LAB_DELTA, LAB_EPSILON, LAB_KAPPA_DIV_116,
    LUMA_B, LUMA_G, LUMA_R,
    SRGB_GAMMA_EXPONENT, SRGB_GAMMA_OFFSET, SRGB_GAMMA_SCALE,
    SRGB_GAMMA_THRESHOLD, SRGB_LINEAR_SLOPE, SRGB_LINEAR_THRESHOLD,
    XYB_BIAS, XYB_CBRT_BIAS_DECODE, XYB_CBRT_BIAS_ENCODE,
)
from ._path import conversion_path

__all__ = ["convert_array", "convert_u8_array", "gamma_to_linear",
           "linear_to_gamma", "rgb_to_oklab_fused", "rgb_to_gray_u8",
           "NUM_CHANNELS"]

NUM_CHANNELS = {
    "gray": 1, "rgb": 3, "rgba": 4, "hsl": 3, "hsv": 3, "lab": 3, "lch": 3,
    "lms": 3, "oklab": 3, "oklch": 3, "xyb": 3, "xyz": 3, "ycbcr": 3,
}

_DEGREES = 180.0 / math.pi
_RADIANS = math.pi / 180.0


def _split(a):
    return tuple(a[..., i] for i in range(a.shape[-1]))


def _join(*chans):
    return torch.stack(chans, dim=-1)


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
    """The real cube root, as ``jnp.cbrt``: torch has no ``cbrt``, and
    ``pow(1/3)`` alone is NaN below 0."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _where_chain(conds, choices, default):
    """``jnp.select``: the first true condition picks its choice."""
    out = default
    for cond, choice in zip(reversed(conds), reversed(choices)):
        out = torch.where(cond, choice, out)
    return out


# -- float edges -------------------------------------------------------------


def gray_to_rgb(a):
    return a.repeat_interleave(3, dim=-1)


def rgb_to_gray(a):
    r, g, b = _split(a)
    y = torch.clamp(LUMA_R * r + LUMA_G * g + LUMA_B * b, 0.0, 1.0)
    return y[..., None]


def rgb_to_rgba(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def rgba_to_rgb(a):
    return a[..., :3]


def rgb_to_hsv(a):
    r, g, b = _split(a)
    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    delta = mx - mn
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(
        mx == r,
        (g - b) / safe * 60.0,
        torch.where(mx == g, 120.0 + (b - r) / safe * 60.0,
                    240.0 + (r - g) / safe * 60.0),
    )
    h = torch.remainder(torch.where(delta == 0, 0.0, h), 360.0)
    s = torch.where(mx == 0, 0.0,
                    delta / torch.where(mx == 0, 1.0, mx)) * 100.0
    return _join(h, s, mx * 100.0)


def hsv_to_rgb(a):
    h, s, v = _split(a)
    hue = torch.clamp(h / 360.0, 0.0, 1.0)
    sat = torch.clamp(s / 100.0, 0.0, 1.0)
    val = torch.clamp(v / 100.0, 0.0, 1.0)
    sector = hue * 6.0
    index = torch.floor(sector)
    f = sector - index
    idx = index.to(torch.int32) % 6
    p = val * (1.0 - sat)
    q = val * (1.0 - sat * f)
    t = val * (1.0 - sat * (1.0 - f))
    # table rows: (val,t,p) (q,val,p) (p,val,t) (p,q,val) (t,p,val) (val,p,q)
    sel = [idx == 0, idx == 1, idx == 2, idx == 3, idx == 4]
    r = _where_chain(sel, [val, q, p, p, t], val)
    g = _where_chain(sel, [t, val, val, q, p], p)
    b = _where_chain(sel, [p, p, t, val, val], q)
    gray = sat == 0.0
    return _join(torch.where(gray, val, r), torch.where(gray, val, g),
                 torch.where(gray, val, b))


def rgb_to_hsl(a):
    r, g, b = _split(a)
    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    delta = mx - mn
    safe = torch.where(delta == 0, 1.0, delta)
    hue = torch.where(
        mx == r,
        (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe),
    )
    hue = torch.where(delta == 0, 0.0, hue)
    l = (mx + mn) / 2.0
    s = torch.where(
        delta == 0,
        0.0,
        torch.where(l < 0.5, delta / torch.clamp_min(2.0 * l, 1e-30),
                    delta / torch.clamp_min(2.0 - 2.0 * l, 1e-30)),
    )
    return _join(torch.remainder(hue * 60.0, 360.0),
                 torch.clamp(s, 0.0, 1.0) * 100.0,
                 torch.clamp(l, 0.0, 1.0) * 100.0)


def hsl_to_rgb(a):
    h, s, l = _split(a)
    h = torch.remainder(h, 360.0)
    s = torch.clamp(s / 100.0, 0.0, 1.0)
    l = torch.clamp(l / 100.0, 0.0, 1.0)
    hs = h / 60.0
    sector = torch.floor(hs)
    f = hs - sector
    idx = sector.to(torch.int32) % 6
    sel = [idx == 0, idx == 1, idx == 2, idx == 3, idx == 4]
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    fr = _where_chain(sel, [one, 1.0 - f, zero, zero, f], one)
    fg = _where_chain(sel, [f, one, one, 1.0 - f, zero], zero)
    fb = _where_chain(sel, [zero, zero, f, one, one], 1.0 - f)
    r = 1.0 + (2.0 * fr - 1.0) * s
    g = 1.0 + (2.0 * fg - 1.0) * s
    b = 1.0 + (2.0 * fb - 1.0) * s
    lo = l < 0.5
    return _join(
        torch.where(lo, r * l, r + (2.0 - r) * l - 1.0),
        torch.where(lo, g * l, g + (2.0 - g) * l - 1.0),
        torch.where(lo, b * l, b + (2.0 - b) * l - 1.0),
    )


def hsv_to_hsl(a):
    h, s, v = _split(a)
    s_v = s / 100.0
    v = v / 100.0
    l = v * (1.0 - s_v / 2.0)
    denom = torch.minimum(l, 1.0 - l)
    s_l = torch.where((l == 0) | (l == 1), 0.0,
                      (v - l) / torch.clamp_min(denom, 1e-30))
    return _join(h, s_l * 100.0, l * 100.0)


def hsl_to_hsv(a):
    h, s, l = _split(a)
    s_l = s / 100.0
    l = l / 100.0
    v = l + s_l * torch.minimum(l, 1.0 - l)
    s_v = torch.where(v == 0, 0.0,
                      2.0 * (1.0 - l / torch.clamp_min(v, 1e-30)))
    return _join(h, s_v * 100.0, v * 100.0)


def rgb_to_ycbcr(a):
    r, g, b = _split(a)
    y = torch.clamp(0.299 * r + 0.587 * g + 0.114 * b, 0.0, 1.0)
    return _join(y, torch.clamp((b - y) / 1.772, -0.5, 0.5),
                 torch.clamp((r - y) / 1.402, -0.5, 0.5))


def ycbcr_to_rgb(a):
    y, cb, cr = _split(a)
    return _join(
        torch.clamp(y + 1.402 * cr, 0.0, 1.0),
        torch.clamp(y - 0.344136 * cb - 0.714136 * cr, 0.0, 1.0),
        torch.clamp(y + 1.772 * cb, 0.0, 1.0),
    )


def linear_to_gamma(c):
    c_safe = torch.clamp_min(c, 0.0)
    return torch.where(
        c > SRGB_LINEAR_THRESHOLD,
        SRGB_GAMMA_SCALE * c_safe ** (1.0 / SRGB_GAMMA_EXPONENT)
        - SRGB_GAMMA_OFFSET,
        c * SRGB_LINEAR_SLOPE,
    )


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

_XYZ2RGB = _T([[3.2406, -1.5372, -0.4986],
               [-0.9689, 1.8758, 0.0415],
               [0.0557, -0.2040, 1.0570]])


def rgb_to_xyz(a):
    return _mix3(gamma_to_linear(a), _RGB2XYZ) * 100.0


def xyz_to_rgb(a):
    lin = _mix3(a, _XYZ2RGB) / 100.0
    return torch.clamp(linear_to_gamma(lin), 0.0, 1.0)


def _lab_f(t):
    return torch.where(t > LAB_EPSILON, _cbrt(t),
                       LAB_KAPPA_DIV_116 * t + LAB_DELTA)


def xyz_to_lab(a):
    fx = _lab_f(a[..., 0] / D65_X)
    fy = _lab_f(a[..., 1] / D65_Y)
    fz = _lab_f(a[..., 2] / D65_Z)
    return _join(torch.clamp_min(116.0 * fy - 16.0, 0.0), 500.0 * (fx - fy),
                 200.0 * (fy - fz))


def lab_to_xyz(a):
    l, aa, bb = _split(a)
    fy = (l + 16.0) / 116.0
    fx = aa / 500.0 + fy
    fz = fy - bb / 200.0

    def unf(f):
        f3 = f ** 3
        return torch.where(f3 > LAB_EPSILON, f3,
                           (f - LAB_DELTA) / LAB_KAPPA_DIV_116)

    return _join(unf(fx) * D65_X, unf(fy) * D65_Y, unf(fz) * D65_Z)


def _cart_to_cyl(l, a, b):
    c = torch.sqrt(a * a + b * b)
    h = torch.remainder(torch.atan2(b, a) * _DEGREES, 360.0)
    return _join(l, c, h)


def _cyl_to_cart(l, c, h):
    hr = h * _RADIANS
    return _join(l, c * torch.cos(hr), c * torch.sin(hr))


def lab_to_lch(a):
    return _cart_to_cyl(*_split(a))


def lch_to_lab(a):
    return _cyl_to_cart(*_split(a))


_XYZ2LMS = _T([[0.8951, 0.2664, -0.1614],
               [-0.7502, 1.7135, 0.0367],
               [0.0389, -0.0685, 1.0296]])

_LMS2XYZ = _T([[0.9869929, -0.1470543, 0.1599627],
               [0.4323053, 0.5183603, 0.0492912],
               [-0.0085287, 0.0400428, 0.9684867]])


def xyz_to_lms(a):
    return _mix3(a, _XYZ2LMS) / 100.0


def lms_to_xyz(a):
    return _mix3(a, _LMS2XYZ) * 100.0


_XYZ2OKLMS = _T([[0.8189330101, 0.3618667424, -0.1288597137],
                 [0.0329845436, 0.9293118715, 0.0361456387],
                 [0.0482003018, 0.2643662691, 0.6338517070]])

_OKLMS2LAB = _T([[0.2104542553, 0.7936177850, -0.0040720468],
                 [1.9779984951, -2.4285922050, 0.4505937099],
                 [0.0259040371, 0.7827717662, -0.8086757660]])

_OKLAB2LMS = _T([[1.0, 0.3963377774, 0.2158037573],
                 [1.0, -0.1055613458, -0.0638541728],
                 [1.0, -0.0894841775, -1.2914855480]])

_OKLMS2XYZ = _T([[1.2270138511, -0.5577999807, 0.2812561490],
                 [-0.0405801784, 1.1122568696, -0.0716766787],
                 [-0.0763812845, -0.4214819784, 1.5861632204]])


def xyz_to_oklab(a):
    lms = _mix3(a / 100.0, _XYZ2OKLMS)
    return _mix3(_cbrt(lms), _OKLMS2LAB)


def oklab_to_xyz(a):
    lms_d = _mix3(a, _OKLAB2LMS)
    return _mix3(lms_d ** 3, _OKLMS2XYZ) * 100.0


def oklab_to_oklch(a):
    return _cart_to_cyl(*_split(a))


def oklch_to_oklab(a):
    return _cyl_to_cart(*_split(a))


def _np_compose(b_t, a_t):
    return _T((np.asarray(b_t, dtype=np.float64).T
               @ np.asarray(a_t, dtype=np.float64).T).tolist())


# the xyz hop's *100 and /100 cancel: one matrix each way, composed in f64
_RGB2OKLMS = _np_compose(_XYZ2OKLMS, _RGB2XYZ)
_OKLMS2RGB = _np_compose(_XYZ2RGB, _OKLMS2XYZ)


def rgb_to_oklab_fused(a):
    lms = _mix3(gamma_to_linear(a), _RGB2OKLMS)
    return _mix3(_cbrt(lms), _OKLMS2LAB)


def oklab_to_rgb_fused(a):
    lms = _mix3(a, _OKLAB2LMS) ** 3
    return torch.clamp(linear_to_gamma(_mix3(lms, _OKLMS2RGB)), 0.0, 1.0)


_LINRGB2XYBMIX = _T([[0.30, 0.622, 0.078],
                     [0.23, 0.692, 0.078],
                     [0.24342268924547819, 0.20476744424496821,
                      0.5518098665095536]])

_XYBMIX2LINRGB = _T([[11.031566901960783, -9.866943921568629,
                      -0.16462299647058826],
                     [-3.254147380392157, 4.418770392156863,
                      -0.16462299647058826],
                     [-3.6588512862745097, 2.7129230470588235,
                      1.9459282392156863]])


def _linrgb_to_xyb(lin):
    lms = torch.clamp_min(_mix3(lin, _LINRGB2XYBMIX) + XYB_BIAS, 0.0)
    d = _cbrt(lms) - XYB_CBRT_BIAS_ENCODE
    l, m, s = _split(d)
    return _join(0.5 * (l - m), 0.5 * (l + m), s)


def _xyb_to_linrgb(a):
    x, y, b = _split(a)
    d = _join(y + x, y - x, b) + XYB_CBRT_BIAS_DECODE
    lms = d ** 3 - XYB_BIAS
    return _mix3(lms, _XYBMIX2LINRGB)


def rgb_to_xyb(a):
    return _linrgb_to_xyb(gamma_to_linear(a))


def xyb_to_rgb(a):
    return torch.clamp(linear_to_gamma(_xyb_to_linrgb(a)), 0.0, 1.0)


def xyz_to_xyb(a):
    return _linrgb_to_xyb(_mix3(a, _XYZ2RGB) / 100.0)


def xyb_to_xyz(a):
    return _mix3(_xyb_to_linrgb(a), _RGB2XYZ) * 100.0


_EDGES = {
    ("gray", "rgb"): gray_to_rgb,
    ("rgb", "gray"): rgb_to_gray,
    ("rgb", "hsl"): rgb_to_hsl,
    ("rgb", "hsv"): rgb_to_hsv,
    ("rgb", "rgba"): rgb_to_rgba,
    ("rgb", "xyb"): rgb_to_xyb,
    ("rgb", "xyz"): rgb_to_xyz,
    ("rgb", "ycbcr"): rgb_to_ycbcr,
    ("rgba", "rgb"): rgba_to_rgb,
    ("hsv", "hsl"): hsv_to_hsl,
    ("hsv", "rgb"): hsv_to_rgb,
    ("hsl", "hsv"): hsl_to_hsv,
    ("hsl", "rgb"): hsl_to_rgb,
    ("xyz", "lab"): xyz_to_lab,
    ("xyz", "lms"): xyz_to_lms,
    ("xyz", "oklab"): xyz_to_oklab,
    ("xyz", "rgb"): xyz_to_rgb,
    ("xyz", "xyb"): xyz_to_xyb,
    ("lab", "lch"): lab_to_lch,
    ("lab", "xyz"): lab_to_xyz,
    ("lch", "lab"): lch_to_lab,
    ("lms", "xyz"): lms_to_xyz,
    ("oklab", "oklch"): oklab_to_oklch,
    ("oklab", "xyz"): oklab_to_xyz,
    ("oklch", "oklab"): oklch_to_oklab,
    ("xyb", "rgb"): xyb_to_rgb,
    ("xyb", "xyz"): xyb_to_xyz,
    ("ycbcr", "rgb"): ycbcr_to_rgb,
}

_FUSED_EDGES = {
    ("rgb", "oklab"): rgb_to_oklab_fused,
    ("oklab", "rgb"): oklab_to_rgb_fused,
    ("rgb", "oklch"): lambda a: oklab_to_oklch(rgb_to_oklab_fused(a)),
    ("oklch", "rgb"): lambda a: oklab_to_rgb_fused(oklch_to_oklab(a)),
}


def _check_channels(arr, src: str, dst: str) -> None:
    for s in (src, dst):
        if s not in NUM_CHANNELS:
            raise ValueError(f"unknown colour space {s!r}")
    if arr.ndim < 1 or arr.shape[-1] != NUM_CHANNELS[src]:
        raise ValueError(f"a {src} array is [..., {NUM_CHANNELS[src]}]; "
                         f"got {tuple(arr.shape)}")


def convert_array(arr, src: str, dst: str):
    """Convert a channel-last ``[..., C_src]`` tensor between colour spaces
    in the source space's float layout (rgb in [0, 1]; hsv h/s/v in
    0-360/0-100/0-100; ...). Any real dtype is cast to float32; returns
    ``[..., C_dst]`` float32 on the input's device."""
    _check_channels(arr, src, dst)
    out = arr.to(torch.float32)
    fused = _FUSED_EDGES.get((src, dst))
    if fused is not None:
        return fused(out)
    for edge in conversion_path(src, dst):
        out = _EDGES[edge](out)
    return out


# -- u8 fixed-point edges (exact, int32) ------------------------------------


def rgb_to_gray_u8(a):
    """u8 ``[..., 3]`` -> u8 ``[..., 1]``, BT.709 16.16 fixed point
    (color.zig:1031): ``floor((r*wr + g*wg + b*wb + 2^15) / 2^16)`` in
    int32. The sum is at most 65536*255 + 2^15, so the JAX package's f32
    form of the same expression gives the same integers."""
    wr, wg, wb = (round(v * 65536) for v in (LUMA_R, LUMA_G, LUMA_B))
    x = a.to(torch.int32)
    y = (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb + 32768) >> 16
    return y.clamp(0, 255).to(torch.uint8)[..., None]


def rgb_to_ycbcr_u8(a):
    """BT.601 16.16 fixed point (color.zig:987-1007) in int32: every sum
    is at most 65536*255 + 2^15 in size, and the arithmetic ``>> 16`` is
    the floor the JAX package takes of the same sum in f32."""
    x = a.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def fix(acc, off):
        return ((acc + 32768) >> 16) + off

    y = fix(r * 19595 + g * 38470 + b * 7471, 0)
    cb = fix(r * -11059 + g * -21710 + b * 32768, 128)
    cr = fix(r * 32768 + g * -27439 + b * -5329, 128)
    return torch.stack([y, cb, cr], dim=-1).clamp(0, 255).to(torch.uint8)


def ycbcr_to_rgb_u8(a):
    """The chroma terms in f32 (each sum is an integer below 2^24, so
    exact), truncated toward zero by the int32 cast as the JAX package's
    ``astype(int32)`` truncates, then added to ``y << 16`` and shifted."""
    y = a[..., 0].to(torch.int32) << 16
    cb = a[..., 1].to(torch.float32) - 128.0
    cr = a[..., 2].to(torch.float32) - 128.0
    tr = (cr * 91881.0 + 32768.0).to(torch.int32)
    tg = (cb * -22554.0 + cr * -46802.0 + 32768.0).to(torch.int32)
    tb = (cb * 116130.0 + 32768.0).to(torch.int32)
    rgb = torch.stack([(y + tr) >> 16, (y + tg) >> 16, (y + tb) >> 16],
                      dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


_U8_EDGES = {
    ("gray", "rgb"): lambda a: a.repeat_interleave(3, dim=-1),
    ("rgb", "gray"): rgb_to_gray_u8,
    ("rgb", "ycbcr"): rgb_to_ycbcr_u8,
    ("ycbcr", "rgb"): ycbcr_to_rgb_u8,
    ("rgb", "rgba"): lambda a: torch.cat(
        [a, torch.full_like(a[..., :1], 255)], dim=-1),
    ("rgba", "rgb"): lambda a: a[..., :3],
}


def convert_u8_array(arr, src: str, dst: str):
    """Exact u8 conversion among gray/rgb/rgba/ycbcr ``[..., C]``
    tensors."""
    _check_channels(arr, src, dst)
    path = conversion_path(src, dst)
    if any(edge not in _U8_EDGES for edge in path):
        raise ValueError(f"no u8 path from {src!r} to {dst!r}: the u8 "
                         "edges join gray, rgb, rgba and ycbcr")
    out = arr
    for edge in path:
        out = _U8_EDGES[edge](out)
    return out
