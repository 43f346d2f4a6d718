"""Plain reference of the colorspace deployment: u8 sRGB ``[B, H, W, 3]``
-> histogram equalization of each image's each channel (exact u8) ->
sRGB -> XYZ (x100) -> CIELAB, the Lab stage computed in ``dtype``:
float64 for the reference, bfloat16 for the control, the precision below
the float32 that the configuration states.

Upstream: https://github.com/arrufat/zignal, ``src/image/enhancement.zig``
(equalize, from line 84) and ``src/color.zig`` (constants 63-89, the sRGB
curve 1243-1259, ``xyzToLab`` 1294). Departures, none of which changes a
value the check compares:
- upstream equalizes one image at a time; here each image of the batch
  has its own tables, in one pass;
- upstream's u32 table arithmetic wraps modulo 2^32; here it is int64
  reduced modulo 2^32 before the division, which gives the same bytes;
- upstream converts one pixel at a time through its colour types; here
  the whole batch at once, each step the same formula.
"""

from __future__ import annotations

import torch

# src/color.zig:63-89
SRGB_GAMMA_THRESHOLD = 0.04045
SRGB_GAMMA_OFFSET = 0.055
SRGB_GAMMA_SCALE = 1.055
SRGB_LINEAR_SLOPE = 12.92
SRGB_GAMMA_EXPONENT = 2.4
D65 = (95.047, 100.000, 108.883)
LAB_EPSILON = 0.008856
LAB_KAPPA_DIV_116 = 7.787
LAB_DELTA = 16.0 / 116.0
# linear sRGB -> XYZ, row-major (out, in)
RGB2XYZ = ((0.4124, 0.3576, 0.1805),
           (0.2126, 0.7152, 0.0722),
           (0.0193, 0.1192, 0.9505))


def equalize_u8(x):
    """Equalize u8 ``[B, H, W, C]``: per image and channel a ``bincount``,
    the int64 CDF, ``cdf_min`` its first non-zero entry, and the table
    ``((cdf - cdf_min) * 255 mod 2^32) // max(total - cdf_min, 1)`` masked
    to 8 bits (0 below ``cdf_min``), the identity where ``total ==
    cdf_min`` (one value only)."""
    b, h, w, c = x.shape
    total = h * w
    planes = x.permute(0, 3, 1, 2).reshape(b * c, total).to(torch.int64)
    out = torch.empty_like(planes)
    for i in range(b * c):
        hist = torch.bincount(planes[i], minlength=256)
        cdf = torch.cumsum(hist, 0)
        cdf_min = cdf[hist > 0][0]
        den = total - cdf_min
        if int(den) == 0:
            table = torch.arange(256, device=x.device)
        else:
            num = ((cdf - cdf_min) * 255) % (1 << 32)
            table = torch.where(cdf >= cdf_min, (num // den) & 0xFF, 0)
        out[i] = table[planes[i]]
    return (out.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()
            .to(torch.uint8))


def srgb_to_lab(x, dtype=torch.float64):
    """u8 sRGB ``[..., 3]`` -> CIELAB ``[..., 3]`` in ``dtype``."""
    c = x.to(dtype) / 255
    lin = torch.where(c > SRGB_GAMMA_THRESHOLD,
                      ((c + SRGB_GAMMA_OFFSET) / SRGB_GAMMA_SCALE)
                      ** SRGB_GAMMA_EXPONENT,
                      c / SRGB_LINEAR_SLOPE)
    m = torch.tensor(RGB2XYZ, dtype=dtype, device=x.device)
    xyz = torch.einsum("...i,oi->...o", lin, m) * 100
    t = xyz / torch.tensor(D65, dtype=dtype, device=x.device)
    f = torch.where(t > LAB_EPSILON, t ** (1 / 3),
                    LAB_KAPPA_DIV_116 * t + LAB_DELTA)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([torch.clamp_min(116 * fy - 16, 0), 500 * (fx - fy),
                        200 * (fy - fz)], -1)


def colorspace(x, dtype=torch.float64):
    """The request on u8 ``[B, H, W, 3]``: (the equalized u8 batch, its
    Lab values in ``dtype``), the Lab stage one image at a time."""
    eq = equalize_u8(x)
    return eq, torch.stack([srgb_to_lab(img, dtype) for img in eq])
