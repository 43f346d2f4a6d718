"""Image quality metrics (reference: src/image/metrics.zig), the
counterpart of zignal_tpu/ops/metrics.py: plain f32 on the input's
device, one value an image of a ``[..., H, W, C]`` tensor.

SSIM uses the reference's 11x11 Gaussian window (sigma 1.5), Rec.709
luminance for RGB and valid windowing, as separable f32 sums; each
image is centred on its global mean first (window moments are
shift-invariant, and centring keeps identical images at exactly 1). The
reference accumulates in f64 on the host; f32 agrees to about 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["luminance_plane", "psnr", "psnr_of_mse", "ssim",
           "mean_pixel_error"]

_LUMA = (0.2126, 0.7152, 0.0722)


def luminance_plane(arr):
    """f32 ``[..., H, W]`` luminance 0-255 (metrics.zig getPixelScalar)."""
    a = arr.to(torch.float32)
    if arr.shape[-1] == 1:
        return a[..., 0]
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    # XLA divides by the constant 255 as a multiplication by f32(1/255)
    return (_LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b) \
        * np.float32(1.0 / 255.0) * 255.0


def _mean_hw(x):
    """Mean over the last two axes (H, W)."""
    return x.mean(dim=(-2, -1))


def psnr(a, b):
    """PSNR in dB of each image, inf where the images are equal."""
    diff = a.to(torch.float32) - b.to(torch.float32)
    return psnr_of_mse((diff * diff).mean(dim=(-3, -2, -1)))


def psnr_of_mse(mse):
    """PSNR in dB of f32 mean squared errors, inf where 0."""
    peak = float(np.float32(20.0) * np.log10(np.float32(255.0)))
    return torch.where(mse == 0, torch.inf, peak - 10.0 * torch.log10(mse))


def _ssim_window_1d():
    x = np.arange(11, dtype=np.float64) - 5.0
    g = np.exp(-(x * x) / (2.0 * 1.5 * 1.5))
    # the separable outer product over the full 2-D sum, as
    # generateSsimWindow normalises it
    return (g / g.sum()).astype(np.float32)


def _valid_sep_conv(img, k1d):
    """'Valid' separable 11x11 convolution of ``[..., H, W]`` f32."""
    n = img.shape[-1] - 10
    acc = None
    for i, k in enumerate(k1d.tolist()):
        t = img[..., i:i + n] * k
        acc = t if acc is None else acc + t
    m = img.shape[-2] - 10
    out = None
    for i, k in enumerate(k1d.tolist()):
        t = acc[..., i:i + m, :] * k
        out = t if out is None else out + t
    return out


def ssim(a, b):
    """Mean SSIM of each image over valid 11x11 windows; u8 ``[..., H, W,
    C]`` inputs of at least 11x11."""
    x = luminance_plane(a)
    y = luminance_plane(b)
    gx = _mean_hw(x)[..., None, None]
    gy = _mean_hw(y)[..., None, None]
    xc = x - gx
    yc = y - gy
    k1d = _ssim_window_1d()
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    mu_xc = _valid_sep_conv(xc, k1d)
    mu_yc = _valid_sep_conv(yc, k1d)
    mu_x = mu_xc + gx
    mu_y = mu_yc + gy
    sigma_x = torch.clamp_min(_valid_sep_conv(xc * xc, k1d) - mu_xc * mu_xc,
                              0.0)
    sigma_y = torch.clamp_min(_valid_sep_conv(yc * yc, k1d) - mu_yc * mu_yc,
                              0.0)
    sigma_xy = _valid_sep_conv(xc * yc, k1d) - mu_xc * mu_yc
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return _mean_hw(num / den)


def mean_pixel_error(a, b):
    """Mean absolute error of each image, normalised to [0, 1]."""
    diff = torch.abs(a.to(torch.float32) - b.to(torch.float32))
    return diff.mean(dim=(-3, -2, -1)) / 255.0
