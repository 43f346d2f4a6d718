"""Linear and radial motion blur (reference: src/image/motion_blur.zig), the
counterpart of zignal_tpu/ops/motion_blur_ops.py.

Both take ``[..., H, W, C]`` and run on its device. The sample coordinates
are numpy float32 on the host, computed with the JAX package's static
expressions: a linear blur's per-tap shifts, a radial blur's per-pixel
fields (``sample_fn_np``; spin keeps the host libm's arctan2, cos and
sin). The radial fields are uploaded once a configuration and kept on the
device in a small cache (``_COORDS``); the taps, weights and sums run
there. The JAX package's union boxes, grouped windows, packed lanes and
``ZT_RADIAL_*`` knobs are TPU gather schemes and are not ported: the
port reads the same clamped bilinear taps with plain index reads and adds
the in-bounds samples in ascending order, the f32 sum of the reference's
per-sample loop.

An axis-aligned linear blur is a box filter under REPLICATE: the port's
``convolve_separable``, the separable u8 kernel on the card.

``ImageBatch.motion_blur`` takes this same route. The JAX package's batch
method vmaps ``radial_blur``, which sends the traced batch to its
device-coordinate fallback (``_radial_device``): its spin differs from its
own ``Image.motion_blur`` by up to 56 at about 1 % of pixels. The port's
batch equals the JAX package's ``Image.motion_blur`` on every image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from .convolution import convolve_separable
from .fma import fma

__all__ = ["linear_motion_blur", "radial_blur", "radial_coords"]

_F32 = np.float32

# (h, w, centre, strength, zoom, device) -> (sx, sy) [n, h, w] f32 tensors
_COORDS: dict = {}
_COORDS_MAX = 8


def _lerp(lo, hi, f, g):
    """``lo * g + hi * f`` (``g = 1 - f``), contracted as the JAX
    package's compiled program contracts it: the second product rounds
    alone, the first fuses into the sum. (Its linear blur, whose weights
    are constants of the program, picks the fused product tap by tap; there
    the f32 sums can differ by an ulp, below a u8 step.)"""
    return fma(lo, g, hi * f)


def _finish(mean, count, a, dtype):
    """The mean of the in-bounds samples, else the source pixel; u8
    rounds half up."""
    result = torch.where(count > 0, mean, a)
    if dtype == torch.uint8:
        return torch.clamp(torch.floor(result + 0.5), 0, 255).to(torch.uint8)
    return result.to(dtype)


def linear_motion_blur(arr, angle: float, distance: int):
    """Average along a motion line (motion_blur.zig:65-175)."""
    if distance == 0:
        return arr
    cos_a = float(np.cos(_F32(angle)))
    sin_a = float(np.sin(_F32(angle)))
    eps = 0.001
    if abs(sin_a) < eps or abs(cos_a) < eps:
        # a uniform kernel along one axis, replicate border
        kern = tuple([1.0 / distance] * distance)
        ident = (1.0,)
        kx, ky = (kern, ident) if abs(sin_a) < eps else (ident, kern)
        return convolve_separable(arr, kx, ky, BorderMode.REPLICATE)
    half = distance / 2.0
    # t walks -half, -half+1, ... while t <= half
    ts = [-half + i for i in range(distance + 2) if -half + i <= half]
    h, w = arr.shape[-3], arr.shape[-2]
    dev = arr.device
    total = None
    count = np.zeros((h, w, 1), _F32)  # a constant of the compiled program
    for t in ts:
        # constant shifts: each tap's corners are whole rows and columns,
        # edge-clamped (an out-of-image tap is masked below)
        xs = np.arange(w, dtype=_F32) + _F32(t * cos_a)
        ys = np.arange(h, dtype=_F32) + _F32(t * sin_a)
        x0 = np.floor(xs)
        y0 = np.floor(ys)
        fx = torch.from_numpy((xs - x0).astype(_F32)).to(dev)[:, None]
        fy = torch.from_numpy((ys - y0).astype(_F32)).to(dev)[:, None, None]
        xi, yi = x0.astype(np.int64), y0.astype(np.int64)
        cols = [torch.from_numpy(np.clip(xi + d, 0, w - 1)).to(dev)
                for d in (0, 1)]
        rows = [torch.from_numpy(np.clip(yi + d, 0, h - 1)).to(dev)
                for d in (0, 1)]
        v = [[arr.index_select(-3, r).index_select(-2, c).to(torch.float32)
              for c in cols] for r in rows]
        v0 = _lerp(v[0][0], v[0][1], fx, 1 - fx)
        v1 = _lerp(v[1][0], v[1][1], fx, 1 - fx)
        val = _lerp(v0, v1, fy, 1 - fy)
        inside = (((xs >= 0) & (xs < w))[None, :]
                  & ((ys >= 0) & (ys < h))[:, None])[..., None]
        val = torch.where(torch.from_numpy(inside).to(dev), val, 0.0)
        total = val if total is None else total + val
        count += inside
    # XLA divides by the constant count as a multiplication by its f32
    # reciprocal
    inv = torch.from_numpy(_F32(1.0) / np.maximum(count, _F32(1.0))).to(dev)
    return _finish(total * inv, torch.from_numpy(count).to(dev),
                   arr.to(torch.float32), arr.dtype)


def radial_coords(h: int, w: int, center_x: float, center_y: float,
                  strength: float, zoom: bool, device):
    """The per-sample source fields ``(sx, sy)``, f32 ``[n, h, w]`` on
    ``device``: computed once a configuration in numpy f32 with the
    reference's per-pixel expressions (motion_blur.zig:269-309), uploaded,
    and kept in a cache of ``_COORDS_MAX`` configurations."""
    key = (h, w, float(center_x), float(center_y), float(strength),
           bool(zoom), torch.device(device))
    hit = _COORDS.get(key)
    if hit is not None:
        return hit
    s_cl = min(max(strength, 0.0), 1.0)
    n = 8 + int(np.trunc(s_cl * 24))
    cxf = _F32(center_x) * _F32(w - 1)
    cyf = _F32(center_y) * _F32(h - 1)
    sclf = _F32(s_cl)
    maxdf = np.sqrt(cxf * cxf + cyf * cyf)
    ys, xs = np.meshgrid(np.arange(h, dtype=_F32), np.arange(w, dtype=_F32),
                         indexing="ij")
    dx = xs - cxf
    dy = ys - cyf
    dist = np.sqrt(dx * dx + dy * dy)
    sx = np.empty((n, h, w), _F32)
    sy = np.empty((n, h, w), _F32)
    if zoom:
        blur_amount = dist / max(maxdf, _F32(1e-6)) * sclf * _F32(20.0)
    else:
        angle = np.arctan2(dy, dx)
    for s in range(n):
        t = (_F32(s) - _F32(n - 1) / _F32(2.0)) / _F32(n - 1)
        if zoom:
            scale = _F32(1.0) + t * blur_amount * _F32(0.1)
            sx[s] = cxf + dx * scale
            sy[s] = cyf + dy * scale
        else:
            new_angle = angle + t * (sclf * _F32(0.5))
            sx[s] = cxf + dist * np.cos(new_angle)
            sy[s] = cyf + dist * np.sin(new_angle)
    hit = (torch.from_numpy(sx).to(device), torch.from_numpy(sy).to(device))
    if len(_COORDS) >= _COORDS_MAX:
        _COORDS.pop(next(iter(_COORDS)))
    _COORDS[key] = hit
    return hit


def _bilinear_clamped(arr, sx, sy):
    """The reference's clamped bilinear tap (motion_blur.zig:140-157):
    x0 from floor clamped into the image, x1 = min(x0 + 1, w - 1)."""
    h, w = arr.shape[-3], arr.shape[-2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp_max(x0i + 1, w - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    lead = arr.shape[:-3]
    flat = arr.reshape(*lead, h * w, arr.shape[-1])

    def tap(y, x):
        return flat.index_select(len(lead), (y * w + x).reshape(-1)) \
            .reshape(*lead, h, w, arr.shape[-1]).to(torch.float32)

    v0 = _lerp(tap(y0i, x0i), tap(y0i, x1i), fx, 1 - fx)
    v1 = _lerp(tap(y1i, x0i), tap(y1i, x1i), fx, 1 - fx)
    return _lerp(v0, v1, fy, 1 - fy)


def radial_blur(arr, center_x: float, center_y: float, strength: float,
                zoom: bool):
    """Radial zoom or spin blur (motion_blur.zig radial:240+) of ``[..., H,
    W, C]``: the in-bounds samples of each pixel averaged in ascending
    sample order, the source pixel where none is in bounds."""
    if strength == 0:
        return arr
    h, w = arr.shape[-3], arr.shape[-2]
    sxs, sys_ = radial_coords(h, w, center_x, center_y, strength, zoom,
                              arr.device)
    total = torch.zeros(arr.shape, dtype=torch.float32, device=arr.device)
    count = torch.zeros((h, w, 1), dtype=torch.float32, device=arr.device)
    for sx, sy in zip(sxs, sys_):
        inside = ((sx >= 0) & (sx < w) & (sy >= 0) & (sy < h))[..., None]
        total = total + torch.where(inside, _bilinear_clamped(arr, sx, sy),
                                    0.0)
        count = count + inside
    return _finish(total / torch.clamp_min(count, 1.0), count,
                   arr.to(torch.float32), arr.dtype)
