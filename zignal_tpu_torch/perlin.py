"""Classic 3-D Perlin gradient noise (reference: src/perlin.zig, ported
from Ken Perlin's reference implementation at mrl.cs.nyu.edu/~perlin/noise).

Scalar `perlin()` mirrors the zignal module function; `perlin_array`
evaluates a whole coordinate grid on the device for image synthesis.

Copied from zignal_tpu/perlin.py (the scalar on the host); `perlin_array`
runs on torch, each op rounded on its own in f32 as the JAX package's
eager version rounds it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["perlin", "perlin_array"]

# Ken Perlin's standard permutation (public reference data), doubled.
_P = [
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
]
_PERM = _P + _P


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _lerp(a, b, t):
    return a + t * (b - a)


def _grad(h, x, y, z):
    h &= 15
    u = x if h < 8 else y
    v = y if h < 4 else (x if h in (12, 14) else z)
    return (u if (h & 1) == 0 else -u) + (v if (h & 2) == 0 else -v)


def _noise(x, y, z):
    xi = int(math.floor(x)) & 255
    yi = int(math.floor(y)) & 255
    zi = int(math.floor(z)) & 255
    xr = x - math.floor(x)
    yr = y - math.floor(y)
    zr = z - math.floor(z)
    u, v, w = _fade(xr), _fade(yr), _fade(zr)
    a = (_PERM[xi] + yi) & 255
    aa = (_PERM[a] + zi) & 255
    ab = (_PERM[(a + 1) & 255] + zi) & 255
    b = (_PERM[(xi + 1) & 255] + yi) & 255
    ba = (_PERM[b] + zi) & 255
    bb = (_PERM[(b + 1) & 255] + zi) & 255
    return _lerp(
        _lerp(
            _lerp(_grad(_PERM[aa], xr, yr, zr), _grad(_PERM[ba], xr - 1, yr, zr), u),
            _lerp(_grad(_PERM[ab], xr, yr - 1, zr), _grad(_PERM[bb], xr - 1, yr - 1, zr), u),
            v,
        ),
        _lerp(
            _lerp(_grad(_PERM[(aa + 1) & 255], xr, yr, zr - 1),
                  _grad(_PERM[(ba + 1) & 255], xr - 1, yr, zr - 1), u),
            _lerp(_grad(_PERM[(ab + 1) & 255], xr, yr - 1, zr - 1),
                  _grad(_PERM[(bb + 1) & 255], xr - 1, yr - 1, zr - 1), u),
            v,
        ),
        w,
    )


def _validate(amplitude, frequency, octaves, persistence, lacunarity):
    if not amplitude > 0:
        raise ValueError("amplitude must be between 0 (exclusive) and inf")
    if not frequency > 0:
        raise ValueError("frequency must be between 0 (exclusive) and inf")
    if not 1 <= octaves <= 32:
        raise ValueError("octaves must be between 1 and 32")
    if not 0 <= persistence <= 1:
        raise ValueError("persistence must be between 0 and 1")
    if not 1 <= lacunarity <= 16:
        raise ValueError("lacunarity must be between 1 and 16")


def perlin(x, y, z=0.0, amplitude=1.0, frequency=1.0, octaves=1,
           persistence=0.5, lacunarity=2.0) -> float:
    """Fractal Perlin noise at (x, y, z) (reference: perlin.zig:43-56)."""
    _validate(amplitude, frequency, int(octaves), persistence, lacunarity)
    total = 0.0
    max_amplitude = 0.0
    cur_amplitude = 1.0
    cur_frequency = frequency
    for _ in range(int(octaves)):
        total += _noise(x * cur_frequency, y * cur_frequency, z * cur_frequency) * cur_amplitude
        cur_amplitude *= persistence
        cur_frequency *= lacunarity
        max_amplitude += cur_amplitude
    return total / max_amplitude * amplitude


def perlin_array(xs, ys, z=0.0, amplitude=1.0, frequency=1.0, octaves=1,
                 persistence=0.5, lacunarity=2.0, *, device=None):
    """Vectorized fractal noise over coordinate arrays, f32 on the device:
    torch tensors on their own device, numpy arrays (or lists) on
    ``device``, which must then be named."""
    _validate(amplitude, frequency, int(octaves), persistence, lacunarity)
    if device is not None:
        dev = torch.device(device)
    elif isinstance(xs, torch.Tensor):
        dev = xs.device
    else:
        raise ValueError("numpy coordinates need device=")

    def coords(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, np.float32))
        return a.to(device=dev, dtype=torch.float32)

    xs, ys = coords(xs), coords(ys)
    perm = torch.tensor(_PERM, dtype=torch.int64, device=dev)

    def grad(h, gx, gy, gz):
        h = h & 15
        uu = torch.where(h < 8, gx, gy)
        vv = torch.where(h < 4, gy, torch.where((h == 12) | (h == 14), gx, gz))
        return (torch.where(h & 1 == 0, uu, -uu)
                + torch.where(h & 2 == 0, vv, -vv))

    def noise(x, y, zc: float):
        fx, fy = torch.floor(x), torch.floor(y)
        fz = np.floor(np.float32(zc))
        xi = fx.to(torch.int64) & 255
        yi = fy.to(torch.int64) & 255
        zi = int(fz) & 255
        xr = x - fx
        yr = y - fy
        zr = torch.tensor(np.float32(zc) - fz, device=dev)
        u = _fade(xr)
        v = _fade(yr)
        w = _fade(zr)
        a = (perm[xi] + yi) & 255
        aa = (perm[a] + zi) & 255
        ab = (perm[(a + 1) & 255] + zi) & 255
        b = (perm[(xi + 1) & 255] + yi) & 255
        ba = (perm[b] + zi) & 255
        bb = (perm[(b + 1) & 255] + zi) & 255
        return _lerp(
            _lerp(
                _lerp(grad(perm[aa], xr, yr, zr),
                      grad(perm[ba], xr - 1, yr, zr), u),
                _lerp(grad(perm[ab], xr, yr - 1, zr),
                      grad(perm[bb], xr - 1, yr - 1, zr), u),
                v,
            ),
            _lerp(
                _lerp(grad(perm[(aa + 1) & 255], xr, yr, zr - 1),
                      grad(perm[(ba + 1) & 255], xr - 1, yr, zr - 1), u),
                _lerp(grad(perm[(ab + 1) & 255], xr, yr - 1, zr - 1),
                      grad(perm[(bb + 1) & 255], xr - 1, yr - 1, zr - 1), u),
                v,
            ),
            w,
        )

    total = torch.zeros_like(xs)
    max_amplitude = 0.0
    cur_amplitude = 1.0
    cur_frequency = float(frequency)
    for _ in range(int(octaves)):
        total = total + noise(xs * cur_frequency, ys * cur_frequency,
                              z * cur_frequency) * cur_amplitude
        cur_amplitude *= persistence
        cur_frequency *= lacunarity
        max_amplitude += cur_amplitude
    # a device tensor: a true division on the card too, where dividing by
    # a Python scalar multiplies by its reciprocal
    peak = torch.tensor(max_amplitude, dtype=torch.float32, device=dev)
    return total / peak * amplitude
