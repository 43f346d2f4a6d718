"""Canny's stencil stages on a card as one kernel (``csrc/canny_front.cu``):
the Gaussian blur (MIRROR), the Sobel gradients (REPLICATE), their
magnitude and the quantized non-maximum suppression, from one shared-memory
tile, each multiply-add rounded as ``ops/fma.py`` rounds it. Equal bit for
bit to the plain route of ``edges.canny`` (``convolve_separable``,
``sobel_gradients``, ``gradient_magnitude``, ``edges._quantized_nms``),
which a CPU plane takes.

``front(gray, sigma)`` takes f32 ``[..., H, W]`` on a card and returns the
f32 magnitude and the bool NMS mask of that shape; ``LAUNCHES`` counts its
launches. ``supports(sigma)`` is False past the kernel's largest radius.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import COUNT_LOCK, cached, check_layout, launch
from .tables import gaussian_kernel

__all__ = ["front", "supports"]

# kernel launches since import
LAUNCHES = 0

MAX_TAPS = 33  # the kernel's largest blur, a radius of 16
TAN_K = np.float32(0.414213562)  # edges._K


def _taps(sigma: float):
    """The Gaussian's taps, or () for no blur."""
    return gaussian_kernel(sigma) if sigma > 0 else ()


def supports(sigma: float) -> bool:
    return len(_taps(sigma)) <= MAX_TAPS


def _kept(weights, n: int):
    """The taps ``convolution._sep_pass_float`` keeps on an axis of ``n``:
    (offsets, f32 weights)."""
    w = np.asarray(weights, np.float32)
    keep = [k for k in range(len(w)) if w[k] != 0 or not 0 < len(w) // 2 < n]
    return keep, w[keep]


def _params(b: int, h: int, w: int, sigma: float):
    taps = _taps(sigma)
    kx, wx = _kept(taps, w)
    ky, wy = _kept(taps, h)
    ints = np.zeros(6 + 2 * MAX_TAPS, np.int32)
    ints[:6] = (b, h, w, len(kx), len(ky), len(taps) // 2)
    ints[6:6 + len(kx)] = kx
    ints[6 + MAX_TAPS:6 + MAX_TAPS + len(ky)] = ky
    floats = np.zeros(2 * MAX_TAPS + 1, np.float32)
    floats[:len(wx)] = wx
    floats[MAX_TAPS:MAX_TAPS + len(wy)] = wy
    floats[-1] = TAN_K
    raw = ints.tobytes() + floats.tobytes()
    return check_layout("zt_canny_front_params_bytes",
                        ctypes.create_string_buffer(raw, len(raw)))


def front(gray, sigma: float):
    """(f32 magnitude, bool NMS mask) of the f32 ``[..., H, W]`` plane
    ``gray`` on a card, blurred by the Gaussian of ``sigma`` first."""
    global LAUNCHES
    if gray.dtype != torch.float32 or gray.ndim < 2:
        raise ValueError("the kernel needs an f32 [..., H, W] plane")
    if gray.device.type != "cuda":
        raise ValueError(f"no kernel for device {gray.device}")
    if not supports(sigma):
        raise ValueError(f"sigma {sigma}: the kernel's blur takes at most "
                         f"{MAX_TAPS} taps")
    h, w = gray.shape[-2:]
    x = gray.contiguous()
    b = x.numel() // (h * w) if x.numel() else 0
    if b > 65535:
        raise ValueError("too many planes for one launch grid")
    mag = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if b:
        params = cached(_params, b, h, w, float(sigma))
        launch("zt_canny_front", x.device, x.data_ptr(), mag.data_ptr(),
               mask.data_ptr(), params)
        with COUNT_LOCK:
            LAUNCHES += 1
    return mag, mask.view(torch.bool)
