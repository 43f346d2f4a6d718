"""The config-3 filter chain (Gaussian blur -> sharpen -> threshold ->
3x3 dilate -> 3x3 erode) as one CUDA kernel, the counterpart of
zignal_tpu/ops/pallas_filter.py.

``fused_blur_sharpen_morph`` checks its inputs and launches
``csrc/fused_blur_sharpen_morph.cu`` on a CUDA tensor; a CPU tensor goes to
``fused_blur_sharpen_morph_reference``, the plain PyTorch composition of
the stages exactly as the JAX package's ``_filter_chain_xla``
(zignal_tpu/pipeline.py:95-104) composes them. The kernel takes any
H, W >= 1, so, unlike the TPU kernel, it needs no shape gate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from ._build import SMEM_LIMIT, TILES, launch
from .binary import dilate, erode, threshold_apply
from .convolution import gaussian_blur_reference
from .integral import sharpen, sums_fit_f32
from .tables import _kernel_to_int, blur_radius, extents, gaussian_kernel, \
    resolve_index_np

__all__ = ["fused_blur_sharpen_morph", "fused_blur_sharpen_morph_reference"]

# kernel launches since import, read as filter_chain.LAUNCHES
LAUNCHES = 0

# per-shape device tables: (H, W, sigma, sharpen_radius, device) -> _Plan
_TABLES: dict = {}


def _a16(n: int) -> int:
    return (n + 15) & ~15


def _smem(tile: int, rb: int, rs: int) -> int:
    """Bytes of fused_blur_sharpen_morph.cu's shared memory for a full
    tile: input u8, blur width pass int32, blurred u8, box width pass
    int32, mask u8, dilated u8. The layout matches filter_kernel's."""
    h = 2 + rs
    it, bt, mt, dt = tile + 2 * (h + rb), tile + 2 * h, tile + 4, tile + 2
    return (_a16(it * it) + 4 * it * bt + _a16(bt * bt) + 4 * bt * mt
            + _a16(mt * mt) + dt * dt)


def _tile_plan(rb: int, rs: int):
    """(tile side, dynamic shared-memory bytes) for blur radius ``rb`` and
    sharpen radius ``rs``: the largest tile whose regions fit a block."""
    for tile in TILES:
        smem = _smem(tile, rb, rs)
        if smem <= SMEM_LIMIT:
            return tile, smem
    raise ValueError(f"blur radius {rb} with sharpen radius {rs} needs more "
                     "shared memory than a block has")


class _Plan:
    __slots__ = ("rb", "int_form", "tile", "smem", "ty", "tx", "ey", "ex",
                 "taps")

    def __init__(self, h, w, sigma, rs, device):
        rb = blur_radius(sigma)
        # sigma 0 blurs with the one tap 256: (x * 256 * 256) >> 16 is x
        kint = _kernel_to_int(gaussian_kernel(sigma)) if rb else \
            np.full(1, 256, np.int32)
        g = 2 + rs + rb

        def halo(n):  # MIRROR-resolved input positions of [-g, n + g)
            pos = resolve_index_np(np.arange(-g, n + g), n, BorderMode.MIRROR)
            return torch.from_numpy(pos.astype(np.int32)).to(device)

        self.rb = rb
        self.int_form = not sums_fit_f32(h, w, rs)
        self.tile, self.smem = _tile_plan(rb, rs)
        self.ty, self.tx = halo(h), halo(w)
        self.ey = torch.from_numpy(extents(h, rs)).to(device)
        self.ex = torch.from_numpy(extents(w, rs)).to(device)
        self.taps = torch.from_numpy(kint).to(device)


def _plan(h, w, sigma, rs, device) -> _Plan:
    key = (h, w, sigma, rs, device)
    plan = _TABLES.get(key)
    if plan is None:
        plan = _TABLES[key] = _Plan(h, w, sigma, rs, device)
    return plan


def _check(x, sigma: float, rs: int):
    if not isinstance(x, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if x.dtype != torch.uint8 or x.ndim not in (2, 3):
        raise ValueError("expected a uint8 [H, W] or [B, H, W] tensor")
    if min(x.shape) < 1:
        raise ValueError("every dimension must be at least 1")
    if not (np.isfinite(sigma) and sigma >= 0):
        raise ValueError("sigma must be finite and non-negative")
    if rs < 0:
        raise ValueError("sharpen radius must be non-negative")


def fused_blur_sharpen_morph_reference(x, sigma: float = 2.0,
                                       sharpen_radius: int = 2,
                                       thr: float = 128.0):
    """Plain PyTorch version, on any device: the stages one after the
    other, as zignal_tpu/pipeline.py:_filter_chain_xla runs them."""
    sigma, rs = float(sigma), int(sharpen_radius)
    _check(x, sigma, rs)
    b = gaussian_blur_reference(x[..., None], sigma)
    s = sharpen(b, rs)
    t = threshold_apply(s[..., 0], float(thr))
    return erode(dilate(t, 3), 3)


def fused_blur_sharpen_morph(x, sigma: float = 2.0, sharpen_radius: int = 2,
                             thr: float = 128.0):
    """u8 ``[H, W]`` or ``[B, H, W]`` -> Gaussian blur -> sharpen ->
    threshold (> thr) -> dilate 3x3 -> erode 3x3 -> u8 mask (0/255) of the
    same shape. A CUDA tensor runs the kernel (or raises); a CPU tensor
    runs the plain version."""
    global LAUNCHES
    sigma, rs, thr = float(sigma), int(sharpen_radius), float(thr)
    _check(x, sigma, rs)
    if x.device.type == "cpu":
        return fused_blur_sharpen_morph_reference(x, sigma, rs, thr)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the kernel needs a contiguous plane")
    h, w = x.shape[-2:]
    planes = x.view(-1, h, w)
    b = planes.shape[0]
    plan = _plan(h, w, sigma, rs, x.device)
    if b > 65535 or -(-h // plan.tile) > 65535:
        raise ValueError("batch or plane too large for one launch grid")
    out = torch.empty_like(planes)

    launch("zt_fused_blur_sharpen_morph", x.device, planes.data_ptr(),
           out.data_ptr(), plan.ty.data_ptr(), plan.tx.data_ptr(),
           plan.ey.data_ptr(), plan.ex.data_ptr(), plan.taps.data_ptr(), b,
           h, w, plan.rb, rs, thr, int(plan.int_form), plan.tile, plan.smem)
    LAUNCHES += 1
    return out.view(x.shape)
