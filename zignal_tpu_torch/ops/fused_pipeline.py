"""The north-star pipeline (bilinear u8 resize -> Gaussian u8 blur ->
optional sRGB -> Oklab) as one CUDA kernel, the counterpart of
zignal_tpu/ops/pallas_pipeline.py.

``fused_resize_blur_oklab`` checks its inputs and launches
``csrc/fused_resize_blur_oklab.cu`` on a CUDA tensor; a CPU tensor goes
to ``fused_resize_blur_oklab_reference``, the plain PyTorch composition of
the three stages. The kernel takes any H, W, OH, OW >= 1 and C in
{1, 3, 4}, so, unlike the TPU kernel, it needs no shape gate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..color._array import _OKLMS2LAB, _RGB2OKLMS, convert_array
from ._build import SMEM_LIMIT, TILES, launch
from .convolution import gaussian_blur_reference
from .interpolation import _resize_bilinear_u8
from .tables import _kernel_to_int, blur_radius, gaussian_kernel, \
    halo_axis_table

__all__ = ["fused_resize_blur_oklab", "fused_resize_blur_oklab_reference"]

# kernel launches since import, read as fused_pipeline.LAUNCHES: a run
# shows with it that the main path went through the kernel
LAUNCHES = 0

# per-shape device tables: (H, W, OH, OW, sigma, device) -> _Plan
_TABLES: dict = {}


def _tile_plan(c: int, r: int):
    """(tile side, dynamic shared-memory bytes) for a blur of radius r:
    the u8 tile plus halo and the int32 width-pass rows must fit a block.
    The layout matches fused_kernel's."""
    for tile in TILES:
        if r == 0:
            return tile, 0
        side = tile + 2 * r
        smem = ((side * side * c + 15) & ~15) + side * tile * c * 4
        if smem <= SMEM_LIMIT:
            return tile, smem
    raise ValueError(f"blur radius {r} needs more shared memory than a "
                     "block has")


class _Plan:
    __slots__ = ("r", "ty", "tx", "taps", "mix")

    def __init__(self, h, w, oh, ow, sigma, device):
        r = blur_radius(sigma)
        kint = _kernel_to_int(gaussian_kernel(sigma)) if r else \
            np.zeros(1, np.int32)
        mix = np.asarray([_RGB2OKLMS, _OKLMS2LAB], np.float32).ravel()
        self.r = r
        self.ty = torch.from_numpy(halo_axis_table(h, oh, r)).to(device)
        self.tx = torch.from_numpy(halo_axis_table(w, ow, r)).to(device)
        self.taps = torch.from_numpy(kint).to(device)
        self.mix = torch.from_numpy(mix).to(device)


def _plan(h, w, oh, ow, sigma, device) -> _Plan:
    key = (h, w, oh, ow, sigma, device)
    plan = _TABLES.get(key)
    if plan is None:
        plan = _TABLES[key] = _Plan(h, w, oh, ow, sigma, device)
    return plan


def _check(batch, out_rows, out_cols, sigma, oklab):
    if not isinstance(batch, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if batch.dtype != torch.uint8 or batch.ndim != 4:
        raise ValueError("expected a uint8 [B, H, W, C] tensor")
    b, h, w, c = batch.shape
    if c not in (1, 3, 4):
        raise ValueError("channel count must be 1, 3, or 4")
    if min(b, h, w) < 1 or min(out_rows, out_cols) < 1:
        raise ValueError("every dimension must be at least 1")
    if not (np.isfinite(sigma) and sigma >= 0):
        raise ValueError("sigma must be finite and non-negative")
    if oklab and c != 3:
        raise ValueError("the Oklab epilogue needs RGB (C == 3)")


def fused_resize_blur_oklab_reference(batch, out_rows: int, out_cols: int,
                                      sigma: float, oklab: bool = True):
    """Plain PyTorch version, on any device: the three stages one after
    the other. u8 ``[B, out_rows, out_cols, C]``, or f32 Oklab when
    ``oklab``."""
    _check(batch, out_rows, out_cols, float(sigma), oklab)
    q = gaussian_blur_reference(
        _resize_bilinear_u8(batch, out_rows, out_cols), float(sigma))
    if not oklab:
        return q
    return convert_array(q.to(torch.float32) / 255.0, "rgb", "oklab")


def fused_resize_blur_oklab(batch, out_rows: int, out_cols: int,
                            sigma: float, oklab: bool = True):
    """[B, H, W, C] u8 -> bilinear resize -> Gaussian blur -> u8
    ``[B, out_rows, out_cols, C]``, or f32 Oklab ``[..., 3]`` when
    ``oklab``. ``sigma=0`` skips the blur. A CUDA tensor runs the kernel
    (or raises); a CPU tensor runs the plain version."""
    global LAUNCHES
    sigma = float(sigma)
    _check(batch, out_rows, out_cols, sigma, oklab)
    if batch.device.type == "cpu":
        return fused_resize_blur_oklab_reference(batch, out_rows, out_cols,
                                                 sigma, oklab)
    if batch.device.type != "cuda":
        raise ValueError(f"no kernel for device {batch.device}")
    if not batch.is_contiguous():
        raise ValueError("the kernel needs a contiguous batch")
    b, h, w, c = batch.shape
    plan = _plan(h, w, out_rows, out_cols, sigma, batch.device)
    tile, smem = _tile_plan(c, plan.r)
    if b > 65535 or -(-out_rows // tile) > 65535:
        raise ValueError("batch or output too large for one launch grid")
    out = torch.empty(
        (b, out_rows, out_cols, 3 if oklab else c),
        dtype=torch.float32 if oklab else torch.uint8, device=batch.device)

    launch("zt_fused_resize_blur_oklab", batch.device, batch.data_ptr(),
           out.data_ptr(), plan.ty.data_ptr(), plan.tx.data_ptr(),
           plan.taps.data_ptr(), plan.mix.data_ptr(), b, h, w, c, out_rows,
           out_cols, plan.r, tile, smem, int(oklab))
    LAUNCHES += 1
    return out
