"""Separable u8 convolution over banded integer matrices as one CUDA
kernel, the counterpart of zignal_tpu/ops/pallas_conv.py.

``separable_u8(x, Mx, My)`` applies ``Mx [OW, W]`` along the columns and
``My [OH, H]`` along the rows of a ``[B, H, W, C]`` u8 tensor, C <= 4, then
divClampU8 by 256^2. A CUDA tensor launches ``csrc/separable_u8.cu``; a CPU
tensor goes to ``separable_u8_reference``. The kernel takes any H, W, OH,
OW >= 1, so, unlike the TPU kernel, it needs no shape gate. u8
``convolve_separable`` on a CUDA tensor reaches the kernel through
``run_cached``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ._build import SMEM_LIMIT, TILES, launch
from .convolution import _div_clamp_u8
from .tables import SCALE, band_to_taps, tile_sources

__all__ = ["separable_u8", "separable_u8_reference", "run_cached"]

# kernel launches since import, read as separable_conv.LAUNCHES
LAUNCHES = 0

# device tables: (key, C, device) -> _Plan
_TABLES: dict = {}


def _row_sum(M) -> int:
    return int(np.abs(np.asarray(M, np.int64)).sum(axis=1).max(initial=0))


def _check(x, Mx, My):
    if not isinstance(x, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if x.dtype != torch.uint8 or x.ndim != 4:
        raise ValueError("expected a uint8 [B, H, W, C] tensor")
    b, h, w, c = x.shape
    if not 1 <= c <= 4:
        raise ValueError("channel count must be 1 to 4")
    if min(b, h, w) < 1:
        raise ValueError("every dimension must be at least 1")
    if Mx.ndim != 2 or My.ndim != 2 or Mx.shape[1] != w or My.shape[1] != h:
        raise ValueError("expected Mx [OW, W] and My [OH, H]")
    if min(Mx.shape[0], My.shape[0]) < 1:
        raise ValueError("every dimension must be at least 1")
    if 255 * _row_sum(Mx) * _row_sum(My) + SCALE * SCALE // 2 >= 2 ** 31:
        raise ValueError("band weights overflow the int32 accumulator")


def _band_pass(x, M, axis: int):
    """Contract ``axis`` of int32 ``x`` with the band ``M [dst, src]``:
    a gather per tap column, weighted per output position."""
    idx, w = (torch.from_numpy(t).to(x.device) for t in band_to_taps(M))
    shape = [1] * x.ndim
    shape[axis] = idx.shape[0]
    total = None
    for k in range(idx.shape[1]):
        term = x.index_select(axis, idx[:, k]) * w[:, k].view(shape)
        total = term if total is None else total + term
    return total


def separable_u8_reference(x, Mx, My):
    """Plain PyTorch version, on any device: int32 column pass, row pass,
    divClampU8 by 256^2."""
    Mx, My = np.asarray(Mx), np.asarray(My)
    _check(x, Mx, My)
    t = _band_pass(x.to(torch.int32), Mx, 2)
    return _div_clamp_u8(_band_pass(t, My, 1), SCALE * SCALE)


class _Plan:
    __slots__ = ("tile", "smem", "oh", "ow", "sy", "ky", "sx", "kx",
                 "ysrc", "yidx", "yw", "xsrc", "xidx", "xw")

    def __init__(self, Mx, My, c, device):
        yi, yw = band_to_taps(My)
        xi, xw = band_to_taps(Mx)
        for tile in TILES:
            ysrc, ylocal = tile_sources(yi, yw, tile)
            xsrc, xlocal = tile_sources(xi, xw, tile)
            sy, sx = ysrc.shape[1], xsrc.shape[1]
            smem = ((sy * sx * c + 15) & ~15) + sy * tile * c * 4
            if smem <= SMEM_LIMIT:
                break
        else:
            raise ValueError("the bands read more source rows and columns "
                             "per tile than a block's shared memory holds")
        self.tile, self.smem = tile, smem
        self.oh, self.ow = My.shape[0], Mx.shape[0]
        self.sy, self.ky, self.sx, self.kx = sy, yw.shape[1], sx, xw.shape[1]
        self.ysrc, self.yidx, self.yw = (torch.from_numpy(t).to(device)
                                         for t in (ysrc, ylocal, yw))
        self.xsrc, self.xidx, self.xw = (torch.from_numpy(t).to(device)
                                         for t in (xsrc, xlocal, xw))


def run_cached(x, key, bands):
    """Launch the kernel on the CUDA u8 ``[B, H, W, C]`` tensor ``x``. The
    device tables are cached under ``key``; on a miss ``bands()`` gives
    ``(Mx, My)``. The caller has checked the int32 bound."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError("the kernel needs a uint8 [B, H, W, C<=4] tensor")
    if not x.is_contiguous():
        raise ValueError("the kernel needs a contiguous batch")
    b, h, w, c = x.shape
    full = (key, c, x.device)
    plan = _TABLES.get(full)
    if plan is None:
        plan = _TABLES[full] = _Plan(*bands(), c, x.device)
    if b > 65535 or -(-plan.oh // plan.tile) > 65535:
        raise ValueError("batch or output too large for one launch grid")
    out = torch.empty((b, plan.oh, plan.ow, c), dtype=torch.uint8,
                      device=x.device)

    launch("zt_separable_u8", x.device, x.data_ptr(), out.data_ptr(),
           plan.ysrc.data_ptr(), plan.yidx.data_ptr(), plan.yw.data_ptr(),
           plan.xsrc.data_ptr(), plan.xidx.data_ptr(), plan.xw.data_ptr(),
           b, h, w, c, plan.oh, plan.ow, plan.sy, plan.ky, plan.sx, plan.kx,
           plan.tile, plan.smem)
    LAUNCHES += 1
    return out


def separable_u8(x, Mx, My):
    """Apply the integer bands ``Mx [OW, W]`` (columns) and ``My [OH, H]``
    (rows) to a u8 ``[B, H, W, C]`` tensor with the divClampU8 epilogue,
    -> u8 ``[B, OH, OW, C]``. A CUDA tensor runs the kernel (or raises); a
    CPU tensor runs the plain version."""
    Mx = np.ascontiguousarray(Mx, np.int64)
    My = np.ascontiguousarray(My, np.int64)
    _check(x, Mx, My)
    if x.device.type == "cpu":
        return separable_u8_reference(x, Mx, My)
    key = ("bands", Mx.shape, My.shape, hashlib.sha256(Mx).hexdigest(),
           hashlib.sha256(My).hexdigest())
    return run_cached(x, key, lambda: (Mx, My))
