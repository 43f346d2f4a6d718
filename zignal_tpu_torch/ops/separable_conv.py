"""Separable u8 convolution over banded integer matrices as one CUDA
kernel, the counterpart of zignal_tpu/ops/pallas_conv.py.

``separable_u8(x, Mx, My)`` applies ``Mx [OW, W]`` along the columns and
``My [OH, H]`` along the rows of a ``[B, H, W, C]`` u8 tensor, then
divClampU8 by 256^2; the kernel runs more than 4 channels in groups of at
most 4. A CUDA tensor launches ``csrc/separable_u8.cu``; a CPU
tensor goes to ``separable_u8_reference``. The kernel takes any H, W, OH,
OW >= 1, so, unlike the TPU kernel, it needs no shape gate.

Two entries launch it. ``run_conv`` takes a convolution's 1-D taps and
border (u8 ``convolve_separable`` on a CUDA tensor): every output has the
same taps at consecutive offsets, and the halo tables resolve the border,
so the kernel's ``conv_kernel`` convolves contiguous staged regions.
``run_cached`` takes any pair of bands (``separable_u8``): ``band_kernel``
reads per-output tap lists. Both count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from ..enums import BorderMode
from ._build import COUNT_LOCK, SMEM_LIMIT, TILES, launch, load, sm_count
from .convolution import _div_clamp_u8
from .tables import SCALE, band_to_taps, resolve_index_np, tile_sources

__all__ = ["separable_u8", "separable_u8_reference", "run_cached",
           "run_conv", "f32_exact", "conv_tile_plan"]

# kernel launches since import, read as separable_conv.LAUNCHES (a call of
# C channels launches launches_for(C) times)
LAUNCHES = 0

# device tables and parameters: key -> _BandPlan or _ConvPlan
_TABLES: dict = {}

# conv_kernel's tap tables hold this many taps an axis; longer kernels go
# through band_kernel
MAX_TAPS = 256
ROWS = 8  # rows a thread of the height pass computes
# (tile columns, tile rows) of conv_kernel in order of preference, powers
# of two; a grid of fewer than MIN_BLOCKS_PER_SM blocks an SM takes the next.
# The width pass's rows have the pitch of the widest, TILE_W pixels.
CONV_TILES = ((64, 32), (64, 16), (32, 16), (32, 8), (16, 8), (8, 8),
              (4, 8))
TILE_W = 64
MIN_BLOCKS_PER_SM = 4
F32_EXACT = 1 << 24
_CONV_FIELDS = ("B", "H", "W", "C", "kx", "ky", "ax", "ay", "th", "tw",
                "tiles_x", "tiles_y", "lg_g", "lg_nch", "sp", "vec_in", "f32",
                "off_t", "smem", "cs", "c0")
_BAND_FIELDS = ("B", "H", "W", "C", "OH", "OW", "sy", "ky", "sx", "kx",
                "tile", "off_tmp", "off_xt", "off_yt", "smem", "cs", "c0")
# the kernels run at most this many channels a launch (shared memory is
# planned for a group of GROUP channels when an image has more)
GROUP = 4


def launches_for(c: int) -> int:
    """Launches of one call on ``c`` channels: one a group of at most
    ``GROUP`` channels."""
    return -(-c // GROUP)


def _a16(n: int) -> int:
    return (n + 15) & ~15


def _row_sum(M) -> int:
    """Largest sum of |weights| of a band's rows, or of a 1-D kernel's
    taps."""
    M = np.abs(np.asarray(M, np.int64))
    return int(M.sum(axis=-1).max(initial=0)) if M.ndim == 2 else int(M.sum())


def f32_exact(Mx, My) -> bool:
    """Whether the kernel's f32 height pass gives the int32 result: every
    partial sum is an integer below 2^24 (255 * rowsum|Mx| * rowsum|My| <
    2^24), or both bands are non-negative, so partial sums only rise and a
    sum that reaches 2^24 clips to 255 either way. ``Mx``, ``My``: bands
    ``[dst, src]`` or 1-D kernels."""
    if (np.asarray(Mx) >= 0).all() and (np.asarray(My) >= 0).all():
        return True
    return 255 * _row_sum(Mx) * _row_sum(My) < F32_EXACT


def _check(x, Mx, My):
    if not isinstance(x, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if x.dtype != torch.uint8 or x.ndim != 4:
        raise ValueError("expected a uint8 [B, H, W, C] tensor")
    b, h, w, c = x.shape
    if c < 1:
        raise ValueError("channel count must be at least 1")
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


def _buffer(fields, values, tail=()):
    """A parameter struct as a host buffer the launch copies by value:
    the int fields in order, then the arrays of ``tail`` (int32 or f32)."""
    raw = np.array([values[f] for f in fields], np.int32).tobytes()
    raw += b"".join(np.ascontiguousarray(t).tobytes() for t in tail)
    return ctypes.create_string_buffer(raw, len(raw))


def _check_layout(name: str, buf) -> None:
    if getattr(load(), name)() != len(buf.raw):
        raise RuntimeError(f"the kernel's parameter layout ({name}) differs "
                           "from the wrapper's")


class _BandPlan:
    __slots__ = ("oh", "ow", "grid_y", "smem", "params", "ysrc", "yidx",
                 "yw", "xsrc", "xidx", "xw")

    def __init__(self, Mx, My, b, h, w, c, device):
        yi, yw = band_to_taps(My)
        xi, xw = band_to_taps(Mx)
        ky, kx = yw.shape[1], xw.shape[1]
        cs, c = c, min(c, GROUP)
        for tile in TILES:
            ysrc, ylocal = tile_sources(yi, yw, tile)
            xsrc, xlocal = tile_sources(xi, xw, tile)
            sy, sx = ysrc.shape[1], xsrc.shape[1]
            off_tmp = _a16(sy * sx * c)
            off_xt = off_tmp + 4 * sy * tile * c
            off_yt = off_xt + 8 * tile * kx
            smem = off_yt + 8 * tile * ky
            if smem <= SMEM_LIMIT:
                break
        else:
            raise ValueError("the bands read more source rows and columns "
                             "per tile than a block's shared memory holds")
        self.oh, self.ow = My.shape[0], Mx.shape[0]
        self.grid_y, self.smem = -(-self.oh // tile), smem
        self.params = _buffer(_BAND_FIELDS, dict(
            B=b, H=h, W=w, C=cs, OH=self.oh, OW=self.ow, sy=sy, ky=ky, sx=sx,
            kx=kx, tile=tile, off_tmp=off_tmp, off_xt=off_xt, off_yt=off_yt,
            smem=smem, cs=cs, c0=0))
        self.ysrc, self.yidx, self.yw = (torch.from_numpy(t).to(device)
                                         for t in (ysrc, ylocal, yw))
        self.xsrc, self.xidx, self.xw = (torch.from_numpy(t).to(device)
                                         for t in (xsrc, xlocal, xw))


def _check_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[3] < 1:
        raise ValueError("the kernel needs a uint8 [B, H, W, C] tensor")
    if not x.is_contiguous():
        raise ValueError("the kernel needs a contiguous batch")
    if x.shape[0] > 65535:
        raise ValueError("batch too large for one launch grid")


def run_cached(x, key, bands):
    """Launch band_kernel on the CUDA u8 ``[B, H, W, C]`` tensor ``x``.
    The device tables are cached under ``key``; on a miss ``bands()``
    gives ``(Mx, My)``. The caller has checked the int32 bound."""
    global LAUNCHES
    _check_cuda(x)
    b, h, w, c = x.shape
    full = ("band", key, b, c, x.device)
    plan = _TABLES.get(full)
    if plan is None:
        plan = _TABLES[full] = _BandPlan(*bands(), b, h, w, c, x.device)
        _check_layout("zt_band_params_bytes", plan.params)
    if plan.grid_y > 65535:
        raise ValueError("output too large for one launch grid")
    out = torch.empty((b, plan.oh, plan.ow, c), dtype=torch.uint8,
                      device=x.device)

    launch("zt_separable_u8", x.device, x.data_ptr(), out.data_ptr(),
           plan.ysrc.data_ptr(), plan.yidx.data_ptr(), plan.yw.data_ptr(),
           plan.xsrc.data_ptr(), plan.xidx.data_ptr(), plan.xw.data_ptr(),
           plan.params)
    with COUNT_LOCK:
        LAUNCHES += launches_for(c)
    return out


class ConvTilePlan:
    """conv_kernel's tile of ``th`` x ``tw`` output pixels for ``kx`` x
    ``ky`` taps and ``c`` channels: the staged rows' pitch ``sp`` and the
    shared-memory layout (staged bytes, then the width pass's values,
    int32 or f32, in rows of ``TILE_W`` pixels with ``ROWS`` rows of
    slack)."""

    __slots__ = ("th", "tw", "sp", "off_t", "smem", "blocks")

    def __init__(self, tw: int, th: int, kx: int, ky: int, c: int):
        self.tw, self.th = tw, th
        self.sp = _a16((tw + kx - 1) * c) + 16
        self.off_t = _a16((th + ky - 1) * self.sp + 64)
        self.smem = self.off_t + 4 * (th + ky - 1 + ROWS) * TILE_W * c
        self.blocks = 0


def conv_tile_plan(kx: int, ky: int, c: int, h: int, w: int, b: int,
                   sms: int) -> ConvTilePlan:
    """The tile of ``B = b`` images of ``h x w x c`` on a card of ``sms``
    SMs: the first of ``CONV_TILES`` that fits a block's shared memory and
    gives the grid at least ``MIN_BLOCKS_PER_SM`` blocks an SM, else the
    fitting one with the most blocks."""
    best = None
    for tw, th in CONV_TILES:
        plan = ConvTilePlan(tw, th, kx, ky, c)
        if plan.smem > SMEM_LIMIT:
            continue
        plan.blocks = b * -(-h // th) * -(-w // tw)
        if plan.blocks >= MIN_BLOCKS_PER_SM * sms:
            return plan
        if best is None or plan.blocks > best.blocks:
            best = plan
    if best is None:
        raise ValueError(f"{kx} x {ky} taps need more shared memory than a "
                         "block has")
    return best


def _halo(n: int, k: int, border: BorderMode, device):
    """Source positions of ``[-k // 2, n + k - 1 - k // 2)`` under the
    border, int32 (-1 where a ZERO border reads 0)."""
    pos = resolve_index_np(np.arange(n + k - 1) - k // 2, n, border)
    return torch.from_numpy(pos.astype(np.int32)).to(device)


class _ConvPlan:
    __slots__ = ("tile", "ty", "tx", "fields", "tail", "params")

    def __init__(self, kx, ky, border, b, h, w, c, device):
        t = self.tile = conv_tile_plan(len(kx), len(ky), min(c, GROUP), h,
                                       w, b, sm_count(device))
        self.ty = _halo(h, len(ky), border, device)
        self.tx = _halo(w, len(kx), border, device)
        self.fields = dict(
            B=b, H=h, W=w, C=c, kx=len(kx), ky=len(ky), ax=len(kx) // 2,
            ay=len(ky) // 2, th=t.th, tw=t.tw, tiles_x=-(-w // t.tw),
            tiles_y=-(-h // t.th),
            lg_g=(t.tw // 4).bit_length() - 1,
            lg_nch=(t.th // ROWS).bit_length() - 1, sp=t.sp, vec_in=0,
            f32=int(f32_exact(kx, ky)), off_t=t.off_t, smem=t.smem, cs=c,
            c0=0)
        taps = np.zeros((3, MAX_TAPS), np.int32)
        taps[0, :len(kx)] = kx
        taps[1, :len(ky)] = ky
        taps[2] = taps[1].astype(np.float32).view(np.int32)
        self.tail = (taps,)
        self.params = {}  # vec_in -> host buffer

    def buffer(self, vec_in: bool):
        """The kernel's ConvParams for one launch."""
        buf = self.params.get(vec_in)
        if buf is None:
            buf = _buffer(_CONV_FIELDS, dict(self.fields, vec_in=int(vec_in)),
                          self.tail)
            _check_layout("zt_conv_params_bytes", buf)
            self.params[vec_in] = buf
        return buf


def run_conv(x, kx, ky, border: BorderMode):
    """Convolve the CUDA u8 ``[B, H, W, C]`` tensor ``x`` with the 8.8
    integer kernels ``kx`` (along W) and ``ky`` (along H) under ``border``,
    divClampU8 by 256^2: the result of ``separable_u8`` on their bands.
    The caller has checked the int32 bound. Kernels of more than
    ``MAX_TAPS`` taps, or too long for any conv tile's shared memory, run
    through their bands."""
    global LAUNCHES
    _check_cuda(x)
    b, h, w, c = x.shape
    kx = np.ascontiguousarray(kx, np.int32)
    ky = np.ascontiguousarray(ky, np.int32)
    border = BorderMode(border)
    full = ("conv", b, h, w, c, kx.tobytes(), ky.tobytes(), border, x.device)
    plan = _TABLES.get(full)
    if plan is None:
        plan = None if max(len(kx), len(ky)) > MAX_TAPS else \
            _conv_plan(kx, ky, border, b, h, w, c, x.device)
        _TABLES[full] = plan or "bands"
    if not isinstance(plan, _ConvPlan):
        from .convolution import _band

        return run_cached(x, ("conv", h, w, kx.tobytes(), ky.tobytes(),
                              border),
                          lambda: (_band(w, kx, border), _band(h, ky, border)))
    if b * -(-h // plan.tile.th) * -(-w // plan.tile.tw) >= 2 ** 31:
        raise ValueError("image too large for one launch grid")
    out = torch.empty_like(x)
    params = plan.buffer((w * c) % 16 == 0 and x.data_ptr() % 16 == 0)
    launch("zt_separable_conv_u8", x.device, x.data_ptr(), out.data_ptr(),
           plan.ty.data_ptr(), plan.tx.data_ptr(), params)
    with COUNT_LOCK:
        LAUNCHES += launches_for(c)
    return out


def _conv_plan(kx, ky, border, b, h, w, c, device):
    """The conv kernel's plan, or None where no tile of its fits a
    block's shared memory."""
    try:
        return _ConvPlan(kx, ky, border, b, h, w, c, device)
    except ValueError:
        return None


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
