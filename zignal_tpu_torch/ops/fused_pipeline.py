"""The north-star pipeline (bilinear u8 resize -> Gaussian u8 blur ->
optional sRGB -> Oklab) as one CUDA kernel, the counterpart of
zignal_tpu/ops/pallas_pipeline.py.

``fused_resize_blur_oklab`` checks its inputs and launches
``csrc/fused_resize_blur_oklab.cu`` on a CUDA tensor; a CPU tensor goes
to ``fused_resize_blur_oklab_reference``, the plain PyTorch composition of
the three stages. The kernel takes any H, W, OH, OW >= 1 and any C >= 1
(C other than 1, 3 and 4 in groups of at most 4 channels; the Oklab
epilogue needs C = 3), so, unlike the TPU kernel, it needs no shape gate.
The host plans each launch (``tile_plan``): the tile, the source span
each tile stages, the shared-memory layout, all cached per shape.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..color._array import _OKLMS2LAB, _RGB2OKLMS, convert_array
from ._build import COUNT_LOCK, SMEM_LIMIT, launch, load, sm_count
from .color_chain import gamma_table
from .convolution import gaussian_blur_reference
from .interpolation import _resize_bilinear_u8
from .tables import _kernel_to_int, blur_radius, gaussian_kernel, \
    halo_axis_table

__all__ = ["fused_resize_blur_oklab", "fused_resize_blur_oklab_reference",
           "tile_plan", "axis_spans"]

# kernel launches since import, read as fused_pipeline.LAUNCHES: a run
# shows with it that the main path went through the kernel (a call of C
# channels launches launches_for(C) times)
LAUNCHES = 0

# per-shape plans: (B, H, W, C, OH, OW, sigma, oklab, device) -> _Plan
_TABLES: dict = {}

# (tile columns, tile rows) in order of preference; a grid of fewer than
# MIN_BLOCKS_PER_SM blocks an SM takes the next.
TILES = ((64, 32), (32, 32), (48, 32), (32, 64), (64, 24), (32, 15),
         (16, 16), (16, 8), (8, 8))
# the plain resize (no blur, no Oklab) uses no shared memory: its tile only
# sets a block's work, and 32 x 32 measured faster than 64 x 32
PLAIN_TILES = ((32, 32), (32, 15), (16, 16), (16, 8), (8, 8))
MIN_BLOCKS_PER_SM = 4
ROWS = 8          # rows a thread of the height pass computes
MAX_TAPS = 512    # the kernel's tap table
GROUP = 4         # channels a launch computes when C is not 1, 3 or 4
_FIELDS = ("B", "H", "W", "C", "cs", "c0", "OH", "OW", "r", "k", "tw", "th",
           "tiles_x", "tiles_y", "nr", "lg_gr", "lg_pr", "lg_gw",
           "lg_nch", "lg_px", "rp", "up", "mp", "sp", "oklab", "staged",
           "vec_in", "dp4a", "off_x", "off_y", "off_lut", "smem")


def launches_for(c: int) -> int:
    """Launches of one call on ``c`` channels: 1 for C in {1, 3, 4}, else
    one a group of at most ``GROUP`` channels."""
    return 1 if c in (1, 3, 4) else -(-c // GROUP)


def _a16(n: int) -> int:
    return (n + 15) & ~15


def _lg(n: int) -> int:
    """log2 of the smallest power of two >= n."""
    return max(0, (int(n) - 1).bit_length())


def axis_spans(table: np.ndarray, tile: int, tiles: int, r: int):
    """(first, count) of the source positions each tile of one axis reads:
    tile i takes the halo entries [i * tile, i * tile + tile + 2r) of the
    ``halo_axis_table`` ``table``, and reads positions a and b of each.
    MIRROR-resolved entries at an edge fall inside the same span."""
    lo = np.minimum(table[0], table[1]).astype(np.int64)
    hi = np.maximum(table[0], table[1]).astype(np.int64)
    need = tiles * tile + 2 * r
    pad = need - lo.size
    if pad > 0:
        lo = np.concatenate([lo, np.full(pad, lo[-1])])
        hi = np.concatenate([hi, np.full(pad, hi[-1])])
    win = np.lib.stride_tricks.sliding_window_view
    first = win(lo, tile + 2 * r)[::tile][:tiles].min(axis=1)
    last = win(hi, tile + 2 * r)[::tile][:tiles].max(axis=1)
    return first, last - first + 1


class TilePlan:
    """A tile of ``tw`` x ``th`` outputs of ``c`` channels (an image of
    ``cs``) with blur radius ``r``, and the kernel's shared-memory layout:
    the tables (an int4 a halo row and column), region X (the staged
    source span of ``ny`` rows of ``nx`` pixels; then the width pass's f32
    rows, with the gamma table after them) and region Y (the resized rows,
    a plane of ``nr`` rows a channel; then the u8 tile the Oklab epilogue
    reads). The plain resize (no blur, no Oklab) uses none of it."""

    __slots__ = ("tw", "th", "staged", "nr", "nc", "rp", "up", "mp", "sp",
                 "off_x", "off_y", "off_lut", "smem", "blocks")

    def __init__(self, tw, th, r, c, cs, oklab, ny=0, nx=0):
        self.tw, self.th, self.staged = tw, th, ny > 0
        k = 2 * r + 1
        self.nr = th + 2 * r
        # resized columns: the width pass's 4-pixel groups, its taps in
        # words and the word past them (the kernel's nres)
        self.nc = 4 * -(-tw // 4) + 4 * -(-k // 4) + 4
        self.rp = self.nc  # a multiple of 4: the planes are read in words
        self.up = _a16(tw * c)
        self.mp = 4 * -(-tw // 4) * c
        self.sp = _a16(nx * cs + 16) if self.staged else 0
        self.off_lut = _a16((self.nr + ROWS) * self.mp * 4) if r else 0
        x = max(ny * self.sp, self.off_lut + (1024 if oklab else 0))
        self.off_x = 16 * (self.nr + self.nc)
        self.off_y = self.off_x + _a16(x)
        y = max(c * self.nr * self.rp if r else 0, th * self.up if oklab else 0)
        self.smem = self.off_y + _a16(y) if r or oklab else 0
        self.blocks = 0


def tile_plan(b, oh, ow, r, c, oklab, ty, tx, sms):
    """The tile of ``b`` outputs of ``oh x ow x c`` (blur radius ``r``,
    halo tables ``ty``, ``tx``) on a card of ``sms`` SMs, with the spans it
    stages: the first of ``TILES`` that fits a block's shared memory and
    gives at least ``MIN_BLOCKS_PER_SM`` blocks an SM, else the fitting one
    with the most blocks. A tile stages its source span where that fits;
    a channel group (c not in 1, 3, 4) and a span too large gather from
    global memory, and so does a plan without blur (latency-bound: the
    gather measured faster, PERF.md). Returns (plan, (first, count) rows,
    same for columns)."""
    group = c not in (1, 3, 4)
    cg = min(c, GROUP) if group else c
    best = None
    for tw, th in PLAIN_TILES if r == 0 and not oklab else TILES:
        tiles_x, tiles_y = -(-ow // tw), -(-oh // th)
        sy, sx = axis_spans(ty, th, tiles_y, r), axis_spans(tx, tw, tiles_x, r)
        plan = None
        if not group and r:
            plan = TilePlan(tw, th, r, cg, c, oklab, int(sy[1].max()),
                            int(sx[1].max()))
        if plan is None or plan.smem > SMEM_LIMIT:
            plan = TilePlan(tw, th, r, cg, c, oklab)
        if plan.smem > SMEM_LIMIT:
            continue
        plan.blocks = b * tiles_x * tiles_y
        if plan.blocks >= MIN_BLOCKS_PER_SM * sms:
            return plan, sy, sx
        if best is None or plan.blocks > best[0].blocks:
            best = plan, sy, sx
    if best is None:
        raise ValueError(f"blur radius {r} needs more shared memory than a "
                         "block has")
    return best


class _Plan:
    __slots__ = ("r", "tile", "ty", "tx", "sy", "sx", "fields", "tail",
                 "params")

    def __init__(self, b, h, w, c, oh, ow, sigma, oklab, device):
        r = blur_radius(sigma)
        kint = _kernel_to_int(gaussian_kernel(sigma)) if r else \
            np.ones(1, np.int32)
        if len(kint) > MAX_TAPS:
            raise ValueError(f"sigma {sigma} needs more than {MAX_TAPS} taps")
        ty, tx = halo_axis_table(h, oh, r), halo_axis_table(w, ow, r)
        t, sy, sx = tile_plan(b, oh, ow, r, c, oklab, ty, tx,
                              sm_count(device))
        if not t.staged and h * w * c >= 2 ** 31:
            raise ValueError("image too large for the kernel's offsets")
        self.r, self.tile = r, t
        self.ty, self.tx = (torch.from_numpy(a).to(device) for a in (ty, tx))
        self.sy, self.sx = (torch.from_numpy(np.ascontiguousarray(
            np.stack(s)).astype(np.int32)).to(device) for s in (sy, sx))
        self.fields = dict(
            B=b, H=h, W=w, C=c, cs=c, c0=0, OH=oh, OW=ow, r=r, k=len(kint),
            tw=t.tw, th=t.th, tiles_x=-(-ow // t.tw), tiles_y=-(-oh // t.th),
            nr=t.nr, lg_gr=_lg(t.nc // 4), lg_pr=_lg(t.nc),
            lg_gw=_lg(-(-t.tw // 4)), lg_nch=_lg(-(-t.th // ROWS)),
            lg_px=_lg(t.tw), rp=t.rp, up=t.up, mp=t.mp, sp=t.sp,
            oklab=int(oklab), staged=int(t.staged), vec_in=0,
            dp4a=int(r > 0 and kint.max() <= 255),
            off_x=t.off_x, off_y=t.off_y, off_lut=t.off_lut, smem=t.smem)
        taps = np.zeros(MAX_TAPS, np.int32)
        taps[:len(kint)] = kint
        # the taps as bytes, 4 a word (little-endian), for dp4a
        taps4 = np.clip(taps, 0, 255).astype(np.uint8).view(np.uint32)
        mix = np.asarray([_RGB2OKLMS, _OKLMS2LAB], np.float32).ravel()
        self.tail = (taps, taps4, mix)
        self.params = {}  # vec_in -> host buffer

    def buffer(self, vec_in: bool):
        """The kernel's K1Params for one launch, cached."""
        buf = self.params.get(vec_in)
        if buf is None:
            raw = np.array([dict(self.fields, vec_in=int(vec_in))[f]
                            for f in _FIELDS], np.int32).tobytes()
            raw += b"".join(t.tobytes() for t in self.tail)
            if load().zt_resize_params_bytes() != len(raw):
                raise RuntimeError("the kernel's K1Params layout differs "
                                   "from the wrapper's")
            buf = self.params[vec_in] = ctypes.create_string_buffer(raw,
                                                                    len(raw))
        return buf


def _plan(b, h, w, c, oh, ow, sigma, oklab, device) -> _Plan:
    key = (b, h, w, c, oh, ow, sigma, oklab, device)
    plan = _TABLES.get(key)
    if plan is None:
        plan = _TABLES[key] = _Plan(b, h, w, c, oh, ow, sigma, oklab, device)
    return plan


def _check(batch, out_rows, out_cols, sigma, oklab):
    if not isinstance(batch, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if batch.dtype != torch.uint8 or batch.ndim != 4:
        raise ValueError("expected a uint8 [B, H, W, C] tensor")
    b, h, w, c = batch.shape
    if c < 1:
        raise ValueError("channel count must be at least 1")
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
    plan = _plan(b, h, w, c, out_rows, out_cols, sigma, oklab, batch.device)
    out = torch.empty(
        (b, out_rows, out_cols, 3 if oklab else c),
        dtype=torch.float32 if oklab else torch.uint8, device=batch.device)
    params = plan.buffer(
        plan.tile.staged and (w * c) % 16 == 0 and batch.data_ptr() % 16 == 0)
    lut = gamma_table(batch.device).data_ptr() if oklab else None
    launch("zt_fused_resize_blur_oklab", batch.device, batch.data_ptr(),
           out.data_ptr(), plan.ty.data_ptr(), plan.tx.data_ptr(),
           plan.sy.data_ptr(), plan.sx.data_ptr(), lut, params)
    with COUNT_LOCK:
        LAUNCHES += launches_for(c)
    return out
