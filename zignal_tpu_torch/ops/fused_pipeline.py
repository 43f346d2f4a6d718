"""The north-star pipeline (bilinear u8 resize -> Gaussian u8 blur ->
optional sRGB -> Oklab) as one CUDA kernel, the counterpart of
zignal_tpu/ops/pallas_pipeline.py.

``fused_resize_blur_oklab`` checks its inputs and launches
``csrc/fused_resize_blur_oklab.cu`` on a CUDA tensor; a CPU tensor goes
to ``fused_resize_blur_oklab_reference``, the plain PyTorch composition of
the three stages. The kernel takes any H, W, OH, OW >= 1 and any C >= 1
(C other than 1, 3 and 4 in groups of at most 4 channels; the Oklab
epilogue needs C = 3), so, unlike the TPU kernel, it needs no shape gate.
The host plans each launch, cached per shape. The plan picks one of the
file's two kernels from the shape, the channels and the taps: the streamed
kernel (blocks walking down column strips, its plan ``_stream_plan``) for
RGB with 7, 11 or 13 taps where a band's source rows stage and its grid
is not too small for its blocks' floor, else the tile kernel (``tile_plan``:
the tile, the source span each tile stages, the shared-memory layout).
"""

from __future__ import annotations

import numpy as np
import torch

from ..color._array import _OKLMS2LAB, _RGB2OKLMS, convert_array
from ..profiling import RECORDER, span_start
from ._build import COUNT_LOCK, ROWS, SMEM_LIMIT, Plan, a16, cached, \
    choose_tile, launch, sm_count
from .convolution import gaussian_blur_reference
from .interpolation import _resize_bilinear_u8
from .tables import _kernel_to_int, blur_radius, gamma_table, \
    gaussian_kernel, halo_axis_table

__all__ = ["fused_resize_blur_oklab", "fused_resize_blur_oklab_reference",
           "tile_plan", "axis_spans"]

# kernel launches since import, read as fused_pipeline.LAUNCHES: a run
# shows with it that the main path went through the kernel (a call of C
# channels launches launches_for(C) times); STREAMED counts those that took
# the streamed kernel
LAUNCHES = 0
STREAMED = 0

# (tile columns, tile rows) in order of preference (_build.choose_tile)
TILES = ((64, 32), (32, 32), (48, 32), (32, 64), (64, 24), (32, 15),
         (16, 16), (16, 8), (8, 8))
# the plain resize (no blur, no Oklab) uses no shared memory: its tile only
# sets a block's work, and 32 x 32 measured faster than 64 x 32
PLAIN_TILES = ((32, 32), (32, 15), (16, 16), (16, 8), (8, 8))
MAX_TAPS = 512    # the kernel's tap table
GROUP = 4         # channels a launch computes when C is not 1, 3 or 4
_FIELDS = ("B", "H", "W", "C", "cs", "c0", "OH", "OW", "r", "k", "tw", "th",
           "tiles_x", "tiles_y", "nr", "lg_gr", "lg_pr", "lg_gw",
           "lg_nch", "lg_px", "rp", "up", "mp", "sp", "oklab", "staged",
           "vec_in", "dp4a", "off_x", "off_y", "off_lut", "smem")
# The streamed kernel: a block computes STRIP output columns of one RGB
# image down a segment of its rows, BAND halo rows a band, for the tap
# counts STREAM_TAPS, each tap a byte (<= 255) for dp4a. STREAM_BLOCKS
# blocks fit an SM (its launch bounds), so a block may use STREAM_SMEM bytes
# of shared memory: STREAM_FIXED of rings, planes and tables, then
# STREAM_STAGES stages of a band's source rows (of at most MAX_STAGE_PITCH
# bytes), which a downscale past ~2.5:1 outgrows. The grid is one wave of
# resident blocks, cut into segments of a multiple of BAND rows. STRIP,
# BAND, STREAM_FIXED and MAX_STAGE_PITCH copy the kernel's kStrip, kBand,
# kOffStages and kMaxStagePitch: its launch refuses a struct whose strips,
# segment rows or stage pitch disagree with them, or whose shared memory
# falls short of its layout.
STRIP = 64
BAND = 8
STREAM_TAPS = (7, 11, 13)
STREAM_BLOCKS = 4
STREAM_STAGES = 2
STREAM_FIXED = 29968
STREAM_SMEM = 233472 // STREAM_BLOCKS - 1024
MAX_STAGE_PITCH = 4096
# A block walks one segment of at least BAND rows and its 2r warm-up rows
# band after band, so the streamed kernel's time has a floor: on the H100
# (sigma 2, Oklab, device time) 6.7-6.8 us at every grid under a wave,
# where the tile kernel spreads a small output over more, smaller blocks.
# The tile kernel won at a streamed grid of 32 blocks (B=1 of 256^2 ->
# 128^2: 4.5 us), 64 (B=2 of it: 5.7) and 72 (B=1 of 384^2 -> 192^2:
# 6.3); the streamed kernel from 96 (B=3 of 256^2: 6.8 against 7.3; B=1
# of 448^2 -> 224^2: 6.8 against 7.2) at every larger grid, 8-row
# segments for 12 warm-up rows included (B=1 of 1024^2 -> 512^2: 11.2
# against 11.8, B=16 of 256^2: 11.1 against 12.0), and at the north
# star's B=16 of 1024^2 70.4-70.5 against 93.8. So the plan leaves a grid
# of fewer than MIN_GRID blocks an SM (88 on 132) to the tile kernel.
MIN_GRID = 2 / 3
# the fields of the kernel's K1StreamParams ahead of the taps and mixes
_SFIELDS = ("B", "H", "W", "OH", "OW", "r", "k", "strips", "seg", "segs",
            "nbt", "ns", "sp", "oklab", "vec_in", "smem")


def launches_for(c: int) -> int:
    """Launches of one call on ``c`` channels: 1 for C in {1, 3, 4}, else
    one a group of at most ``GROUP`` channels."""
    return 1 if c in (1, 3, 4) else -(-c // GROUP)


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
    reads). The plain resize (no blur, no Oklab) uses none of it. ``sy``
    and ``sx`` are the spans of ``axis_spans`` its tiles read."""

    __slots__ = ("tw", "th", "staged", "nr", "nc", "rp", "up", "mp", "sp",
                 "off_x", "off_y", "off_lut", "smem", "blocks", "sy", "sx")

    def __init__(self, tw, th, r, c, cs, oklab, ny=0, nx=0):
        self.tw, self.th, self.staged = tw, th, ny > 0
        k = 2 * r + 1
        self.nr = th + 2 * r
        # resized columns: the width pass's 4-pixel groups, its taps in
        # words and the word past them (the kernel's nres)
        self.nc = 4 * -(-tw // 4) + 4 * -(-k // 4) + 4
        self.rp = self.nc  # a multiple of 4: the planes are read in words
        self.up = a16(tw * c)
        self.mp = 4 * -(-tw // 4) * c
        self.sp = a16(nx * cs + 16) if self.staged else 0
        self.off_lut = a16((self.nr + ROWS) * self.mp * 4) if r else 0
        x = max(ny * self.sp, self.off_lut + (1024 if oklab else 0))
        self.off_x = 16 * (self.nr + self.nc)
        self.off_y = self.off_x + a16(x)
        y = max(c * self.nr * self.rp if r else 0, th * self.up if oklab else 0)
        self.smem = self.off_y + a16(y) if r or oklab else 0
        self.blocks = 0


def tile_plan(b, oh, ow, r, c, oklab, ty, tx, sms):
    """The tile of ``b`` outputs of ``oh x ow x c`` (blur radius ``r``,
    halo tables ``ty``, ``tx``) on a card of ``sms`` SMs, with the spans it
    stages: ``_build.choose_tile`` over ``TILES``. A tile stages its
    source span where that fits; a channel group (c not in 1, 3, 4) and a
    span too large gather from global memory, and so does a plan without
    blur (latency-bound: the gather measured faster, PERF.md). Returns
    (plan, (first, count) rows, same for columns)."""
    group = c not in (1, 3, 4)
    cg = min(c, GROUP) if group else c

    def make(tile):
        tw, th = tile
        sy = axis_spans(ty, th, -(-oh // th), r)
        sx = axis_spans(tx, tw, -(-ow // tw), r)
        plan = None
        if not group and r:
            plan = TilePlan(tw, th, r, cg, c, oklab, int(sy[1].max()),
                            int(sx[1].max()))
        if plan is None or plan.smem > SMEM_LIMIT:
            plan = TilePlan(tw, th, r, cg, c, oklab)
        plan.sy, plan.sx = sy, sx
        return plan

    plan = choose_tile(PLAIN_TILES if r == 0 and not oklab else TILES, make,
                       b, oh, ow, sms, f"blur radius {r} needs")
    return plan, plan.sy, plan.sx


class StreamPlan(Plan):
    """The streamed kernel's plan: ``strips`` strips of ``STRIP`` output
    columns, ``segs`` segments of ``seg`` output rows a strip, one block a
    segment of a strip of an image (``blocks``); its span tables ``by``
    ((first source row, count) of each band of ``BAND`` halo rows; ``ns``
    rows at most) and ``bx`` (the same for the columns of each strip), and
    its K1StreamParams (``buffer(vec_in)``)."""

    __slots__ = ("strips", "seg", "segs", "ns", "blocks", "by", "bx")
    FIELDS, LAYOUT = _SFIELDS, "zt_resize_stream_params_bytes"


def _stream_plan(kint, b, h, w, c, oh, ow, oklab, ty, tx, sms):
    """The streamed plan for ``b`` images of ``h x w x c`` resized to ``oh
    x ow`` and blurred with the 8.8 taps ``kint`` (halo tables ``ty``,
    ``tx``) on a card of ``sms`` SMs, or None where the tile kernel keeps
    the shape: C other than 3, no blur, a tap count not in STREAM_TAPS or a
    tap above 255, source spans too large to stage (strong downscales), or
    a grid of fewer than MIN_GRID blocks an SM (small outputs)."""
    k = len(kint)
    if c != 3 or k not in STREAM_TAPS or int(np.max(kint)) > 255:
        return None
    r = k // 2
    strips = -(-ow // STRIP)
    segs = max(1, STREAM_BLOCKS * sms // (b * strips))
    seg = BAND * -(-oh // (BAND * segs))
    segs = -(-oh // seg)
    if not MIN_GRID * sms <= b * strips * segs < 2 ** 31:
        return None
    nbt = -(-(oh + 2 * r) // BAND)
    by = axis_spans(ty, BAND, nbt, 0)
    bx = axis_spans(tx, STRIP, strips, r)
    ns, sp = int(by[1].max()), a16(3 * int(bx[1].max()) + 16)
    smem = STREAM_FIXED + STREAM_STAGES * ns * sp
    if smem > STREAM_SMEM or sp > MAX_STAGE_PITCH:
        return None
    fields = dict(B=b, H=h, W=w, OH=oh, OW=ow, r=r, k=k, strips=strips,
                  seg=seg, segs=segs, nbt=nbt, ns=ns, sp=sp,
                  oklab=int(oklab), vec_in=0, smem=smem)
    # the taps as bytes shifted 0-3 bytes later (dp4a of an output's words),
    # then as f32
    shifted = np.zeros((4, 16), np.uint8)
    for q in range(4):
        shifted[q, q:q + k] = kint
    taps = np.zeros(16, np.float32)
    taps[:k] = kint
    mix = np.asarray([_RGB2OKLMS, _OKLMS2LAB], np.float32).ravel()
    st = StreamPlan(fields, (shifted.view(np.uint32), taps, mix))
    st.strips, st.seg, st.segs, st.ns = strips, seg, segs, ns
    st.blocks = b * strips * segs
    st.by, st.bx = (np.ascontiguousarray(np.stack(s)).astype(np.int32)
                    for s in (by, bx))
    return st


class _Plan(Plan):
    """The kernels' plans for one shape: ``stream``, the streamed kernel's,
    where it takes the shape; else the tile's (``tile``, its span tables
    ``sy``/``sx``, its K1Params as ``buffer(vec_in)``), which is built only
    then. Both kernels read the halo tables ``ty``/``tx``."""

    __slots__ = ("r", "tile", "ty", "tx", "sy", "sx", "stream")
    FIELDS, LAYOUT = _FIELDS, "zt_resize_params_bytes"

    def __init__(self, b, h, w, c, oh, ow, sigma, oklab, device):
        r = blur_radius(sigma)
        kint = _kernel_to_int(gaussian_kernel(sigma)) if r else \
            np.ones(1, np.int32)
        if len(kint) > MAX_TAPS:
            raise ValueError(f"sigma {sigma} needs more than {MAX_TAPS} taps")
        ty, tx = halo_axis_table(h, oh, r), halo_axis_table(w, ow, r)
        sms = sm_count(device)
        self.r = r
        self.ty, self.tx = (torch.from_numpy(a).to(device) for a in (ty, tx))
        st = self.stream = _stream_plan(kint, b, h, w, c, oh, ow, oklab, ty,
                                        tx, sms)
        if st is not None:
            st.by, st.bx = (torch.from_numpy(a).to(device)
                            for a in (st.by, st.bx))
            self.tile = self.sy = self.sx = None
            super().__init__(None, None)  # no K1Params: st.buffer is used
            return
        t, sy, sx = tile_plan(b, oh, ow, r, c, oklab, ty, tx, sms)
        if not t.staged and h * w * c >= 2 ** 31:
            raise ValueError("image too large for the kernel's offsets")
        self.tile = t
        self.sy, self.sx = (torch.from_numpy(np.ascontiguousarray(
            np.stack(s)).astype(np.int32)).to(device) for s in (sy, sx))
        fields = dict(
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
        super().__init__(fields, (taps, taps4, mix))


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
    ``oklab``. ``sigma=0`` skips the blur. A CUDA tensor runs one of the
    kernels (or raises); a CPU tensor runs the plain version. During a
    profiler session the kernel's route adds the recorder's spans
    ``K1.check``, ``K1.plan``, ``K1.alloc`` and ``K1.params``, one after
    the other."""
    global LAUNCHES, STREAMED
    t0 = span_start()
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
    t0 = t0 and RECORDER.add("K1.check", t0)
    plan = cached(_Plan, b, h, w, c, out_rows, out_cols, sigma, oklab,
                  batch.device, span="K1.plan_build")
    t0 = t0 and RECORDER.add("K1.plan", t0)
    out = torch.empty(
        (b, out_rows, out_cols, 3 if oklab else c),
        dtype=torch.float32 if oklab else torch.uint8, device=batch.device)
    t0 = t0 and RECORDER.add("K1.alloc", t0)
    vec = (w * c) % 16 == 0 and batch.data_ptr() % 16 == 0
    st = plan.stream
    if st is None:
        name, spans = "zt_fused_resize_blur_oklab", (plan.sy, plan.sx)
        params = plan.buffer(plan.tile.staged and vec)
    else:
        name, spans = "zt_streamed_resize_blur_oklab", (st.by, st.bx)
        params = st.buffer(vec)
    lut = cached(gamma_table, batch.device).data_ptr() if oklab else None
    if t0:
        RECORDER.add("K1.params", t0)
    launch(name, batch.device, batch.data_ptr(), out.data_ptr(),
           plan.ty.data_ptr(), plan.tx.data_ptr(), spans[0].data_ptr(),
           spans[1].data_ptr(), lut, params)
    with COUNT_LOCK:
        LAUNCHES += launches_for(c)
        STREAMED += st is not None
    return out
