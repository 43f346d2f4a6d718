"""The config-3 filter chain (Gaussian blur -> sharpen -> threshold ->
3x3 dilate -> 3x3 erode) as one CUDA kernel, the counterpart of
zignal_tpu/ops/pallas_filter.py.

``fused_blur_sharpen_morph`` checks its inputs and launches
``csrc/fused_blur_sharpen_morph.cu`` on a CUDA tensor; a CPU tensor goes to
``fused_blur_sharpen_morph_reference``, the plain PyTorch composition of
the stages exactly as the JAX package's ``_filter_chain_xla``
(zignal_tpu/pipeline.py:95-104) composes them. The kernel takes any
H, W >= 1, so, unlike the TPU kernel, it needs no shape gate.

The plan picks one of the file's two kernels from the shape and the
filter: the streamed kernel (warps walking down column strips, its plan
``_stream_plan``) where its blur and sharpen windows fit its registers
and its segments are more than their warm-up rows, else the tile kernel
(one block a tile, ``_tile_plan``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode
from ..profiling import RECORDER, span_start
from ._build import COUNT_LOCK, ROWS, Plan, a16, cached, choose_tile, \
    launch, pack, sm_count
from .binary import dilate, erode, threshold_apply
from .convolution import gaussian_blur_reference
from .integral import sharpen, sums_fit_f32
from .tables import _kernel_to_int, blur_radius, gaussian_kernel, \
    halo_positions

__all__ = ["fused_blur_sharpen_morph", "fused_blur_sharpen_morph_reference"]

# kernel launches since import, read as filter_chain.LAUNCHES; STREAMED
# counts those that took the streamed kernel
LAUNCHES = 0
STREAMED = 0

MAX_TAPS = 512  # the kernel's tap table
# (log2 of the row pitch BW, output tile rows) in order of preference
# (_build.choose_tile): the tile is BW - 2 (rs + 2) columns wide, rounded
# down to a multiple of 4. The kernel is compiled for pitch 64 as a
# constant too.
TILES = ((6, 56), (6, 24), (7, 24), (7, 56), (5, 24), (6, 8), (7, 8),
         (5, 8), (4, 8), (8, 56), (8, 24), (8, 8))
# The streamed kernel: a warp computes STRIP blurred columns of a column
# strip, 4 a lane, down a segment of rows. It is compiled for the tap
# counts STREAM_TAPS (a shorter blur is padded with zero taps to the next)
# and sharpen radii up to STREAM_MAX_RS; it multiplies four taps at once as
# bytes (each <= 255: sigma 0's one tap of 256 is not) and keeps two
# columns of the width pass a word (the taps sum to at most 257, 255 * 257
# < 2^16).
STRIP = 128
STREAM_TAPS = (7, 13)
STREAM_MAX_RS = 3
# A warp is a block, and an SM holds RESIDENT_WARPS of them (the kernel's
# launch bounds; 8.6 KB of shared memory a warp). The plan cuts a strip into
# as many segments as one wave of resident warps holds, since more warps an
# SM hide more latency, but none shorter than MIN_SEG_ROWS: a segment
# starts with 2 g warm-up rows, which a shorter one no longer pays for.
RESIDENT_WARPS = 16
MIN_SEG_ROWS = 9
# Where a segment's 2 g warm-up rows (g = 2 + r + taps // 2) outnumber its
# output rows more than MAX_WARMUP times, the tile kernel was as fast or
# faster on the H100 (at B=1 of 1024^2, 9-row segments: r 3 with 13 taps,
# 22 warm-up rows, ran 18.9 us streamed against 18.0-18.9 tiled; r 2, 20
# rows, 15.7 against 17.2), so the plan leaves those to the tile kernel.
MAX_WARMUP = 9 / 4
# the fields of the kernel's FilterParams ahead of thr and the taps
_FIELDS = ("B", "H", "W", "rb", "rs", "kb", "th", "tw", "tiles_x",
           "tiles_y", "lg_bw", "iws", "vec_in", "vec_out", "int_form",
           "off_a", "off_bl", "off_m0", "off_m1", "smem", "stream", "skb",
           "h4", "sw", "strips", "seg", "segs")
_STAPS = 16  # the kernel's kStreamTaps


class TilePlan:
    """A tile of ``th`` x ``tw`` outputs with intermediate rows of pitch
    ``2**lg_bw`` and the byte offsets of fused_blur_sharpen_morph.cu's
    shared-memory regions: input rows (pitch ``iws``), the blur width pass
    and then the box width sums (int32), the blurred plane (u8) and two
    mask buffers (u8)."""

    __slots__ = ("th", "tw", "lg_bw", "iws", "off_a", "off_bl", "off_m0",
                 "off_m1", "smem", "blocks")

    def __init__(self, lg_bw: int, th: int, rb: int, rs: int):
        bw = 1 << lg_bw
        h = rs + 2
        g = h + rb
        self.lg_bw, self.th = lg_bw, th
        self.tw = (bw - 2 * h) & ~3
        ih = th + 2 * g
        self.iws = a16(self.tw + 2 * g) + 16
        self.off_a = a16(ih * self.iws + 16)
        self.off_bl = self.off_a + 4 * (ih + ROWS) * bw
        self.off_m0 = a16(self.off_bl + (th + 2 * h) * bw + 16)
        self.off_m1 = a16(self.off_m0 + (th + 4) * bw + 16)
        self.smem = self.off_m1 + (th + 4) * bw + 16
        self.blocks = 0


def _tile_plan(rb: int, rs: int, h: int, w: int, b: int,
               sms: int) -> TilePlan:
    """The tile of ``B = b`` planes of ``h x w`` for blur radius ``rb``
    and sharpen radius ``rs`` on a card of ``sms`` SMs:
    ``_build.choose_tile`` over ``TILES``, of at least 4 columns."""
    def make(tile):
        plan = TilePlan(*tile, rb, rs)
        return plan if plan.tw >= 4 else None

    return choose_tile(TILES, make, b, h, w, sms,
                       f"blur radius {rb} with sharpen radius {rs} needs")


class StreamPlan:
    """The streamed kernel's plan: ``kb`` taps (the blur's, padded with
    zeros), strips of ``sw`` output columns after ``h4`` blurred ones, and
    ``segs`` segments of ``seg`` output rows a strip; one warp (a block) a
    segment of a strip of a plane, ``warps`` in all."""

    __slots__ = ("kb", "h4", "sw", "strips", "seg", "segs", "warps")

    def __init__(self, kb, h4, strips, seg, segs, b):
        self.kb, self.h4, self.sw = kb, h4, STRIP - 2 * h4
        self.strips, self.seg, self.segs = strips, seg, segs
        self.warps = b * strips * segs


def _stream_plan(kint, rs: int, h: int, w: int, b: int,
                 sms: int) -> StreamPlan | None:
    """The streamed plan for the 8.8 taps ``kint`` and sharpen radius
    ``rs`` on ``B = b`` planes of ``h x w`` on a card of ``sms`` SMs, or
    None where the kernel does not take the filter. It computes the
    sharpen's f32 form only: the int form (which JAX's bound rule takes
    only past r = 3) stays on the tile kernel."""
    kb = next((k for k in STREAM_TAPS if k >= len(kint)), None)
    if kb is None or rs > STREAM_MAX_RS or int(np.max(kint)) > 255 \
            or int(np.sum(kint)) > 257 or not sums_fit_f32(h, w, rs):
        return None
    h4 = (rs + 5) & ~3
    strips = -(-w // (STRIP - 2 * h4))
    segs = max(1, RESIDENT_WARPS * sms // (b * strips))
    seg = max(-(-h // segs), min(MIN_SEG_ROWS, h))
    segs = -(-h // seg)
    if 2 * (2 + rs + kb // 2) > MAX_WARMUP * seg or \
            b * strips * segs >= 2 ** 31:
        return None
    return StreamPlan(kb, h4, strips, seg, segs, b)


def _taps(sigma: float) -> np.ndarray:
    """The blur's 8.8 taps; sigma 0 blurs with the one tap 256:
    (x * 256 * 256) >> 16 is x."""
    if blur_radius(sigma) == 0:
        return np.full(1, 256, np.int32)
    return _kernel_to_int(gaussian_kernel(sigma))


class _Plan(Plan):
    """Both kernels' plans for one shape: ``stream`` (None where the
    streamed kernel does not take the filter) is launched when there is
    one, with its halo tables ``sty``/``stx``; ``tile``, ``ty``/``tx``
    otherwise. ``buffer(thr, vec_in, vec_out)`` is a launch's
    FilterParams."""

    __slots__ = ("tile", "ty", "tx", "stream", "sty", "stx", "inv_full")
    FIELDS, LAYOUT = _FIELDS, "zt_filter_params_bytes"

    def __init__(self, b, h, w, sigma, rs, device):
        kint = _taps(sigma)
        rb = len(kint) // 2
        if len(kint) > MAX_TAPS:
            raise ValueError(f"sigma {sigma} needs more than {MAX_TAPS} taps")
        sms = sm_count(device)

        def halo(n, g=2 + rs + rb):  # MIRROR positions of [-g, n + g)
            return halo_positions(n, 2 * g + 1, BorderMode.MIRROR, device)

        t = self.tile = _tile_plan(rb, rs, h, w, b, sms)
        self.ty, self.tx = halo(h), halo(w)
        st = self.stream = _stream_plan(kint, rs, h, w, b, sms)
        self.sty, self.stx = self.ty, self.tx
        if st is not None and st.kb != len(kint):
            sg = 2 + rs + st.kb // 2  # the padded blur's halo
            self.sty, self.stx = halo(h, sg), halo(w, sg)
        fields = dict(B=b, H=h, W=w, rb=rb, rs=rs, kb=len(kint), th=t.th,
                      tw=t.tw, tiles_x=-(-w // t.tw), tiles_y=-(-h // t.th),
                      lg_bw=t.lg_bw, iws=t.iws, vec_in=0, vec_out=0,
                      int_form=int(not sums_fit_f32(h, w, rs)),
                      off_a=t.off_a, off_bl=t.off_bl,
                      off_m0=t.off_m0, off_m1=t.off_m1, smem=t.smem,
                      stream=int(st is not None), skb=0, h4=0, sw=0,
                      strips=0, seg=0, segs=0)
        # the blur's taps, then the streamed kernel's, centred among zeros
        taps = np.zeros(MAX_TAPS + _STAPS, np.int32)
        taps[:len(kint)] = kint
        if st is not None:
            fields.update(skb=st.kb, h4=st.h4, sw=st.sw, strips=st.strips,
                          seg=st.seg, segs=st.segs)
            at = MAX_TAPS + (st.kb - len(kint)) // 2
            taps[at:at + len(kint)] = kint
        # the sharpen's reciprocal of a full window, correctly rounded as
        # __frcp_rn rounds it
        self.inv_full = np.float32(1) / np.float32((2 * rs + 1) ** 2)
        super().__init__(fields, (taps,))

    def pack(self, thr, vec_in, vec_out):
        """A launch's FilterParams: the fields, thr and the reciprocal as
        f32, then the taps."""
        return pack(_FIELDS, dict(self.fields, vec_in=int(vec_in),
                                  vec_out=int(vec_out)),
                    (np.float32([thr, self.inv_full]), *self.tail))


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
    runs the plain version. During a profiler session the kernel's route
    adds the recorder's spans ``K2.check``, ``K2.plan``, ``K2.alloc`` and
    ``K2.params``, one after the other."""
    global LAUNCHES, STREAMED
    t0 = span_start()
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
    t0 = t0 and RECORDER.add("K2.check", t0)
    plan = cached(_Plan, b, h, w, sigma, rs, x.device, span="K2.plan_build")
    stream = plan.stream
    if stream is None and plan.tile.blocks >= 2 ** 31:
        raise ValueError("batch or plane too large for one launch grid")
    t0 = t0 and RECORDER.add("K2.plan", t0)
    out = torch.empty_like(planes)
    t0 = t0 and RECORDER.add("K2.alloc", t0)
    params = plan.buffer(thr, w % 16 == 0 and planes.data_ptr() % 16 == 0,
                         w % 4 == 0 and out.data_ptr() % 4 == 0)
    if t0:
        RECORDER.add("K2.params", t0)
    ty, tx = (plan.ty, plan.tx) if stream is None else (plan.sty, plan.stx)
    launch("zt_fused_blur_sharpen_morph", x.device, planes.data_ptr(),
           out.data_ptr(), ty.data_ptr(), tx.data_ptr(), params)
    with COUNT_LOCK:
        LAUNCHES += 1
        STREAMED += stream is not None
    return out.view(x.shape)
