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

import ctypes

import numpy as np
import torch

from ..enums import BorderMode
from ._build import COUNT_LOCK, SMEM_LIMIT, launch, load, sm_count
from .binary import dilate, erode, threshold_apply
from .convolution import gaussian_blur_reference
from .integral import sharpen, sums_fit_f32
from .tables import _kernel_to_int, blur_radius, gaussian_kernel, \
    resolve_index_np

__all__ = ["fused_blur_sharpen_morph", "fused_blur_sharpen_morph_reference"]

# kernel launches since import, read as filter_chain.LAUNCHES
LAUNCHES = 0

# per-shape plans: (B, H, W, sigma, sharpen_radius, device) -> _Plan
_TABLES: dict = {}

# the kernel's tap table and the vertical passes' rows a thread
MAX_TAPS = 512
ROWS = 8
# (log2 of the row pitch BW, output tile rows) in order of preference: the
# tile is BW - 2 (rs + 2) columns wide, rounded down to a multiple of 4.
# The kernel is compiled for pitch 64 as a constant too.
TILES = ((6, 56), (6, 24), (7, 24), (7, 56), (5, 24), (6, 8), (7, 8),
         (5, 8), (4, 8), (8, 56), (8, 24), (8, 8))
# a grid of fewer blocks than this many per SM takes the next tile
MIN_BLOCKS_PER_SM = 4
# the fields of the kernel's FilterParams ahead of thr and the taps
_FIELDS = ("B", "H", "W", "rb", "rs", "kb", "th", "tw", "tiles_x",
           "tiles_y", "lg_bw", "iws", "vec_in", "vec_out", "int_form",
           "off_a", "off_bl", "off_m0", "off_m1", "smem")


def _a16(n: int) -> int:
    return (n + 15) & ~15


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
        self.iws = _a16(self.tw + 2 * g) + 16
        self.off_a = _a16(ih * self.iws + 16)
        self.off_bl = self.off_a + 4 * (ih + ROWS) * bw
        self.off_m0 = _a16(self.off_bl + (th + 2 * h) * bw + 16)
        self.off_m1 = _a16(self.off_m0 + (th + 4) * bw + 16)
        self.smem = self.off_m1 + (th + 4) * bw + 16
        self.blocks = 0


def _tile_plan(rb: int, rs: int, h: int, w: int, b: int,
               sms: int) -> TilePlan:
    """The tile of ``B = b`` planes of ``h x w`` for blur radius ``rb``
    and sharpen radius ``rs`` on a card of ``sms`` SMs: the first of
    ``TILES`` that fits a block's shared memory and gives the grid at least
    ``MIN_BLOCKS_PER_SM`` blocks an SM, else the fitting one with the most
    blocks."""
    best = None
    for lg_bw, th in TILES:
        plan = TilePlan(lg_bw, th, rb, rs)
        if plan.tw < 4 or plan.smem > SMEM_LIMIT:
            continue
        plan.blocks = b * -(-h // plan.th) * -(-w // plan.tw)
        if plan.blocks >= MIN_BLOCKS_PER_SM * sms:
            return plan
        if best is None or plan.blocks > best.blocks:
            best = plan
    if best is None:
        raise ValueError(f"blur radius {rb} with sharpen radius {rs} needs "
                         "more shared memory than a block has")
    return best


def _taps(sigma: float) -> np.ndarray:
    """The blur's 8.8 taps; sigma 0 blurs with the one tap 256:
    (x * 256 * 256) >> 16 is x."""
    if blur_radius(sigma) == 0:
        return np.full(1, 256, np.int32)
    return _kernel_to_int(gaussian_kernel(sigma))


class _Plan:
    __slots__ = ("tile", "ty", "tx", "base", "inv_full", "params")

    def __init__(self, b, h, w, sigma, rs, device):
        kint = _taps(sigma)
        rb = len(kint) // 2
        if len(kint) > MAX_TAPS:
            raise ValueError(f"sigma {sigma} needs more than {MAX_TAPS} taps")
        g = 2 + rs + rb
        sms = sm_count(device)

        def halo(n):  # MIRROR-resolved input positions of [-g, n + g)
            pos = resolve_index_np(np.arange(-g, n + g), n, BorderMode.MIRROR)
            return torch.from_numpy(pos.astype(np.int32)).to(device)

        t = self.tile = _tile_plan(rb, rs, h, w, b, sms)
        self.ty, self.tx = halo(h), halo(w)
        fields = dict(B=b, H=h, W=w, rb=rb, rs=rs, kb=len(kint), th=t.th,
                      tw=t.tw, tiles_x=-(-w // t.tw), tiles_y=-(-h // t.th),
                      lg_bw=t.lg_bw, iws=t.iws, vec_in=0, vec_out=0,
                      int_form=int(not sums_fit_f32(h, w, rs)),
                      off_a=t.off_a, off_bl=t.off_bl,
                      off_m0=t.off_m0, off_m1=t.off_m1, smem=t.smem)
        base = np.zeros(len(_FIELDS) + 2 + MAX_TAPS, np.int32)
        base[:len(_FIELDS)] = [fields[f] for f in _FIELDS]
        base[len(_FIELDS) + 2:len(_FIELDS) + 2 + len(kint)] = kint
        self.base = base
        # the sharpen's reciprocal of a full window, correctly rounded as
        # __frcp_rn rounds it
        self.inv_full = (np.float32(1) / np.float32((2 * rs + 1) ** 2)) \
            .view(np.int32)
        self.params = {}  # (thr, vec_in, vec_out) -> host buffer


def _plan(b, h, w, sigma, rs, device) -> _Plan:
    key = (b, h, w, sigma, rs, device)
    plan = _TABLES.get(key)
    if plan is None:
        plan = _TABLES[key] = _Plan(b, h, w, sigma, rs, device)
    return plan


def _params(plan: _Plan, thr: float, vec_in: bool, vec_out: bool):
    """The kernel's FilterParams for one launch, as a host buffer the
    launch copies by value; cached on the plan."""
    key = (thr, vec_in, vec_out)
    buf = plan.params.get(key)
    if buf is None:
        if len(plan.params) >= 64:  # a sweep over thresholds
            plan.params.clear()
        raw = plan.base.copy()
        raw[_FIELDS.index("vec_in")] = vec_in
        raw[_FIELDS.index("vec_out")] = vec_out
        raw[len(_FIELDS)] = np.float32(thr).view(np.int32)
        raw[len(_FIELDS) + 1] = plan.inv_full
        if load().zt_filter_params_bytes() != raw.nbytes:
            raise RuntimeError("the kernel's FilterParams layout differs "
                               "from the wrapper's")
        buf = plan.params[key] = ctypes.create_string_buffer(raw.tobytes(),
                                                             raw.nbytes)
    return buf


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
    plan = _plan(b, h, w, sigma, rs, x.device)
    if b * -(-h // plan.tile.th) * -(-w // plan.tile.tw) >= 2 ** 31:
        raise ValueError("batch or plane too large for one launch grid")
    out = torch.empty_like(planes)
    params = _params(plan, thr,
                     w % 16 == 0 and planes.data_ptr() % 16 == 0,
                     w % 4 == 0 and out.data_ptr() % 4 == 0)
    launch("zt_fused_blur_sharpen_morph", x.device, planes.data_ptr(),
           out.data_ptr(), plan.ty.data_ptr(), plan.tx.data_ptr(), params)
    with COUNT_LOCK:
        LAUNCHES += 1
    return out.view(x.shape)
