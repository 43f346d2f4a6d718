"""Point sampling at host coordinates and the geometric warps built on it:
rotate, extract, insert and warp (reference: src/image/transforms.zig,
src/image/interpolation.zig:306-430), the counterpart of
zignal_tpu/ops/warp.py.

Every coordinate is computed on the host in numpy float32 with the
expressions of the JAX package's static paths (its ``rotate``,
``extract``, ``warp_static`` and ``insert_region``), uploaded once a call
and shared by every image of a ``[..., H, W, C]`` batch. Only the gathers,
the filter weights and the blends run on the device: recomputing the
coordinates there can flip ``floor()`` at a few pixels. The JAX package's
packed-patch and tile paths are TPU gather schemes and are not ported; a
gather here is a plain index read of the same taps.

The arithmetic is the JAX package's, rounded as its compiled program
rounds it (XLA's CPU backend contracts ``x * y + z`` into fused
multiply-adds, ops/fma.py): u8 NEAREST and BILINEAR are exact integer
work, the kernel methods accumulate ``px * w`` in tap order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import BorderMode, Interpolation
from .fma import fma, fma_sum

__all__ = ["sample", "rotate", "rotate_bounds", "rotate_coords", "extract",
           "extract_coords", "insert_region", "insert_coords", "warp",
           "warp_coords"]

_F32 = np.float32


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _resolve(idx, n: int, border: BorderMode):
    """border.resolveIndex on an int64 tensor -> (index in [0, n), valid);
    a 1-px MIRROR axis resolves every index to 0."""
    if border == BorderMode.ZERO:
        return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)
    if border == BorderMode.REPLICATE:
        return idx.clamp(0, n - 1), None
    if border == BorderMode.MIRROR:
        if n == 1:
            return torch.zeros_like(idx), None
        period = 2 * (n - 1)
        m = torch.remainder(idx, period)
        return torch.where(m >= n, period - m, m), None
    if border == BorderMode.WRAP:
        return torch.remainder(idx, n), None
    raise ValueError(f"unknown border mode {border!r}")


def _and(a, b):
    if a is None:
        return b
    return a if b is None else a & b


def _gather(arr, ry, cx):
    """``arr [..., H, W, C]`` at the int64 index tensors ``ry``, ``cx`` of
    shape S -> ``[..., *S, C]``: one linear index read for the batch."""
    h, w, c = arr.shape[-3:]
    lead = arr.shape[:-3]
    flat = arr.reshape(*lead, h * w, c)
    out = flat.index_select(len(lead), (ry * w + cx).reshape(-1))
    return out.reshape(*lead, *ry.shape, c)


def _masked(x, valid):
    return x if valid is None else x * valid[..., None].to(x.dtype)


# -- the interpolation kernels ---------------------------------------------------
#
# Each takes ``mad(x, y, z) = x * y + z``: fused (ops/fma.py) where the JAX
# package's compiled program contracts it, or rounded twice where XLA
# folds the weights of constant coordinates before compiling.

def _f32(v, like):
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _rounded(x, y, z):
    return x * y + z


def _cubic_kernel_f32(t, mad=fma):
    """a=-1 bicubic (interpolation.zig:221-229). ``|t|^3`` feeds both
    pieces, so the compiled program rounds it alone and fuses the rest."""
    at = torch.abs(t)
    at3 = at * at * at
    w1 = mad(-2 * at, at, _f32(1.0, t)) + at3
    w2 = mad(5 * at, at, mad(_f32(-8.0, t), at, _f32(4.0, t))) - at3
    return torch.where(at <= 1, w1, torch.where(at <= 2, w2, 0.0))


def _catmull_kernel_f32(t, mad=fma):
    at = torch.abs(t)
    at2, at3 = at * at, at * at * at
    w1 = mad(_f32(1.5, t), at3, -2.5 * at2) + 1
    w2 = mad(_f32(-4.0, t), at, mad(_f32(-0.5, t), at3, 2.5 * at2)) + 2
    return torch.where(at <= 1, w1, torch.where(at <= 2, w2, 0.0))


def _mitchell_kernel_f32(t, mad=fma, b=1.0 / 3.0, c=1.0 / 3.0):
    """Mitchell-Netravali (B = C = 1/3); the compiled program divides by 6
    as a multiplication by f32(1/6)."""
    at = torch.abs(t)
    at2, at3 = at * at, at * at * at
    sixth = _F32(1.0 / 6.0)
    w1 = (mad(_f32(-18 + 12 * b + 6 * c, t), at2,
              (12 - 9 * b - 6 * c) * at3) + (6 - 2 * b)) * sixth
    w2 = (mad(_f32(-12 * b - 48 * c, t), at,
              mad(_f32(6 * b + 30 * c, t), at2, (-b - 6 * c) * at3))
          + (8 * b + 24 * c)) * sixth
    return torch.where(at < 1, w1, torch.where(at < 2, w2, 0.0))


def _build_lanczos3_lut() -> np.ndarray:
    """The reference's comptime 1025-entry Lanczos3 table
    (interpolation.zig:256-267) in numpy f32, as the JAX package builds
    it."""
    step = _F32(1024.0) / _F32(3.0)
    x = np.arange(1025, dtype=_F32) / step
    pi_x = _F32(np.pi) * x
    with np.errstate(invalid="ignore", divide="ignore"):
        val = (_F32(3.0) * np.sin(pi_x) * np.sin(pi_x / _F32(3.0))
               / (pi_x * pi_x))
    val = np.where(x == 0, _F32(1.0), val)
    return np.where(np.abs(x) >= 3.0, _F32(0.0), val).astype(_F32)


_LANCZOS3_LUT = _build_lanczos3_lut()
_LUTS: dict = {}


def _lanczos3_kernel_f32(t, mad=fma):
    """The table read with linear interpolation (interpolation.zig:270-281):
    per-pixel sampling in the reference reads the table rather than the
    sinc."""
    lut = _LUTS.get(t.device)
    if lut is None:
        lut = _LUTS[t.device] = torch.from_numpy(_LANCZOS3_LUT).to(t.device)
    at = torch.abs(t)
    pos = at * _F32(1024.0 / 3.0)
    idx = torch.clamp(torch.trunc(pos), 0, 1023).to(torch.int64)
    frac = pos - idx.to(torch.float32)
    val = mad(lut[idx], 1.0 - frac, lut[idx + 1] * frac)
    return torch.where(at >= 3.0, 0.0, val)


_KERNELS = {
    Interpolation.BICUBIC: (_cubic_kernel_f32, 2),
    Interpolation.CATMULL_ROM: (_catmull_kernel_f32, 2),
    Interpolation.MITCHELL: (_mitchell_kernel_f32, 2),
    Interpolation.LANCZOS: (_lanczos3_kernel_f32, 3),
}


# -- sampling ------------------------------------------------------------------

def _bilinear(arr, xs, ys, border: BorderMode):
    h, w = arr.shape[-3], arr.shape[-2]
    left = torch.floor(xs)
    top = torch.floor(ys)
    fx = xs - left
    fy = ys - top
    l_i = left.to(torch.int64)
    t_i = top.to(torch.int64)
    c0, vc0 = _resolve(l_i, w, border)
    c1, vc1 = _resolve(l_i + 1, w, border)
    r0, vr0 = _resolve(t_i, h, border)
    r1, vr1 = _resolve(t_i + 1, h, border)
    taps = [_masked(_gather(arr, r, c), _and(vr, vc))
            for r, vr in ((r0, vr0), (r1, vr1))
            for c, vc in ((c0, vc0), (c1, vc1))]
    if arr.dtype == torch.uint8:
        # 8-bit taps: every term is an integer below 2^24, so int32 is the
        # JAX package's f32 arithmetic exactly
        fxi = _round_half_away(fx * 256.0).to(torch.int32)[..., None]
        fyi = _round_half_away(fy * 256.0).to(torch.int32)[..., None]
        tl, tr, bl, br = (t.to(torch.int32) for t in taps)
        top_v = tl * (256 - fxi) + tr * fxi
        bot_v = bl * (256 - fxi) + br * fxi
        acc = top_v * (256 - fyi) + bot_v * fyi + 32768
        return torch.clamp(acc >> 16, 0, 255).to(torch.uint8)
    tl, tr, bl, br = taps
    fxv, fyv = fx[..., None], fy[..., None]
    top_v = fma(1 - fxv, tl, fxv * tr)
    bot_v = fma(1 - fxv, bl, fxv * br)
    return fma(1 - fyv, top_v, fyv * bot_v).to(arr.dtype)


def _kernel_sample(arr, xs, ys, method, border: BorderMode, folded: bool):
    """f32 weights normalised by the sum of the in-bounds weights."""
    kernel_fn, radius = _KERNELS[method]
    mad = _rounded if folded else fma
    h, w = arr.shape[-3], arr.shape[-2]
    ix = torch.floor(xs)
    iy = torch.floor(ys)
    fx = xs - ix
    fy = ys - iy
    ix_i = ix.to(torch.int64)
    iy_i = iy.to(torch.int64)
    cols = [(_resolve(ix_i + off, w, border), kernel_fn(off - fx, mad))
            for off in range(1 - radius, radius + 1)]
    taps, wsum = [], None
    for off_j in range(1 - radius, radius + 1):
        ry, vy = _resolve(iy_i + off_j, h, border)
        wy = kernel_fn(off_j - fy, mad)
        for (cx, vx), wx in cols:
            wgt = wx * wy
            valid = _and(vx, vy)
            if valid is not None:
                wgt = wgt * valid.to(torch.float32)
            taps.append((ry, cx, wgt))
            wsum = wgt if wsum is None else wsum + wgt
    # one gathered tap alive at a time
    total = fma_sum((_gather(arr, ry, cx).to(torch.float32), wgt[..., None])
                    for ry, cx, wgt in taps)
    wsum = wsum[..., None]
    # a folded sum of weights is a constant: XLA divides by it as a
    # multiplication by its reciprocal
    val = torch.where(wsum != 0, total * (1.0 / wsum) if folded
                      else total / wsum, 0.0)
    if arr.dtype == torch.uint8:
        return torch.clamp(_round_half_away(val), 0, 255).to(torch.uint8)
    return val.to(arr.dtype)


def sample(arr, xs, ys, method=Interpolation.BILINEAR,
           border: BorderMode = BorderMode.ZERO, folded: bool = False):
    """Point-sample ``arr [..., H, W, C]`` at the float32 coordinates
    ``xs``, ``ys`` (numpy arrays or tensors of one shape S, shared by every
    image of the batch) -> ``[..., *S, C]`` on ``arr``'s device; outside
    the image a ZERO border yields 0 (reference: interpolation.zig
    interpolate*). ``folded`` rounds a kernel method's weights as XLA does
    when the coordinates are constants of the JAX package's program (its
    rotate, extract and compiled insert): each operation alone, the sum of
    weights divided by as a multiplication."""
    method = Interpolation(method)
    border = BorderMode(border)
    xs = torch.as_tensor(xs).to(arr.device, torch.float32)
    ys = torch.as_tensor(ys).to(arr.device, torch.float32)
    h, w = arr.shape[-3], arr.shape[-2]
    if method == Interpolation.NEAREST:
        cx, vx = _resolve(_round_half_away(xs).to(torch.int64), w, border)
        ry, vy = _resolve(_round_half_away(ys).to(torch.int64), h, border)
        return _masked(_gather(arr, ry, cx), _and(vx, vy))
    if method == Interpolation.BILINEAR:
        return _bilinear(arr, xs, ys, border)
    return _kernel_sample(arr, xs, ys, method, border, folded)


# -- the warps -------------------------------------------------------------------

def rotate_bounds(rows: int, cols: int, angle: float):
    """Output size for auto-sized rotation (transforms.zig:112-149)."""
    tau = 2 * np.pi
    na = float(np.mod(angle, tau))
    eps = 1e-6
    if abs(na) < eps or abs(na - tau) < eps or abs(na - np.pi) < eps:
        return rows, cols
    if abs(na - np.pi / 2) < eps or abs(na - 3 * np.pi / 2) < eps:
        return cols, rows
    cos_abs = abs(float(np.cos(_F32(angle))))
    sin_abs = abs(float(np.sin(_F32(angle))))
    new_w = cols * cos_abs + rows * sin_abs
    new_h = rows * cos_abs + cols * sin_abs
    return int(np.ceil(_F32(new_h))), int(np.ceil(_F32(new_w)))


def _grid(rows: int, cols: int):
    ys, xs = np.meshgrid(np.arange(rows, dtype=_F32),
                         np.arange(cols, dtype=_F32), indexing="ij")
    return ys, xs


def rotate_coords(h: int, w: int, angle: float, out_rows: int,
                  out_cols: int):
    """The source coordinates of a rotation about the centre, numpy f32
    (transforms.zig:163-213)."""
    cx = _F32(w) / 2.0
    cy = _F32(h) / 2.0
    off_x = (_F32(out_cols) - _F32(w)) / 2.0
    off_y = (_F32(out_rows) - _F32(h)) / 2.0
    cos = _F32(np.cos(_F32(angle)))
    sin = _F32(np.sin(_F32(angle)))
    ys, xs = _grid(out_rows, out_cols)
    dx = (xs - _F32(cx + off_x)).astype(_F32)
    dy = (ys - _F32(cy + off_y)).astype(_F32)
    src_x = (cos * dx - sin * dy + cx).astype(_F32)
    src_y = (sin * dx + cos * dy + cy).astype(_F32)
    return src_x, src_y


def rotate(arr, angle: float, out_rows: int, out_cols: int,
           method=Interpolation.BILINEAR, border=BorderMode.ZERO):
    """Rotate ``[..., H, W, C]`` around the centre into an ``(out_rows,
    out_cols)`` canvas; exact quarter turns are index permutations
    (reference: transforms.zig:163-213)."""
    h, w = arr.shape[-3], arr.shape[-2]
    tau = 2 * np.pi
    na = float(np.mod(angle, tau))
    eps = 1e-6
    if abs(na) < eps or abs(na - tau) < eps:
        return arr
    if abs(na - np.pi / 2) < eps:
        return torch.rot90(arr, 1, (-3, -2))
    if abs(na - np.pi) < eps:
        return torch.flip(arr, (-3, -2))
    if abs(na - 3 * np.pi / 2) < eps:
        return torch.rot90(arr, -1, (-3, -2))
    xs, ys = rotate_coords(h, w, angle, out_rows, out_cols)
    return sample(arr, xs, ys, method, border, folded=True)


def extract_coords(rect: tuple, angle: float, out_rows: int, out_cols: int):
    """The source coordinates of a rotated rect ``(l, t, r, b)`` sampled
    into ``[out_rows, out_cols]``, numpy f32 (transforms.zig:231-283)."""
    l, t, r, b = (_F32(v) for v in rect)
    width = r - l
    height = b - t
    cx = (l + r) * _F32(0.5)
    cy = (t + b) * _F32(0.5)
    cos = _F32(np.cos(_F32(angle)))
    sin = _F32(np.sin(_F32(angle)))
    ty = (np.arange(out_rows, dtype=_F32) / _F32(out_rows - 1)
          if out_rows > 1 else np.full((1,), 0.5, _F32))
    tx = (np.arange(out_cols, dtype=_F32) / _F32(out_cols - 1)
          if out_cols > 1 else np.full((1,), 0.5, _F32))
    y_rect = (t + ty * height).astype(_F32)
    x_rect = (l + tx * width).astype(_F32)
    yg, xg = np.meshgrid(y_rect, x_rect, indexing="ij")
    dx = (xg - cx).astype(_F32)
    dy = (yg - cy).astype(_F32)
    src_x = (cx + cos * dx - sin * dy).astype(_F32)
    src_y = (cy + sin * dx + cos * dy).astype(_F32)
    return src_x, src_y


def extract(arr, rect: tuple, angle: float, out_rows: int, out_cols: int,
            method=Interpolation.BILINEAR, border=BorderMode.ZERO):
    """Sample a rotated rect ``(l, t, r, b)`` of ``[..., H, W, C]`` into
    ``[..., out_rows, out_cols, C]`` (reference: transforms.zig:231-283)."""
    xs, ys = extract_coords(rect, angle, out_rows, out_cols)
    return sample(arr, xs, ys, method, border, folded=True)


def warp_coords(matrix, out_rows: int, out_cols: int):
    """The backward-mapped coordinates of a 3x3 homogeneous transform in
    (x, y, 1) order, numpy f32 (transforms.zig:522-533; numpy never
    contracts a multiply-add)."""
    ys, xs = _grid(out_rows, out_cols)
    m = np.asarray(matrix, dtype=_F32)
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    sw = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    sw = np.where(sw == 0, _F32(1.0), sw)
    return (sx / sw).astype(_F32), (sy / sw).astype(_F32)


def warp(arr, matrix, out_rows: int, out_cols: int,
         method=Interpolation.BILINEAR):
    """Backward-map ``[..., H, W, C]`` through a 3x3 homogeneous transform
    with MIRROR sampling (reference: transforms.zig:522-533)."""
    xs, ys = warp_coords(matrix, out_rows, out_cols)
    return sample(arr, xs, ys, method, BorderMode.MIRROR)


def insert_coords(h: int, w: int, sh: int, sw: int, rect: tuple,
                  angle: float):
    """(inside mask, source x, source y) of inserting an ``sh x sw``
    source at a rotated rect of an ``h x w`` image, numpy f32 (Python
    float scalars cast to f32 first, as the JAX package does)."""
    l, t, r, b = (float(v) for v in rect)
    width = r - l
    height = b - t
    cx = (l + r) * 0.5
    cy = (t + b) * 0.5
    cos = float(np.cos(_F32(angle)))
    sin = float(np.sin(_F32(angle)))
    ys, xs = _grid(h, w)
    dx = (xs - _F32(cx)).astype(_F32)
    dy = (ys - _F32(cy)).astype(_F32)
    rect_x = (_F32(cos) * dx + _F32(sin) * dy).astype(_F32)
    rect_y = (_F32(-sin) * dx + _F32(cos) * dy).astype(_F32)
    inside = ((np.abs(rect_x) <= _F32(width * 0.5))
              & (np.abs(rect_y) <= _F32(height * 0.5)))
    norm_x = ((rect_x + _F32(width * 0.5)) / _F32(width)).astype(_F32)
    norm_y = ((rect_y + _F32(height * 0.5)) / _F32(height)).astype(_F32)
    src_x = (np.zeros_like(norm_x) if sw == 1
             else (norm_x * _F32(sw - 1)).astype(_F32))
    src_y = (np.zeros_like(norm_y) if sh == 1
             else (norm_y * _F32(sh - 1)).astype(_F32))
    return inside, src_x, src_y


def insert_region(arr, source, rect: tuple, angle: float,
                  method=Interpolation.BILINEAR, blend_mode=0,
                  compiled: bool = True):
    """Insert ``source`` into ``arr`` at a rotated rect and return the new
    tensor (reference: transforms.zig:293-380). ``arr`` is u8 ``[..., H,
    W, C]``; ``source`` u8 ``[sh, sw, C']``, shared by the batch, or
    ``[..., sh, sw, C']``, one for each image. An RGBA source blends over
    an RGB or RGBA ``arr`` with ``blend_mode``. ``compiled`` rounds as the
    JAX package's compiled ``ImageBatch.insert`` does (weights of constant
    coordinates folded, the blend's multiply-adds fused), else as its
    eager ``Image.insert`` does (a jitted sample of runtime coordinates,
    the blend one rounding an operation)."""
    from ..blending import blend_arrays

    h, w, c = arr.shape[-3:]
    sh, sw = source.shape[-3], source.shape[-2]
    inside, src_x, src_y = insert_coords(h, w, sh, sw, rect, angle)
    sampled = sample(source, src_x, src_y, method, BorderMode.MIRROR,
                     folded=compiled)
    if blend_mode and c >= 3 and source.shape[-1] == 4:
        inv255 = _F32(1.0 / 255.0) if compiled else None
        base = _to_unit(arr, inv255)
        over = _to_unit(sampled, inv255)
        if c == 3:
            base = torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)
        base, over = torch.broadcast_tensors(base, over)
        blended = blend_arrays(base, over, blend_mode, fused=compiled)[..., :c]
        if compiled:
            scaled = fma(blended, torch.full((), 255.0, device=arr.device),
                         torch.full((), 0.5, device=arr.device))
        else:
            scaled = blended * 255.0 + 0.5
        out_px = torch.clamp(torch.floor(scaled), 0, 255).to(torch.uint8)
    else:
        out_px = sampled[..., :c]
    mask = torch.from_numpy(inside).to(arr.device)[..., None]
    return torch.where(mask, out_px, arr)


def _to_unit(x, inv255):
    """u8 -> f32 in [0, 1]: times f32(1/255) as XLA compiles ``/ 255.0``,
    or divided as an eager op does (by a tensor on ``x``'s device: PyTorch
    multiplies a CUDA tensor by the reciprocal of a Python divisor)."""
    x = x.to(torch.float32)
    if inv255 is not None:
        return x * inv255
    return x / torch.full((), 255.0, device=x.device)
