"""Host-side numpy tables: resize coordinates, Gaussian taps, border
resolution, clamped windows and banded matrices.

The table functions below are copied op for op from the JAX package, so both
packages derive every integer tap from the same float32 arithmetic:

- ``resolve_index_np``, ``_axis_coords``, the cubic-family kernels
  (``_cubic_kernel_i32``, ``_catmull_kernel_i32``, ``_mitchell_kernel_i32``,
  ``_trunc_div_np``), ``_lanczos_kernel_f32``, ``cubic_axis_table``,
  ``lanczos_axis_table`` and ``nearest_indices``:
  zignal_tpu/ops/interpolation.py
- ``build_tap_matrix``: zignal_tpu/ops/mxu_resample.py
- ``_kernel_to_int`` and ``gaussian_kernel``: zignal_tpu/ops/convolution.py
- ``border_tap_table``: ``_axis_taps`` of zignal_tpu/ops/convolution.py,
  with -1 kept for ZERO-border taps instead of a separate mask
- ``window_bounds`` and ``clamped_band``: ``_window_bounds`` and
  ``_clamped_band`` of zignal_tpu/ops/integral.py
- ``extents``: ``_extents`` of zignal_tpu/ops/pallas_filter.py

Coordinates stay numpy float32 on the host: recomputing them on a device
can flip ``floor()`` at a few pixels.
"""

from __future__ import annotations

import numpy as np

from ..enums import BorderMode, Interpolation

__all__ = [
    "SCALE", "resolve_index_np", "build_tap_matrix", "gaussian_kernel",
    "blur_radius", "bilinear_axis_table", "halo_axis_table",
    "border_tap_table", "window_bounds", "extents", "clamped_band",
    "band_to_taps", "tile_sources", "nearest_indices", "cubic_axis_table",
    "lanczos_axis_table", "CUBIC_KERNELS",
]

SCALE = 256  # 8.8 fixed point, for both the resize and the blur taps


def resolve_index_np(idx, length, mode=BorderMode.MIRROR):
    """Vectorized reference border.resolveIndex (border.zig:46-67).

    Returns resolved indices; positions mapping to zero (ZERO mode OOB)
    are returned as -1 (caller must mask).
    """
    idx = np.asarray(idx, dtype=np.int64)
    inside = (idx >= 0) & (idx < length)
    if mode == BorderMode.ZERO:
        return np.where(inside, idx, -1)
    if mode == BorderMode.REPLICATE:
        return np.clip(idx, 0, length - 1)
    if mode == BorderMode.MIRROR:
        if length == 1:
            return np.zeros_like(idx)
        period = 2 * (length - 1)
        m = np.mod(idx, period)  # numpy mod is already non-negative
        return np.where(m >= length, period - m, m)
    if mode == BorderMode.WRAP:
        return np.mod(idx, length)
    raise ValueError(f"unknown border mode {mode!r}")


def _axis_coords(src_n: int, dst_n: int):
    """Reference f32 coordinate math: (dst+0.5)*ratio-0.5, floor + frac."""
    f32 = np.float32
    ratio = f32(src_n) / f32(dst_n)
    dst = np.arange(dst_n, dtype=f32)
    src_f = (dst + f32(0.5)) * ratio - f32(0.5)
    i0 = np.floor(src_f).astype(np.int64)
    frac = src_f - np.floor(src_f)  # f32 in [0,1)
    return src_f, i0, frac


def nearest_indices(src_n: int, dst_n: int) -> np.ndarray:
    """Nearest-neighbour source index of each output position, int64
    ``[dst_n]``: ``floor(src + 0.5)`` in f32 (Zig @round, half away from
    zero, on coordinates > -0.5), clipped to the axis."""
    src, _, _ = _axis_coords(src_n, dst_n)
    return np.clip(np.floor(src + np.float32(0.5)), 0,
                   src_n - 1).astype(np.int64)


def _trunc_div_np(a, b):
    return (np.sign(a) * (np.abs(a) // np.abs(b))).astype(np.int64)


def _cubic_kernel_i32(t):
    """Bicubic a=-0.5 kernel in 8.8 fixed point (channel_ops.zig:228-244)."""
    at = np.abs(t).astype(np.int64)
    t2 = (at * at) // SCALE
    t3 = (t2 * at) // SCALE
    w_near = SCALE - 2 * t2 + t3
    w_far = 4 * SCALE - 8 * at + 5 * t2 - t3
    return np.where(at <= SCALE, w_near, np.where(at <= 2 * SCALE, w_far, 0))


def _catmull_kernel_i32(t):
    """Catmull-Rom kernel in 8.8 fixed point (channel_ops.zig:304-320)."""
    at = np.abs(t).astype(np.int64)
    t2 = (at * at) // SCALE
    t3 = (t2 * at) // SCALE
    w_near = SCALE - (5 * t2) // 2 + (3 * t3) // 2
    w_far = 2 * SCALE - 4 * at + (5 * t2) // 2 - _trunc_div_np(t3, 2)
    return np.where(at <= SCALE, w_near, np.where(at <= 2 * SCALE, w_far, 0))


def _mitchell_kernel_i32(t):
    """Mitchell-Netravali b=c=1/3 kernel (channel_ops.zig:378-394); its
    support tests ``at < s`` where the other two test ``at <= SCALE``."""
    s = SCALE
    at = np.abs(t).astype(np.int64)
    at2 = at * at
    at3 = at2 * at
    w_near = _trunc_div_np(21 * at3 - 36 * at2 * s + 16 * s**3, 18 * s * s)
    w_far = _trunc_div_np(-7 * at3 + 36 * at2 * s - 60 * at * s * s
                          + 32 * s**3, 18 * s * s)
    return np.where(at < s, w_near, np.where(at < 2 * s, w_far, 0))


def _lanczos_kernel_f32(x):
    """Lanczos3 (channel_ops.zig:449-457), computed in f32."""
    x = np.asarray(x, dtype=np.float32)
    a = np.float32(3.0)
    pi_x = np.float32(np.pi) * x
    with np.errstate(divide="ignore", invalid="ignore"):
        val = (a * np.sin(pi_x) * np.sin(pi_x / a)) / (pi_x * pi_x)
    val = np.where(x == 0, np.float32(1.0), val)
    return np.where(np.abs(x) >= a, np.float32(0.0), val).astype(np.float32)


CUBIC_KERNELS = {  # the 8.8 integer kernel of each cubic-family method
    Interpolation.BICUBIC: _cubic_kernel_i32,
    Interpolation.CATMULL_ROM: _catmull_kernel_i32,
    Interpolation.MITCHELL: _mitchell_kernel_i32,
}


def cubic_axis_table(src_n: int, dst_n: int, kernel):
    """MIRROR-resolved indices int32 ``[dst, 4]`` and 8.8 integer weights
    int32 ``[dst, 4]`` of a cubic-family axis."""
    _, i0, frac = _axis_coords(src_n, dst_n)
    f_fix = np.trunc(frac * np.float32(SCALE)).astype(np.int64)  # 0..255
    ks = np.arange(4, dtype=np.int64)
    idx = resolve_index_np(i0[:, None] + ks[None, :] - 1, src_n)
    w = kernel(ks[None, :] * SCALE - SCALE - f_fix[:, None])
    return idx.astype(np.int32), w.astype(np.int32)


def lanczos_axis_table(src_n: int, dst_n: int):
    """MIRROR-resolved indices int32 ``[dst, 6]`` and f32 Lanczos3
    weights ``[dst, 6]``."""
    _, i0, frac = _axis_coords(src_n, dst_n)
    ks = np.arange(6, dtype=np.int64)
    idx = resolve_index_np(i0[:, None] + ks[None, :] - 2, src_n)
    w = _lanczos_kernel_f32((ks[None, :] - 2).astype(np.float32)
                            - frac[:, None])
    return idx.astype(np.int32), w.astype(np.float32)


def build_tap_matrix(idx, weights, src_n: int, dst_n: int) -> np.ndarray:
    """Scatter-add tap (index, weight) tables into a dense [dst, src]
    int64 matrix. idx: [dst, k] resolved source indices (-1 = ZERO-mode
    out-of-bounds, skipped); weights: [k] or [dst, k] integer weights."""
    idx = np.asarray(idx, dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    if w.ndim == 1:
        w = np.broadcast_to(w[None, :], idx.shape)
    M = np.zeros((dst_n, src_n), dtype=np.int64)
    rows = np.repeat(np.arange(dst_n), idx.shape[1])
    cols = idx.ravel()
    vals = w.ravel()
    keep = cols >= 0
    np.add.at(M, (rows[keep], cols[keep]), vals[keep])
    return M


def _kernel_to_int(kernel) -> np.ndarray:
    k = np.asarray(kernel, dtype=np.float32)
    return np.round(k * np.float32(SCALE)).astype(np.int32)


def gaussian_kernel(sigma: float) -> tuple:
    """Normalized 1-D Gaussian, radius = ceil(3 sigma)
    (reference: src/image.zig:973-990)."""
    radius = int(np.ceil(3.0 * np.float32(sigma)))
    x = np.arange(2 * radius + 1, dtype=np.float32) - np.float32(radius)
    k = np.exp(-(x * x) / (2.0 * np.float32(sigma) * np.float32(sigma)))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def blur_radius(sigma: float) -> int:
    """Half-width of the Gaussian taps; 0 when ``sigma == 0`` (no blur)."""
    return 0 if sigma == 0 else len(gaussian_kernel(sigma)) // 2


def bilinear_axis_table(src_n: int, dst_n: int) -> np.ndarray:
    """Per-axis bilinear taps as int32 ``[3, dst_n]`` rows ``(a, b, f)``:
    output position i reads source ``a[i]`` with weight ``256 - f[i]`` and
    ``b[i]`` with weight ``f[i]``, where ``f = trunc(frac * 256)`` and both
    indices are MIRROR-resolved (zignal_tpu/ops/interpolation.py:231-238)."""
    _, i0, frac = _axis_coords(src_n, dst_n)
    f = np.trunc(frac * np.float32(SCALE)).astype(np.int64)
    a = resolve_index_np(i0, src_n)
    b = resolve_index_np(i0 + 1, src_n)
    return np.stack([a, b, f]).astype(np.int32)


def border_tap_table(n: int, ksize: int, border: BorderMode) -> np.ndarray:
    """Resolved tap indices of a ``ksize``-tap filter on an axis of
    length ``n``, int64 ``[n, ksize]``: output i reads ``taps[i, k]`` with
    the k-th weight; -1 marks a ZERO-border tap that reads 0 (a Gaussian
    has ``ksize = 2r + 1``; zignal_tpu/ops/pallas_pipeline.py:169-180 is
    the MIRROR case)."""
    base = (np.arange(n, dtype=np.int64)[:, None]
            + np.arange(ksize)[None, :] - ksize // 2)
    return resolve_index_np(base, n, border)


def halo_axis_table(src_n: int, dst_n: int, radius: int) -> np.ndarray:
    """The bilinear table of one axis extended by a MIRROR halo, int32
    ``[3, dst_n + 2*radius]``: column ``p + radius`` holds the ``(a, b, f)``
    taps of resized position ``mirror(p)`` for ``p`` in
    ``[-radius, dst_n + radius)``. A blur tap ``k`` of output ``i`` reads
    halo column ``i + k``, the same position as ``border_tap_table``
    resolves with MIRROR, so a tile of the fused kernel needs no border
    logic of its own, even on an axis shorter than the radius."""
    pos = resolve_index_np(np.arange(-radius, dst_n + radius), dst_n)
    return np.ascontiguousarray(bilinear_axis_table(src_n, dst_n)[:, pos])


def window_bounds(n: int, radius: int):
    """First and last in-axis index of each clamped window, int32 [n]."""
    i = np.arange(n, dtype=np.int64)
    lo = np.maximum(i - radius, 0)
    hi = np.minimum(i + radius, n - 1)
    return lo.astype(np.int32), hi.astype(np.int32)


def extents(n: int, radius: int) -> np.ndarray:
    """Clamped window lengths as float32 [n]; their outer product is the
    box area of sharpen and box blur."""
    i = np.arange(n)
    r1 = np.clip(i - radius, 0, None)
    r2 = np.clip(i + radius, None, n - 1)
    return (r2 - r1 + 1).astype(np.float32)


def clamped_band(n: int, radius: int) -> np.ndarray:
    """[n, n] 0/1 matrix: row i sums src max(i-r,0)..min(i+r,n-1)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return (np.abs(i - j) <= radius).astype(np.int64)


def band_to_taps(M):
    """A dense integer band ``[dst, src]`` as compact tap tables
    ``(idx, w)``, int32 ``[dst, K]``, K the most nonzeros in any row:
    output i is ``sum_k w[i, k] * x[idx[i, k]]``. Rows are padded with
    weight 0 at their first nonzero column (column 0 for an empty row)."""
    M = np.asarray(M)
    nz = M != 0
    k = max(1, int(nz.sum(axis=1).max(initial=0)))
    # stable sort puts each row's nonzero columns first, in column order
    order = np.argsort(~nz, axis=1, kind="stable")[:, :k]
    keep = np.take_along_axis(nz, order, axis=1)
    w = np.where(keep, np.take_along_axis(M, order, axis=1), 0)
    idx = np.where(keep, order, order[:, :1])
    return idx.astype(np.int32), w.astype(np.int32)


def tile_sources(idx, w, tile: int):
    """Per output tile of ``tile`` rows, the distinct source positions
    its taps read, so a kernel can stage them in shared memory.

    Returns ``(src, local)``: int32 ``src [n_tiles, S]``, the sorted
    distinct sources of each tile (S the most of any tile; shorter lists
    repeat their last entry), and int32 ``local [dst, K]``, each tap's
    position in its tile's list. Taps of weight 0 read no source and
    point at position 0. A list of positions, not a span: a WRAP tile at
    the edge reads both ends of the axis, a span would be the whole axis."""
    idx = np.asarray(idx, np.int64)
    w = np.asarray(w)
    dst = idx.shape[0]
    lists = []
    local = np.zeros(idx.shape, np.int64)
    for t0 in range(0, dst, tile):
        ti, tw = idx[t0:t0 + tile], w[t0:t0 + tile]
        uniq = np.unique(ti[tw != 0])
        if uniq.size == 0:
            uniq = np.zeros(1, np.int64)
        local[t0:t0 + tile] = np.where(tw != 0,
                                       np.searchsorted(uniq, ti), 0)
        lists.append(uniq)
    s = max(u.size for u in lists)
    src = np.stack([np.pad(u, (0, s - u.size), mode="edge") for u in lists])
    return src.astype(np.int32), local.astype(np.int32)
