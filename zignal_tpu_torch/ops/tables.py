"""Host-side numpy tables: resize coordinates, Gaussian taps, border
resolution.

The table functions below are copied op for op from the JAX package, so both
packages derive every integer tap from the same float32 arithmetic:

- ``resolve_index_np`` and ``_axis_coords``: zignal_tpu/ops/interpolation.py
- ``build_tap_matrix``: zignal_tpu/ops/mxu_resample.py (used by the tests
  to compare the per-axis tables with the JAX package's band matrices)
- ``_kernel_to_int`` and ``gaussian_kernel``: zignal_tpu/ops/convolution.py

Coordinates stay numpy float32 on the host: recomputing them on a device
can flip ``floor()`` at a few pixels.
"""

from __future__ import annotations

import numpy as np

from ..enums import BorderMode

__all__ = [
    "SCALE", "resolve_index_np", "build_tap_matrix", "gaussian_kernel",
    "blur_radius", "bilinear_axis_table", "blur_tap_table",
    "halo_axis_table",
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


def blur_tap_table(n: int, ksize: int) -> np.ndarray:
    """MIRROR-resolved tap indices of a ``ksize``-tap filter, int64
    ``[n, ksize]``: output i reads ``taps[i, k]`` with the k-th weight
    (zignal_tpu/ops/pallas_pipeline.py:169-180; a Gaussian has
    ``ksize = 2r + 1``)."""
    base = (np.arange(n, dtype=np.int64)[:, None]
            + np.arange(ksize)[None, :] - ksize // 2)
    return resolve_index_np(base, n, BorderMode.MIRROR)


def halo_axis_table(src_n: int, dst_n: int, radius: int) -> np.ndarray:
    """The bilinear table of one axis extended by a MIRROR halo, int32
    ``[3, dst_n + 2*radius]``: column ``p + radius`` holds the ``(a, b, f)``
    taps of resized position ``mirror(p)`` for ``p`` in
    ``[-radius, dst_n + radius)``. A blur tap ``k`` of output ``i`` reads
    halo column ``i + k``, the same position as ``blur_tap_table``
    resolves, so a tile of the fused kernel needs no border logic of its
    own, even on an axis shorter than the radius."""
    pos = resolve_index_np(np.arange(-radius, dst_n + radius), dst_n)
    return np.ascontiguousarray(bilinear_axis_table(src_n, dst_n)[:, pos])
