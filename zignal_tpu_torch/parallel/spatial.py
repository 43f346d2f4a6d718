"""Spatial (H-axis) sharding with halo exchange, the counterpart of
zignal_tpu/parallel/spatial.py on ``torch.distributed``.

One primitive covers every windowed op: exchange ``radius`` input rows
with the ring neighbours along a mesh axis (``_comm.exchange``),
synthesize the global top and bottom halos for the border mode, run the
unchanged single-device op on the extended block, and crop the halo rows
from its output. Output row j of the extended block reads only input rows
[j - radius, j + radius], all real data for the kept rows, so the op's own
border logic touches only rows that are cropped away, and the sharded
result is bit-identical to the single-device op.

The clamped-window ops (box blur, sharpen, adaptive threshold: window
areas shrink at the global edges) take ZERO halos, which make the window
sums exact everywhere, and the true areas from the global extent table
sliced at the rank's offset; the sums are exact integers, rounded as the
single-device ops round them.

Each function returns a callable that every rank of the mesh calls with
the whole image (a numpy array or tensor, which it slices) or a DTensor
sharded on the H axis, and that returns the result as a DTensor over the
ranks' shards, or, for a reduction, the same tensor on every rank.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..enums import BorderMode
from ..ops import binary, integral, metrics
from ..ops.order_stat import median_blur
from ..ops.convolution import sobel_magnitude
from ..ops.tables import extents
from . import _comm

__all__ = [
    "halo_extend", "spatial_op", "spatial_op_2d",
    "spatial_box_blur", "spatial_sharpen", "spatial_adaptive_mean_threshold",
    "spatial_sobel", "spatial_dilate", "spatial_erode",
    "spatial_median_blur", "spatial_ssim", "spatial_mean_cov_image",
]

_DOWNWARD, _UPWARD = 1, 2  # tags: rows sent to the next / previous rank


def _check_halo(h_loc: int, radius: int, border: BorderMode) -> None:
    if radius > h_loc or (border == BorderMode.MIRROR and radius + 1 > h_loc):
        raise ValueError(
            f"shard of {h_loc} rows too small for halo radius {radius}; "
            "use fewer chips or a smaller window")


def halo_extend(local, radius: int, border: BorderMode, mesh,
                axis_name: str = "batch", axis: int = 0):
    """Extend this rank's block with ``radius`` rows of halo on each side
    of ``axis``: the ring neighbours' edge rows along ``axis_name`` for
    interior boundaries, border-mode synthesis at the global edges (zero,
    replicate, mirror without the edge row; WRAP takes the ring's
    wrap-around). A ring of one takes its own rows, for it cannot send to
    itself."""
    border = BorderMode(border)
    h_loc = local.shape[axis]
    _check_halo(h_loc, radius, border)
    if radius == 0:
        return local

    def sl(lo, hi):
        return local.narrow(axis, lo, hi - lo)

    n = _comm.axis_size(mesh, axis_name)
    idx = _comm.axis_rank(mesh, axis_name)
    wrap = border == BorderMode.WRAP
    top, bottom = sl(0, radius), sl(h_loc - radius, h_loc)
    up = down = None  # the previous rank's bottom rows, the next's top
    if n == 1:
        up, down = bottom, top
    else:
        has_prev, has_next = wrap or idx > 0, wrap or idx < n - 1
        prev, nxt = _comm.peer(mesh, axis_name, -1), \
            _comm.peer(mesh, axis_name, 1)
        sends, recvs = [], []
        if has_next:
            sends.append((bottom, nxt, _DOWNWARD))
        if has_prev:
            sends.append((top, prev, _UPWARD))
            up = torch.empty_like(bottom)
            recvs.append((up, prev, _DOWNWARD))
        if has_next:
            down = torch.empty_like(top)
            recvs.append((down, nxt, _UPWARD))
        _comm.exchange(sends, recvs, mesh, axis_name)
    if not wrap:
        if border == BorderMode.ZERO:
            syn_top, syn_bot = torch.zeros_like(top), torch.zeros_like(top)
        elif border == BorderMode.REPLICATE:
            syn_top = sl(0, 1).repeat_interleave(radius, dim=axis)
            syn_bot = sl(h_loc - 1, h_loc).repeat_interleave(radius, dim=axis)
        else:  # MIRROR: reflect without the edge row (border.zig:46)
            syn_top = torch.flip(sl(1, radius + 1), (axis,))
            syn_bot = torch.flip(sl(h_loc - radius - 1, h_loc - 1), (axis,))
        if idx == 0:
            up = syn_top
        if idx == n - 1:
            down = syn_bot
    return torch.cat([up, local, down], dim=axis)


def crop_op(local, fn, radius: int, border: BorderMode, mesh,
            axis_name: str, axis: int = 0):
    """``fn`` of this rank's block with H (``axis``) sharded over
    ``axis_name``: halo-extend, apply, crop the halo rows."""
    ext = halo_extend(local, radius, border, mesh, axis_name, axis)
    return fn(ext).narrow(axis, radius, local.shape[axis]).contiguous()


def spatial_op(mesh, fn, radius: int, border: BorderMode = BorderMode.MIRROR,
               axis_name: str = "batch"):
    """Lift a single-device windowed op to an H-sharded one: ``fn`` maps
    an ``[H, ...]`` block to an ``[H, ...]`` block reading only input rows
    within ``radius`` of each output row, with ``border`` as its vertical
    border; the lift is bit-identical to ``fn`` on the whole image."""
    border = BorderMode(border)
    dims = {axis_name: 0}

    def run(x):
        local = _comm.local_shard(x, mesh, dims)
        return _comm.as_global(
            crop_op(local, fn, radius, border, mesh, axis_name), mesh, dims)

    return run


def spatial_op_2d(mesh, fn, radius: int,
                  border: BorderMode = BorderMode.MIRROR,
                  batch_axis: str = "batch", space_axis: str = "space"):
    """Lift a windowed op over a 2-D (batch x space) mesh: a ``[B, H, ...]``
    batch shards its images over ``batch_axis`` (no communication) and its
    rows over ``space_axis`` (halo rows along that ring). ``fn`` maps a
    ``[b, H, ...]`` block of images to ``[b, H, ...]`` (the port's ops take
    leading batch dims; the JAX package vmaps a per-image op)."""
    border = BorderMode(border)
    dims = {batch_axis: 0, space_axis: 1}

    def run(x):
        local = _comm.local_shard(x, mesh, dims)
        return _comm.as_global(
            crop_op(local, fn, radius, border, mesh, space_axis, axis=1),
            mesh, dims)

    return run


# ---------------------------------------------------------------------------
# Clamped-window family (box blur / sharpen / adaptive threshold)
# ---------------------------------------------------------------------------


def sharded_box_sums(local, h_total: int, radius: int, mesh, axis_name: str):
    """Exact int32 clamped-window sums of this rank's u8 ``[..., h, W, C]``
    block (H sharded over ``axis_name``) and the f32 window areas
    ``[h, W, 1]`` (numpy): a ZERO-halo exchange, the full ``2r + 1`` rows
    summed over the extended block (absent rows add 0, as clamping does),
    the columns clamped, and the areas sliced from the global extent
    table at the rank's row offset."""
    h_axis = local.ndim - 3
    h_loc, w = local.shape[h_axis], local.shape[-2]
    ext = halo_extend(local, radius, BorderMode.ZERO, mesh, axis_name,
                      axis=h_axis)
    cs = torch.cumsum(ext, dim=h_axis, dtype=torch.int64)
    cs = torch.cat([torch.zeros_like(cs.narrow(h_axis, 0, 1)), cs],
                   dim=h_axis)
    k = 2 * radius + 1
    rows = cs.narrow(h_axis, k, h_loc) - cs.narrow(h_axis, 0, h_loc)
    sums = integral.window_sums(rows, radius, axes=(-2,)).to(torch.int32)
    off = _comm.axis_rank(mesh, axis_name) * h_loc
    area = (extents(h_total, radius)[off:off + h_loc, None]
            * extents(w, radius)[None, :])[..., None]
    return sums, area


def _clamped(mesh, h_total: int, radius: int, axis_name: str, finish,
             plane: bool = False):
    dims = {axis_name: 0}

    def run(x):
        local = _comm.local_shard(x, mesh, dims)
        block = local[..., None] if plane else local
        if radius == 0 and not plane:
            return _comm.as_global(local, mesh, dims)
        sums, area = sharded_box_sums(block, h_total, radius, mesh,
                                      axis_name)
        fits = integral.sums_fit_f32(h_total, block.shape[-2], radius)
        return _comm.as_global(finish(block, sums, area, fits), mesh, dims)

    return run


def spatial_box_blur(mesh, h_total: int, radius: int,
                     axis_name: str = "batch"):
    """H-sharded box blur of ``[H, W, C]`` u8, bit-identical to
    ``ops.integral.box_blur`` (clamped windows, integral.zig)."""
    return _clamped(mesh, h_total, radius, axis_name,
                    lambda x, s, a, fits: integral.box_from_sums(s, a, fits))


def spatial_sharpen(mesh, h_total: int, radius: int,
                    axis_name: str = "batch"):
    """H-sharded unsharp mask (2 * x - box mean), bit-identical to
    ``ops.integral.sharpen``."""
    return _clamped(mesh, h_total, radius, axis_name,
                    integral.sharpen_from_sums)


def spatial_adaptive_mean_threshold(mesh, h_total: int, radius: int,
                                    c: float, axis_name: str = "batch"):
    """H-sharded adaptive mean threshold of an ``[H, W]`` u8 plane, equal
    to ``ops.binary.adaptive_mean_threshold`` (binary.zig:86-118)."""
    def finish(x, sums, area, fits):
        return binary.adaptive_from_sums(x[..., 0], sums, area, fits, c)

    return _clamped(mesh, h_total, radius, axis_name, finish, plane=True)


# ---------------------------------------------------------------------------
# Crop-trick instances of stock ops
# ---------------------------------------------------------------------------


def spatial_sobel(mesh, axis_name: str = "batch"):
    """H-sharded Sobel magnitude of an ``[H, W]`` f32 plane (REPLICATE
    borders, as ``ops.convolution.sobel_magnitude``)."""
    return spatial_op(mesh, sobel_magnitude, 1, BorderMode.REPLICATE,
                      axis_name)


def spatial_dilate(mesh, ksize: int = 3, iterations: int = 1,
                   axis_name: str = "batch"):
    """H-sharded binary dilation of an ``[H, W]`` u8 mask (zero
    background, as ``ops.binary.dilate``)."""
    return spatial_op(mesh, partial(binary.dilate, ksize=ksize,
                                    iterations=iterations),
                      (ksize // 2) * iterations, BorderMode.ZERO, axis_name)


def spatial_erode(mesh, ksize: int = 3, iterations: int = 1,
                  axis_name: str = "batch"):
    return spatial_op(mesh, partial(binary.erode, ksize=ksize,
                                    iterations=iterations),
                      (ksize // 2) * iterations, BorderMode.ZERO, axis_name)


def spatial_median_blur(mesh, radius: int, axis_name: str = "batch"):
    """H-sharded median blur of ``[H, W, C]`` u8 (MIRROR borders, as
    ``ops.order_stat.median_blur``)."""
    return spatial_op(mesh, partial(median_blur, radius=radius), radius,
                      BorderMode.MIRROR, axis_name)


# ---------------------------------------------------------------------------
# Windowed global reductions
# ---------------------------------------------------------------------------


def ssim_sharded(a, b, h_total: int, mesh, axis_name: str):
    """Mean SSIM of each image pair of this rank's u8 ``[..., h, W, C]``
    blocks (H sharded over ``axis_name``) -> f32 ``[...]``, the same on
    every rank of the axis: the global means and the masked window sums
    are summed in f64 over the ranks, the 11 x 11 windows see 5-row ZERO
    halos, and a window counts where its centre row is this rank's and
    globally valid (within f32 reduction order of ``ops.metrics.ssim``)."""
    r = 5
    x = metrics.luminance_plane(a)
    y = metrics.luminance_plane(b)                      # [..., h, W]
    h_loc, w = x.shape[-2], x.shape[-1]
    count = float(h_total * w)
    means = _comm.all_reduce(
        torch.stack([x.sum(dim=(-2, -1), dtype=torch.float64),
                     y.sum(dim=(-2, -1), dtype=torch.float64)]),
        mesh, axis_name) / count
    gx = means[0].to(torch.float32)[..., None, None]
    gy = means[1].to(torch.float32)[..., None, None]
    ext = halo_extend(torch.stack([x - gx, y - gy]), r, BorderMode.ZERO,
                      mesh, axis_name, axis=x.ndim - 1)
    xc, yc = ext[0], ext[1]
    k1d = metrics._ssim_window_1d()
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    conv = partial(metrics._valid_sep_conv, k1d=k1d)
    mu_xc, mu_yc = conv(xc), conv(yc)
    mu_x, mu_y = mu_xc + gx, mu_yc + gy
    sigma_x = torch.clamp_min(conv(xc * xc) - mu_xc * mu_xc, 0.0)
    sigma_y = torch.clamp_min(conv(yc * yc) - mu_yc * mu_yc, 0.0)
    sigma_xy = conv(xc * yc) - mu_xc * mu_yc
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    centres = _comm.axis_rank(mesh, axis_name) * h_loc + np.arange(h_loc)
    valid = torch.from_numpy((centres >= r) & (centres <= h_total - 1 - r))
    smap = (num / den)[..., valid.to(num.device), :]
    total = _comm.all_reduce(smap.sum(dim=(-2, -1), dtype=torch.float64),
                             mesh, axis_name)
    return (total / float((h_total - 2 * r) * (w - 2 * r))).to(torch.float32)


def spatial_ssim(mesh, h_total: int, axis_name: str = "batch"):
    """Mean SSIM of two H-sharded ``[H, W, C]`` u8 images (within f32
    reduction order of ``ops.metrics.ssim``; the tests hold it to 1e-5)."""
    dims = {axis_name: 0}

    def run(a, b):
        return ssim_sharded(_comm.local_shard(a, mesh, dims),
                            _comm.local_shard(b, mesh, dims), h_total, mesh,
                            axis_name)

    return run


def spatial_mean_cov_image(mesh, axis_name: str = "batch"):
    """Channel mean and covariance (1/(n-1), FDM's normalization) of one
    H-sharded ``[H, W, 3]`` u8 image in [0, 1] units, as f32 tensors on
    every rank: two passes, each rank's sums taken in f64 and summed over
    the ranks (the sharded statistics stage of FDM, fdm.zig:141-272)."""
    from ..fdm import _unit

    dims = {axis_name: 0}

    def run(x):
        local = _comm.local_shard(x, mesh, dims)
        v = _unit(local[..., :3]).reshape(-1, 3).to(torch.float64)
        head = torch.cat([v.sum(dim=0), v.new_tensor([v.shape[0]])])
        head = _comm.all_reduce(head, mesh, axis_name)
        cnt = head[3]
        mean = head[:3] / cnt
        xc = v - mean
        ss = _comm.all_reduce(xc.T @ xc, mesh, axis_name)
        cov = ss / torch.clamp_min(cnt - 1.0, 1.0)
        return mean.to(torch.float32), cov.to(torch.float32)

    return run
