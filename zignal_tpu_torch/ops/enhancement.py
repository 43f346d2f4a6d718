"""Histogram-based enhancement (reference: src/image/enhancement.zig), the
counterpart of zignal_tpu/ops/enhancement.py: ``autocontrast`` stretches
each channel's cutoff-percentile range to [0, 255]; ``equalize`` remaps
each channel through its CDF.

Every function takes one image ``[H, W, C]`` with histograms ``[C, 256]``,
or a batch ``[B, H, W, C]`` with ``[B, C, 256]``: the batch dimension is
written out where the JAX package maps over images. Nothing waits for the
card: histograms, tables and lookups are queued on its stream. For a CUDA
tensor, equalization is three hand-written kernels (csrc/equalize_u8.cu):
the histograms (``binary.histogram256_batch``), the tables
(``equalize_tables``, counted in ``TABLE_LAUNCHES``) and the lookup
(``binary.lut_apply_u8_per_channel``); ``equalize_reference`` is its plain
version, which a CPU tensor takes.

During a profiler session ``equalize`` is the recorder's span
``equalize``, with ``equalize.hist`` (the histograms) and ``equalize.lut``
(the tables and their lookup) inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profiling import RECORDER, span_start
from ._build import COUNT_LOCK, launch
from .binary import histogram256_batch, histogram256_batch_reference, \
    histogram256_multi, lut_apply_u8_per_channel, \
    lut_apply_u8_per_channel_reference

__all__ = ["autocontrast", "autocontrast_from_hists", "cutoff_pixels",
           "equalize", "equalize_from_hists", "equalize_reference",
           "equalize_tables", "equalize_tables_reference"]

# launches of the tables kernel since import
TABLE_LAUNCHES = 0


def _first_true(mask):
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` of a boolean array."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _cutoff_min(hists, cutoff_pixels: int):
    """First intensity whose cumulative count exceeds the cutoff
    (histogram.zig:123-140); the first non-zero bin when the cutoff is 0."""
    if cutoff_pixels == 0:
        return _first_true(hists > 0)
    over = torch.cumsum(hists, dim=-1) > cutoff_pixels
    return torch.where(over.any(dim=-1), _first_true(over), 255)


def _cutoff_max(hists, cutoff_pixels: int):
    rev = hists.flip(-1)
    if cutoff_pixels == 0:
        return 255 - _first_true(rev > 0)
    over = torch.cumsum(rev, dim=-1) > cutoff_pixels
    return torch.where(over.any(dim=-1), 255 - _first_true(over), 0)


def _batched(arr, hists):
    """(arr, hists) with a leading batch axis, and whether it was added."""
    if arr.ndim == 3:
        return arr[None], hists[None], True
    if arr.ndim != 4:
        raise ValueError("expected a u8 [H, W, C] or [B, H, W, C] tensor")
    return arr, hists, False


def _keep_alpha(out, arr, skip_alpha: bool):
    if skip_alpha and arr.shape[-1] == 4:
        out[..., 3] = arr[..., 3]
    return out


def cutoff_pixels(total: int, cutoff: float) -> int:
    """``trunc(f32(total) * f32(cutoff))``, the JAX package's f32 product."""
    return int(np.trunc(np.float32(total) * np.float32(cutoff)))


def autocontrast_from_hists(arr, hists, cutoff_pixels: int,
                            skip_alpha: bool = True):
    """Autocontrast of u8 ``arr`` given its per-channel histograms and the
    cutoff in pixels (computed from the whole image's pixel count)."""
    x, h, squeeze = _batched(arr, hists)
    cp = int(cutoff_pixels)
    lo = _cutoff_min(h, cp).to(torch.float32)[:, None, None, :]
    hi = _cutoff_max(h, cp).to(torch.float32)[:, None, None, :]
    rng = torch.where(hi > lo, hi - lo, 1.0)
    clamped = torch.minimum(torch.maximum(x.to(torch.float32), lo), hi)
    normalized = (clamped - lo) / rng
    out = torch.clamp(torch.floor(normalized * 255.0 + 0.5), 0, 255) \
        .to(torch.uint8)
    out = _keep_alpha(out, x, skip_alpha)
    return out[0] if squeeze else out


def _hists(arr):
    return histogram256_batch(arr) if arr.ndim == 4 \
        else histogram256_multi(arr)


def autocontrast(arr, cutoff: float = 0.0, skip_alpha: bool = True):
    """Stretch each channel's [cutoff_min, cutoff_max] to [0, 255]. ``arr``:
    u8 [H, W, C] or [B, H, W, C]."""
    total = arr.shape[-3] * arr.shape[-2]
    return autocontrast_from_hists(arr, _hists(arr),
                                   cutoff_pixels(total, cutoff), skip_alpha)


def equalize_tables_reference(hists, total: int, skip_alpha: bool = True):
    """The plain version of ``equalize_tables``, on any device. The
    reference's u32 arithmetic (enhancement.zig): ``(cdf - cdf_min) *
    255`` wraps modulo 2^32, past ~16.84 Mpix, as it does in the JAX
    package; here it is computed in int64 and masked to 32 bits before the
    floor division."""
    cdf = torch.cumsum(hists.to(torch.int64), dim=-1)      # [B, C, 256]
    nonzero = cdf > 0
    first = torch.gather(cdf, -1, _first_true(nonzero)[..., None])[..., 0]
    cdf_min = torch.where(nonzero.any(dim=-1), first, 0)   # [B, C]
    denom = int(total) - cdf_min
    num = ((cdf - cdf_min[..., None]) * 255) & 0xFFFFFFFF
    den = torch.clamp_min(denom, 1)[..., None] & 0xFFFFFFFF
    luts = torch.where(cdf >= cdf_min[..., None],
                       torch.div(num, den, rounding_mode="floor") & 0xFF, 0)
    ident = torch.arange(256, device=hists.device, dtype=torch.int64)
    luts = torch.where((denom == 0)[..., None], ident, luts)
    if skip_alpha and hists.shape[-2] == 4:
        luts[:, 3] = ident                     # alpha passes through
    return luts.to(torch.uint8)


def equalize_tables(hists, total: int, skip_alpha: bool = True):
    """u8 equalization tables ``[B, C, 256]`` from per-image, per-channel
    histograms ``[B, C, 256]`` and an image's pixel count ``total`` (the
    whole image's, where the histograms were summed over shards). A CUDA
    tensor runs the tables kernel (or raises); a CPU tensor the plain
    version."""
    global TABLE_LAUNCHES
    if hists.device.type == "cpu":
        return equalize_tables_reference(hists, total, skip_alpha)
    if hists.device.type != "cuda":
        raise ValueError(f"no tables kernel for device {hists.device}")
    if hists.ndim != 3 or hists.shape[-1] != 256:
        raise ValueError(f"expected histograms [B, C, 256], not "
                         f"{list(hists.shape)}")
    if hists.dtype not in (torch.int32, torch.int64):
        hists = hists.to(torch.int64)
    hists = hists.contiguous()
    b, c = hists.shape[0], hists.shape[1]
    luts = torch.empty(hists.shape, dtype=torch.uint8, device=hists.device)
    launch("zt_equalize_tables", hists.device, hists.data_ptr(),
           int(hists.dtype == torch.int64), luts.data_ptr(), b, c,
           int(total), int(skip_alpha))
    with COUNT_LOCK:
        TABLE_LAUNCHES += 1
    return luts


def equalize_from_hists(arr, hists, total: int, skip_alpha: bool = True):
    """Equalize u8 ``arr`` given its per-channel histograms and the whole
    image's pixel count: the tables (``equalize_tables``), then their
    lookup."""
    x, h, squeeze = _batched(arr, hists)
    out = lut_apply_u8_per_channel(x, equalize_tables(h, total, skip_alpha))
    return out[0] if squeeze else out


def equalize(arr, skip_alpha: bool = True):
    """Per-channel histogram equalization through an integer CDF LUT
    (enhancement.zig:84-150). ``arr``: u8 [H, W, C] or [B, H, W, C]."""
    t0 = span_start()
    hists = _hists(arr)
    if t0:
        t1 = RECORDER.add("equalize.hist", t0)
    out = equalize_from_hists(arr, hists, arr.shape[-3] * arr.shape[-2],
                              skip_alpha)
    if t0:
        RECORDER.add("equalize", t0, RECORDER.add("equalize.lut", t1))
    return out


def equalize_reference(arr, skip_alpha: bool = True):
    """The plain version of ``equalize``, on any device: the plain
    histograms, tables and lookup."""
    squeeze = arr.ndim == 3
    x = arr[None] if squeeze else arr
    tables = equalize_tables_reference(histogram256_batch_reference(x),
                                       x.shape[-3] * x.shape[-2], skip_alpha)
    out = lut_apply_u8_per_channel_reference(x, tables)
    return out[0] if squeeze else out
