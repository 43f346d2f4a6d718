"""Blend modes (reference: src/blending.zig:8-160).

Copied from zignal_tpu/blending.py, with the per-mode math on torch
tensors in one place (``_blend_rgb``): ``blend_colors`` runs it on a
colour's three f32 components (IEEE f32 like the JAX package's numpy, so
the same bits), ``blend_arrays`` on whole images. Two callers of
``blend_arrays`` round differently, so it takes ``fused``:

- the host path (``Image.blend``) is numpy's f32 arithmetic in the JAX
  package, one rounding an operation: ``fused=False``;
- the device path (``ImageBatch.blend``) is an XLA program in the JAX
  package, whose CPU backend contracts ``x * y + z`` into one fused
  multiply-add where the product has one use: ``fused=True`` rounds each
  such sum once, as ``ops/fma.py`` does.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .ops.fma import fma

__all__ = ["Blending", "blend_colors", "blend_arrays"]


class Blending(enum.IntEnum):
    """Blend modes (reference: src/blending.zig:8-22)."""

    NONE = 0
    NORMAL = 1
    MULTIPLY = 2
    SCREEN = 3
    OVERLAY = 4
    SOFT_LIGHT = 5
    HARD_LIGHT = 6
    COLOR_DODGE = 7
    COLOR_BURN = 8
    DARKEN = 9
    LIGHTEN = 10
    DIFFERENCE = 11
    EXCLUSION = 12


def blend_colors(base, overlay, mode):
    """Blend two Rgba colors; u8 math in f32 (reference: blending.zig:27-160)."""
    from .color._classes import Rgba

    mode = Blending(mode)
    if mode == Blending.NONE:
        return Rgba._new_unchecked(list(overlay._v))
    if overlay._v[3] == 0:
        return Rgba._new_unchecked(list(base._v))
    if base._v[3] == 0:
        return Rgba._new_unchecked(list(overlay._v))
    if mode == Blending.NORMAL and overlay._v[3] == 255:
        return Rgba._new_unchecked(list(overlay._v))

    f32 = np.float32
    base_f = np.array(base._v, dtype=f32) / f32(255.0)
    over_f = np.array(overlay._v, dtype=f32) / f32(255.0)
    blended = _blend_rgb(torch.from_numpy(base_f[:3]),
                         torch.from_numpy(over_f[:3]), mode,
                         _mad_rounded).numpy()

    if overlay._v[3] == 255:
        out = np.append(blended, f32(1.0))
    else:
        oa, ba = over_f[3], base_f[3]
        result_a = oa + ba * (f32(1.0) - oa)
        if result_a <= 0:
            return Rgba._new_unchecked([0, 0, 0, 0])
        base_weight = ba * (f32(1.0) - oa)
        inv = f32(1.0) / result_a
        out_rgb = (blended * oa + base_f[:3] * base_weight) * inv
        out = np.append(out_rgb, result_a)
    u8 = np.floor(255.0 * np.clip(out.astype(np.float64), 0.0, 1.0) + 0.5).astype(int)
    return Rgba._new_unchecked(list(u8))


def _blend_rgb(b, o, mode, mad):
    """Blend the rgb values ``b`` and ``o`` (f32 tensors in [0, 1]), each
    ``x * y + z`` that XLA's CPU backend contracts written as
    ``mad(x, y, z)`` (and ``z - x * y`` as ``mad(-x, y, z)``: negation is
    exact)."""
    if mode == Blending.NORMAL or mode == Blending.NONE:
        return o
    if mode == Blending.MULTIPLY:
        return b * o
    if mode == Blending.SCREEN:
        return mad(-(1.0 - b), 1.0 - o, 1.0)
    if mode == Blending.OVERLAY:
        return torch.where(b < 0.5, 2.0 * b * o,
                           mad(-(2.0 * (1.0 - b)), 1.0 - o, 1.0))
    if mode == Blending.SOFT_LIGHT:  # XLA contracts neither branch here
        return torch.where(o <= 0.5, b - (1.0 - 2.0 * o) * b * (1.0 - b),
                           b + (2.0 * o - 1.0) * (torch.sqrt(b) - b))
    if mode == Blending.HARD_LIGHT:
        return torch.where(o < 0.5, 2.0 * o * b,
                           mad(-(2.0 * (1.0 - o)), 1.0 - b, 1.0))
    if mode == Blending.COLOR_DODGE:
        ratio = b / torch.clamp_min(1.0 - o, 1e-30)
        val = torch.where(o >= 1.0, 1.0, torch.clamp_max(ratio, 1.0))
        return torch.where(b == 0.0, 0.0, val)
    if mode == Blending.COLOR_BURN:
        ratio = (1.0 - b) / torch.clamp_min(o, 1e-30)
        val = torch.where(o <= 0.0, 0.0, torch.clamp_min(1.0 - ratio, 0.0))
        return torch.where(b >= 1.0, 1.0, val)
    if mode == Blending.DARKEN:
        return torch.minimum(b, o)
    if mode == Blending.LIGHTEN:
        return torch.maximum(b, o)
    if mode == Blending.DIFFERENCE:
        return torch.abs(b - o)
    if mode == Blending.EXCLUSION:
        return mad(-(2.0 * b), o, b + o)
    raise ValueError(f"unknown blend mode {mode!r}")


def _mad_rounded(x, y, z):
    return x * y + z


def _mad_fused(x, y, z):
    if not isinstance(z, torch.Tensor):
        z = torch.full((), z, dtype=x.dtype, device=x.device)
    return fma(x, y, z)


def blend_arrays(base, overlay, mode, fused: bool):
    """Batched alpha-compositing blend on channel-last f32 tensors in
    [0, 1]: ``base``/``overlay`` [..., 4] RGBA -> [..., 4]. ``fused``
    rounds every contracted multiply-add once (the JAX package's device
    path), else each operation (its host path)."""
    mode = Blending(mode)
    if mode == Blending.NONE:
        return overlay
    mad = _mad_fused if fused else _mad_rounded
    base_rgb, base_a = base[..., :3], base[..., 3:4]
    over_rgb, over_a = overlay[..., :3], overlay[..., 3:4]
    blended = _blend_rgb(base_rgb, over_rgb, mode, mad)
    # where XLA's CPU backend contracts, found against the JAX package's
    # compiled blend on the CPU: the alpha it stores is one fused sum, the
    # alpha it divides by is not, and the colour sum fuses the product of
    # the input overlay (NORMAL) or the base's weighted product (the rest)
    base_weight = base_a * (1.0 - over_a)
    safe_a = torch.clamp_min(over_a + base_weight, 1e-30)
    result_a = mad(base_a, 1.0 - over_a, over_a)
    if mode == Blending.NORMAL:
        num = mad(blended, over_a, base_rgb * base_weight)
    else:
        num = mad(base_rgb, base_weight, blended * over_a)
    out = torch.cat([num / safe_a, result_a], dim=-1)
    # fully transparent overlay keeps base; hidden base takes overlay
    out = torch.where(over_a <= 0.0, base, out)
    return torch.where((base_a <= 0.0) & (over_a > 0.0), overlay, out)
