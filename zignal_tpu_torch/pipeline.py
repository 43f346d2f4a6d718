"""Batched pipelines on ``[B, H, W, C]`` u8 tensors, the counterpart of
zignal_tpu/pipeline.py. Each function runs on its input tensor's device.
"""

from __future__ import annotations

from .enums import Interpolation
from .ops.convolution import gaussian_blur
from .ops.fused_pipeline import fused_resize_blur_oklab
from .ops.interpolation import resize as resize_op

__all__ = ["resize_blur_oklab", "batched_resize", "batched_gaussian_blur"]


def batched_resize(batch, rows: int, cols: int,
                   method: Interpolation = Interpolation.BILINEAR):
    """Resize [B, H, W, C] -> [B, rows, cols, C]."""
    return resize_op(batch, rows, cols, method)


def batched_gaussian_blur(batch, sigma: float):
    return gaussian_blur(batch, sigma)


def resize_blur_oklab(batch, out_rows: int, out_cols: int, sigma: float = 2.0,
                      method: Interpolation = Interpolation.BILINEAR):
    """The north-star pipeline (BASELINE.md): batched resize -> Gaussian
    blur -> sRGB->Oklab, one fused kernel on the card.

    batch: [B, H, W, 3] uint8 sRGB. Returns [B, out_rows, out_cols, 3]
    float32 Oklab. uint8 stages are bit-exact with the reference's
    fixed-point kernels; the Oklab conversion is float32.
    """
    if Interpolation(method) != Interpolation.BILINEAR:
        raise NotImplementedError(
            f"resize_blur_oklab with {Interpolation(method).name} is not "
            "ported yet (ROADMAP item 9); only BILINEAR is")
    return fused_resize_blur_oklab(batch, out_rows, out_cols, float(sigma))
