"""Batched pipelines on u8 tensors, the counterpart of
zignal_tpu/pipeline.py. Each function runs on its input tensor's device.
"""

from __future__ import annotations

import torch

from .color import convert_array, convert_chain
from .enums import Interpolation
from .ops.color_chain import chain_supported, fused_color_chain_u8, \
    values_chain_supported
from .ops.convolution import gaussian_blur
from .ops.filter_chain import fused_blur_sharpen_morph
from .ops.fused_pipeline import fused_resize_blur_oklab
from .ops.interpolation import resize as resize_op
from .profiling import RECORDER, span_start

__all__ = ["resize_blur_oklab", "batched_resize", "batched_gaussian_blur",
           "filter_chain", "color_chain_u8", "color_chain_values"]


def color_chain_u8(batch, spaces):
    """[B, H, W, 3] u8 through ``color.convert_chain(spaces)`` and back to
    u8 via clip(round(f * 255)): the BASELINE config-2 quantized chain.

    The route is chosen from ``spaces`` alone: a u8 ``[B, H, W, 3]``
    batch whose chain ``chain_supported`` accepts runs the fused colour
    chain (one kernel launch on the card, the plain version on the CPU);
    any other chain or input runs the plain ``convert_chain`` on the
    batch's device."""
    spaces = tuple(spaces)
    if (batch.dtype == torch.uint8 and batch.ndim == 4
            and batch.shape[-1] == 3 and chain_supported(spaces)):
        return fused_color_chain_u8(batch.contiguous(), spaces)
    f = convert_chain(batch.to(torch.float32) / 255.0, spaces)
    return torch.clamp(torch.round(f * 255.0), 0, 255).to(torch.uint8)


def color_chain_values(batch, spaces):
    """[B, H, W, 3] u8 sRGB -> [B, H, W, 3] f32 values in ``spaces[-1]``,
    as ``color.convert_chain(batch / 255, spaces)`` gives them: the
    perceptual values themselves (Lab for colour search and Delta E), not
    quantized back to u8.

    The route is chosen from ``spaces`` alone: a u8 ``[B, H, W, 3]``
    batch whose chain ``values_chain_supported`` accepts (rgb into xyz,
    lab, oklab or xyb) runs the fused colour chain unquantized (one kernel
    launch on the card, the plain version on the CPU); any other chain or
    input runs the plain ``convert_chain`` on the batch's device. During
    a profiler session the call is the recorder's span
    ``color_chain_values``."""
    t0 = span_start()
    spaces = tuple(spaces)
    if (batch.dtype == torch.uint8 and batch.ndim == 4
            and batch.shape[-1] == 3 and values_chain_supported(spaces)):
        out = fused_color_chain_u8(batch.contiguous(), spaces,
                                   quantize=False)
    else:
        out = convert_chain(batch.to(torch.float32) / 255.0, spaces)
    if t0:
        RECORDER.add("color_chain_values", t0)
    return out


def batched_resize(batch, rows: int, cols: int,
                   method: Interpolation = Interpolation.BILINEAR):
    """Resize [B, H, W, C] -> [B, rows, cols, C]."""
    return resize_op(batch, rows, cols, method)


def batched_gaussian_blur(batch, sigma: float):
    """Gaussian blur of u8 [B, H, W, C]; the separable kernel on the
    card."""
    return gaussian_blur(batch, sigma)


def resize_blur_oklab(batch, out_rows: int, out_cols: int, sigma: float = 2.0,
                      method: Interpolation = Interpolation.BILINEAR):
    """The north-star pipeline (BASELINE.md): batched resize -> Gaussian
    blur -> sRGB->Oklab, one fused kernel on the card.

    batch: [B, H, W, 3] uint8 sRGB. Returns [B, out_rows, out_cols, 3]
    float32 Oklab. uint8 stages are bit-exact with the reference's
    fixed-point kernels; the Oklab conversion is float32. Another
    resampling method runs the three stages one after the other (the
    separable kernel blurs on the card). During a profiler session the
    call is the recorder's span ``resize_blur_oklab``.
    """
    t0 = span_start()
    if Interpolation(method) == Interpolation.BILINEAR:
        out = fused_resize_blur_oklab(batch.contiguous(), out_rows, out_cols,
                                      float(sigma))
    else:
        small = resize_op(batch, out_rows, out_cols, method)
        blurred = gaussian_blur(small, float(sigma))
        out = convert_array(blurred.to(torch.float32) / 255.0, "rgb",
                            "oklab")
    if t0:
        RECORDER.add("resize_blur_oklab", t0)
    return out


def filter_chain(plane, sigma: float = 2.0, sharpen_radius: int = 2,
                 thr: float = 128.0):
    """Gaussian blur -> unsharp mask -> threshold -> dilate3 -> erode3 on
    a [H, W] or [B, H, W] u8 plane (the BASELINE config-3 chain), one
    fused kernel on the card at any shape. Returns a u8 0/255 mask of the
    same shape, bit-exact with the JAX package's chain. During a profiler
    session the call is the recorder's span ``filter_chain``."""
    t0 = span_start()
    out = fused_blur_sharpen_morph(plane.contiguous(), float(sigma),
                                   int(sharpen_radius), float(thr))
    if t0:
        RECORDER.add("filter_chain", t0)
    return out
