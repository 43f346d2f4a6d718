"""The north star's adapter: one request is ``pipeline.resize_blur_oklab``
of a ``[B, size, size, 3]`` u8 batch to ``[B, out, out, 3]`` f32 Oklab on
the card. Checked against ``reference/north_star.py`` by the widest gap
of an Oklab value."""

from __future__ import annotations

import torch

from benchmarks import roofline
from benchmarks.reference.north_star import north_star as _reference


def input_shape(cfg, batch: int) -> tuple:
    return (batch, cfg["size"], cfg["size"], cfg["channels"])


def pixels(cfg, batch: int) -> int:
    return batch * cfg["size"] * cfg["size"]


def bound_ms(cfg, batch: int) -> float:
    return roofline.k1_bound(batch, cfg["size"], cfg["out"])[0]


def run_device(cfg, x, span):
    from zignal_tpu_torch import pipeline

    with span("launch"):
        return pipeline.resize_blur_oklab(x, cfg["out"], cfg["out"],
                                          cfg["sigma"])


def reference(cfg, x, control: bool = False):
    """float64 Oklab; the control computes it in bfloat16."""
    return _reference(x, cfg["out"], cfg["out"], cfg["sigma"],
                      torch.bfloat16 if control else torch.float64)


def compare(cfg, out, ref) -> dict:
    gap = (out.to(torch.float64) - ref.to(torch.float64)).abs().max()
    return {"oklab_max_abs_gap": float(gap)}


def launches():
    """The kernel launches of this config's path so far."""
    from zignal_tpu_torch.ops import fused_pipeline

    return fused_pipeline.LAUNCHES
