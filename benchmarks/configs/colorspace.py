"""The colorspace deployment's adapter: one request equalizes a ``[B,
rows, cols, 3]`` u8 batch (``ops.enhancement.equalize``) and converts the
result to f32 CIELAB (``pipeline.color_chain_values``), both on the card,
and returns both. Checked against ``reference/colorspace.py`` by the
equalized bytes that differ (the stage is exact) and the widest gap of a
Lab value."""

from __future__ import annotations

import torch

from benchmarks import roofline_colorspace
from benchmarks.reference.colorspace import colorspace as _reference


def input_shape(cfg, batch: int) -> tuple:
    return (batch, cfg["rows"], cfg["cols"], cfg["channels"])


def pixels(cfg, batch: int) -> int:
    return batch * cfg["rows"] * cfg["cols"]


def bound_ms(cfg, batch: int) -> float:
    """K3's least time a request (``color_chain_roofline``)."""
    return roofline_colorspace.k3_lab_bound(batch, cfg["rows"],
                                            cfg["cols"])[0]


def equalize_bound_ms(cfg, batch: int) -> float:
    """The equalization's least time a request (``equalize_roofline``)."""
    return roofline_colorspace.equalize_bound(batch, cfg["rows"], cfg["cols"],
                                              cfg["channels"])[0]


def run_device(cfg, x, span):
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import enhancement

    with span("launch"):
        eq = enhancement.equalize(x)
        return eq, pipeline.color_chain_values(eq, cfg["spaces"])


def reference(cfg, x, control: bool = False):
    """Exact equalization, then float64 Lab; the control computes the Lab
    stage in bfloat16."""
    return _reference(x, torch.bfloat16 if control else torch.float64)


def compare(cfg, out, ref) -> dict:
    (eq, lab), (ref_eq, ref_lab) = out, ref
    gap = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
              for a, b in zip(lab, ref_lab))  # an image at a time
    return {"equalized_bytes_differing": float((eq != ref_eq).sum()),
            "lab_max_abs_gap": gap}


def launches():
    """K3's launches so far."""
    from zignal_tpu_torch.ops import color_chain

    return color_chain.LAUNCHES
