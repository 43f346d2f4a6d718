"""The filter chain's adapter: one request is ``pipeline.filter_chain``
of a ``[B, size, size]`` u8 stack (B = 1: one ``[size, size]`` plane) to
a u8 mask on the card. Checked against ``reference/filter_fusion.py`` by
the number of mask bytes that differ: every stage is exact."""

from __future__ import annotations

import torch

from benchmarks import roofline
from benchmarks.reference.filter_fusion import filter_chain as _reference


def input_shape(cfg, batch: int) -> tuple:
    return ((batch,) if batch > 1 else ()) + (cfg["size"], cfg["size"])


def pixels(cfg, batch: int) -> int:
    return batch * cfg["size"] * cfg["size"]


def bound_ms(cfg, batch: int) -> float:
    return roofline.k2_bound(batch, cfg["size"])[0]


def run_device(cfg, x, span):
    from zignal_tpu_torch import pipeline

    with span("launch"):
        return pipeline.filter_chain(x, cfg["sigma"], cfg["sharpen_radius"],
                                     cfg["threshold"])


def reference(cfg, x, control: bool = False):
    """The f32 sharpen; the control computes it in bfloat16."""
    return _reference(x, cfg["sigma"], cfg["sharpen_radius"],
                      cfg["threshold"],
                      torch.bfloat16 if control else torch.float32)


def compare(cfg, out, ref) -> dict:
    return {"mask_bytes_differing": float((out != ref).sum())}


def launches():
    from zignal_tpu_torch.ops import filter_chain

    return filter_chain.LAUNCHES
