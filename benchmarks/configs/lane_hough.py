"""The lane_hough deployment's adapter: one request takes ``B`` grayscale
u8 frames ``[B, rows, cols]`` of a drive, runs Canny on all of them
(``ops.edges.canny``, the function ``ImageBatch.canny`` calls), then the
Hough transform of the edges and each frame's lines
(``HoughTransform.lines_batch``: ``compute_batch`` and
``find_lines_tensors``), and returns the edges, the accumulators, the line
rows and their validity, all on the card. Checked against
``reference/lane_hough.py`` (``compare`` there): the edge pixels that
differ from the reference's Canny, the accumulators against the
reference's votes over the program's own edges, and the lines against the
reference's findLines of the program's own accumulators."""

from __future__ import annotations

from benchmarks import roofline_edges
from benchmarks.reference import lane_hough as _reference

compare = _reference.compare
_HOUGH = {}


def input_shape(cfg, batch: int) -> tuple:
    return (batch, cfg["rows"], cfg["cols"])


def pixels(cfg, batch: int) -> int:
    return batch * cfg["rows"] * cfg["cols"]


def bound_ms(cfg, batch: int) -> float:
    """The request's least time (``edges_roofline``)."""
    return roofline_edges.request_bound(batch, cfg["rows"], cfg["cols"],
                                        cfg["hough_size"])[0]


def _hough(size: int):
    if size not in _HOUGH:
        from zignal_tpu_torch.ops.hough import HoughTransform

        _HOUGH[size] = HoughTransform(size)
    return _HOUGH[size]


def run_device(cfg, x, span):
    import torch
    from zignal_tpu_torch.ops import edges

    hough = _hough(cfg["hough_size"])
    with span("launch"):
        e = edges.canny(x.to(torch.float32), cfg["sigma"], cfg["low"],
                        cfg["high"])
        acc, rows, valid = hough.lines_batch(
            e, cfg["threshold"], cfg["angle_nms"], cfg["radius_nms"],
            cfg["max_lines"])
        return e, acc, rows, valid


def reference(cfg, x, control: bool = False):
    """Frame by frame, the Gaussian, the gradients and the magnitude in
    float64; the control computes them in bfloat16."""
    import torch

    return _reference.lane_hough(x, cfg, torch.bfloat16 if control
                                 else torch.float64)


def launches():
    """The card path's count so far: the convergence tests run on a card
    (``edges.HYSTERESIS_TESTS``), the frames voted on a card
    (``hough.FRAMES``) and the calls of the Canny front, hysteresis, vote
    and lines kernels (``canny_front.LAUNCHES``, ``hysteresis.LAUNCHES``,
    ``hough_kernels.VOTE_LAUNCHES`` and ``.LINES_LAUNCHES``); 0 on the
    CPU. Each is read where the program has it."""
    import importlib

    total = 0
    for module, name in (("edges", "HYSTERESIS_TESTS"), ("hough", "FRAMES"),
                         ("canny_front", "LAUNCHES"),
                         ("hysteresis", "LAUNCHES"),
                         ("hough_kernels", "VOTE_LAUNCHES"),
                         ("hough_kernels", "LINES_LAUNCHES")):
        try:
            total += getattr(importlib.import_module(
                f"zignal_tpu_torch.ops.{module}"), name)
        except (ImportError, AttributeError):
            pass
    return total
