"""The orb_stereo deployment's adapter: one request takes ``B`` grayscale
u8 frames ``[B, rows, cols]``, ``B / 2`` stereo pairs laid ``[L0, R0, L1,
R1, ...]``, runs ORB on all of them (``Orb.detect_and_compute_tensors``)
and matches each left frame's descriptors with its right frame's
(``features.matcher.match_tensors``, cross-checked), and returns the
keypoints, descriptors, validity and matches, all on the card. Checked
against ``reference/orb_stereo.py`` (``compare`` there): the keypoints
that differ, the descriptor bits and angles of the keypoints both hold,
and the matches, which must equal the reference matcher's on the
program's own descriptors."""

from __future__ import annotations

from benchmarks import roofline_features
from benchmarks.reference import orb_stereo as _reference

compare = _reference.compare


def input_shape(cfg, batch: int) -> tuple:
    return (batch, cfg["rows"], cfg["cols"])


def pixels(cfg, batch: int) -> int:
    return batch * cfg["rows"] * cfg["cols"]


def bound_ms(cfg, batch: int) -> float:
    """The request's least time (``features_roofline``)."""
    return roofline_features.request_bound(
        batch, cfg["rows"], cfg["cols"], cfg["n_features"],
        cfg["scale_factor"], cfg["n_levels"])[0]


def _orb(cfg):
    from zignal_tpu_torch.features import Orb

    return Orb(n_features=cfg["n_features"], scale_factor=cfg["scale_factor"],
               n_levels=cfg["n_levels"], edge_threshold=cfg["edge_threshold"],
               fast_threshold=cfg["fast_threshold"])


def run_device(cfg, x, span):
    from zignal_tpu_torch.features.matcher import match_tensors

    orb = _orb(cfg)
    with span("launch"):
        kps, desc, valid = orb.detect_and_compute_tensors(x)
        return kps, desc, valid, match_tensors(
            desc[0::2], valid[0::2], desc[1::2], valid[1::2],
            cross_check=cfg["cross_check"])


def reference(cfg, x, control: bool = False):
    """Frame by frame, Harris and the angle in float64; the control
    computes them in bfloat16."""
    import torch

    return _reference.orb_stereo(x, cfg, torch.bfloat16 if control
                                 else torch.float64)


def launches():
    """K1's and K4's launches so far: the pyramid's resizes and blur."""
    from zignal_tpu_torch.ops import fused_pipeline, separable_conv

    return fused_pipeline.LAUNCHES + separable_conv.LAUNCHES
