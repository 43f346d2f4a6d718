"""FAST corner detector (reference: src/features/Fast.zig), the counterpart
of zignal_tpu/features/fast.py.

The 16 Bresenham-circle taps are shifted copies of the plane, read by one
gather, and the contiguous-arc test runs as bitmask shift/AND reductions
on a per-pixel 16-bit mask (log-step run detection): integer torch ops
on the plane's device, on ``[..., H, W]`` (leading dims are a batch of
planes). The shifts wrap around, as the JAX package's ``jnp.roll``: the
3-pixel border mask and the non-maximum suppression rely on exactly that
wrap. Planes of 6 px or fewer have an empty interior.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..image import plane_of

__all__ = ["KeyPoint", "Fast"]

# Bresenham circle radius 3, clockwise from 12 o'clock: (dx, dy)
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


@dataclasses.dataclass
class KeyPoint:
    """Detected feature point (reference: src/features/KeyPoint.zig)."""

    x: float
    y: float
    size: float = 7.0
    angle: float = -1.0
    response: float = 0.0
    octave: int = 0
    class_id: int = -1

    def distance_squared(self, other: "KeyPoint") -> float:
        return (self.x - other.x) ** 2 + (self.y - other.y) ** 2


def _shifted(a, offsets):
    """``[..., K, H, W]``: plane ``k`` is ``a`` read at ``[r + dy, c + dx]``
    for the k-th ``(dx, dy)`` of ``offsets``, wrapping around (one gather
    for all K)."""
    h, w = a.shape[-2:]
    dev = a.device
    dx = torch.tensor([o[0] for o in offsets], device=dev)
    dy = torch.tensor([o[1] for o in offsets], device=dev)
    rows = (torch.arange(h, device=dev)[None, :, None] + dy[:, None, None]) % h
    cols = (torch.arange(w, device=dev)[None, None, :] + dx[:, None, None]) % w
    return a[..., rows, cols]


_BITS = tuple(1 << i for i in range(16))
# the NMS neighbourhood: distance < 5, the centre left out
_NEAR = tuple((dx, dy) for dy in range(-4, 5) for dx in range(-4, 5)
              if (dx, dy) != (0, 0) and dx * dx + dy * dy < 25)


def _has_run(mask16, min_run: int):
    """Per-pixel: does the circular 16-bit mask contain a run >= min_run?
    Wraparound handled by doubling the mask to 32 bits (in int64, so the
    shifts stay logical)."""
    m = mask16.to(torch.int64)
    m = m | (m << 16)
    run = 1
    r = m
    for step in (1, 2, 4, 8):
        if run + step <= min_run:
            r = r & (r >> step)
            run += step
    while run < min_run:
        r = r & (r >> 1)
        run += 1
    return r != 0


def fast_response_map(gray_u8, threshold: int = 20, min_contiguous: int = 9):
    """u8 ``[..., H, W]`` -> int32 ``[..., H, W]`` corner scores (0 = not a
    corner), on the plane's device."""
    a = gray_u8.to(torch.int32)
    h, w = a.shape[-2:]
    bright_thr = torch.clamp_max(a + threshold, 255)[..., None, :, :]
    dark_thr = torch.clamp_min(a - threshold, 0)[..., None, :, :]
    px = _shifted(a, CIRCLE_OFFSETS)                  # [..., 16, H, W]
    bits = torch.tensor(_BITS, dtype=torch.int32,
                        device=a.device)[:, None, None]
    # distinct bits: their sum is their OR
    bright_mask = ((px > bright_thr) * bits).sum(-3, dtype=torch.int32)
    dark_mask = ((px < dark_thr) * bits).sum(-3, dtype=torch.int32)
    diff = torch.abs(px - a[..., None, :, :])
    score = torch.where(diff > threshold, diff, 0).sum(-3, dtype=torch.int32)

    corner = _has_run(bright_mask, min_contiguous) | \
        _has_run(dark_mask, min_contiguous)
    # exclude the 3-pixel border (the shifts wrap around)
    border = torch.zeros((h, w), dtype=torch.bool, device=a.device)
    border[3:h - 3, 3:w - 3] = True
    return torch.where(corner & border, score, 0)


def _nms_device(scores):
    """Keep pixels whose score is not exceeded within distance < 5
    (reference suppressNonMaximal: dist^2 < 25, strictly greater wins)."""
    best = torch.maximum(scores, _shifted(scores, _NEAR).amax(-3))
    return (scores > 0) & (scores >= best)


@dataclasses.dataclass
class Fast:
    """FAST-9/12 detector (reference: Fast.zig:16-24 options)."""

    threshold: int = 20
    nonmax_suppression: bool = True
    min_contiguous: int = 9

    def detect(self, image, *, device=None) -> list:
        """Detect corners in an Image, a u8 ``[H, W]`` tensor or a numpy
        array (which names its ``device=``)."""
        plane = plane_of(image, device)
        scores = fast_response_map(plane, self.threshold, self.min_contiguous)
        if self.nonmax_suppression:
            scores = torch.where(_nms_device(scores), scores, 0)
        s = scores.to("cpu").numpy()
        ys, xs = np.nonzero(s)
        return [
            KeyPoint(x=float(x), y=float(y), size=7.0, angle=-1.0,
                     response=float(s[y, x]), octave=0)
            for y, x in zip(ys, xs)
        ]
