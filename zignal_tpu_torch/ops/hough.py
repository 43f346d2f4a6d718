"""Hough line transform (reference: src/image/hough.zig), the counterpart
of zignal_tpu/ops/hough.py.

Voting runs on the edge plane's device: every edge pixel votes at
(rho_bin, theta) for all theta, as one ``torch.bincount`` over
``rho_bin * size + theta`` a chunk of thetas (so the index tensor stays
bounded), exact int32 counts. The fixed-point rho math replicates the
reference's 16.16 tables exactly: ``rho = x * cos + y * sin`` in int32,
exact for ``size <= 2048`` (``|rho| < 2^31``). ``find_lines`` and the
line geometry are host copies of the JAX package's code.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..enums import Interpolation
from .interpolation import resize

__all__ = ["HoughTransform", "HoughLine"]

_VOTES = 1 << 24  # rho indices a chunk of thetas


@dataclasses.dataclass
class HoughLine:
    angle: float          # degrees; 0 horizontal, +-90 vertical
    radius: float         # distance from image center
    score: int            # votes
    p1: tuple             # start point clipped to bounds
    p2: tuple             # end point


def _tables(size: int):
    even = size if size % 2 == 0 else size - 1
    t = np.arange(size, dtype=np.float64)
    theta = t * np.pi / even
    scale = 1 << 16
    cos_t = np.trunc(scale * np.cos(theta) / np.sqrt(2.0)).astype(np.int64)
    sin_t = np.trunc(scale * np.sin(theta) / np.sqrt(2.0)).astype(np.int64)
    offset = int(round(scale * even / 4.0))
    return cos_t, sin_t, offset, even


def _accumulate(edge_plane, size: int):
    """u8 ``[size, size]`` edges -> int32 ``[size, size]`` accumulator
    ``[rho, theta]`` on the plane's device."""
    cos_t, sin_t, offset, _ = _tables(size)
    dev = edge_plane.device
    ys, xs = torch.nonzero(edge_plane > 0, as_tuple=True)
    yv = (2 * ys.to(torch.int32) - (size - 1))[None, :]      # [1, N]
    xv = (2 * xs.to(torch.int32) - (size - 1))[None, :]
    cos_j = torch.from_numpy(cos_t.astype(np.int32)).to(dev)
    sin_j = torch.from_numpy(sin_t.astype(np.int32)).to(dev)
    theta = torch.arange(size, dtype=torch.int64, device=dev)
    acc = torch.zeros(size * size, dtype=torch.int64, device=dev)
    step = max(1, _VOTES // max(1, xv.shape[1]))
    for t0 in range(0, size, step):
        t1 = min(size, t0 + step)
        rho = xv * cos_j[t0:t1, None] + yv * sin_j[t0:t1, None]  # [T, N]
        rr = ((rho >> 1) + (offset << 1)) >> 16
        valid = (rr >= 0) & (rr < size)
        idx = rr.to(torch.int64) * size + theta[t0:t1, None]
        acc += torch.bincount(idx[valid], minlength=size * size)
    return acc.reshape(size, size).to(torch.int32)


class HoughTransform:
    """Line detection over a size x size region (reference: hough.zig:11)."""

    def __init__(self, size: int = 256):
        if size <= 1:
            raise ValueError("size must be > 1")
        self.size = size
        _, _, _, self.even_size = _tables(size)

    def compute(self, edges, *, device=None) -> np.ndarray:
        """Edge image (an Image or a u8 ``[H, W]`` tensor, on its device,
        or a numpy array on ``device=``; resized NEAREST to size x size)
        -> host accumulator [size, size]."""
        from ..image import plane_of

        plane = plane_of(edges, device)
        if tuple(plane.shape) != (self.size, self.size):
            plane = resize(plane[..., None], self.size, self.size,
                           Interpolation.NEAREST)[..., 0]
        return _accumulate(plane, self.size).to("cpu").numpy()

    def find_lines(self, accumulator: np.ndarray, threshold: int = 100,
                   angle_nms_thresh: float = 5.0,
                   radius_nms_thresh: float = 10.0) -> list:
        """Local-max peaks + neighborhood suppression
        (reference: hough.zig findLines:142)."""
        acc = np.asarray(accumulator)
        n = self.size
        interior = acc[1:-1, 1:-1]
        win_max = np.stack([
            acc[1 + dr:n - 1 + dr, 1 + dc:n - 1 + dc]
            for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr, dc) != (0, 0)
        ]).max(axis=0)
        pr, pc = np.nonzero((interior >= threshold) & (interior >= win_max))
        if len(pr) == 0:
            return []
        scores = interior[pr, pc].astype(np.int64)
        rr = pr + 1
        cc = pc + 1
        # same ordering as sorting (score, r, c) tuples descending
        order = np.lexsort((-cc, -rr, -scores))
        scores, rr, cc = scores[order], rr[order], cc[order]
        angles = cc * (180.0 / self.even_size) - 90.0
        radii = (rr - self.even_size / 2.0) * math.sqrt(2.0)
        lines = []
        acc_a = np.empty(len(scores))
        acc_r = np.empty(len(scores))
        for i in range(len(scores)):
            n_acc = len(lines)
            if n_acc and np.any(
                    (np.abs(angles[i] - acc_a[:n_acc]) < angle_nms_thresh)
                    & (np.abs(radii[i] - acc_r[:n_acc]) < radius_nms_thresh)):
                continue
            acc_a[n_acc] = angles[i]
            acc_r[n_acc] = radii[i]
            lines.append(self._make_line(float(angles[i]), float(radii[i]),
                                         int(scores[i])))
        return lines

    def _line_properties(self, c: float, r: float):
        theta = c * 180.0 / self.even_size
        radius = (r - self.even_size / 2.0) * math.sqrt(2.0)
        return theta - 90.0, radius

    def _make_line(self, angle: float, radius: float, score: int) -> HoughLine:
        n = float(self.size)
        cx = cy = n / 2.0
        theta = math.radians(angle + 90.0)
        ct, st = math.cos(theta), math.sin(theta)
        x0 = cx + radius * ct
        y0 = cy + radius * st
        # direction along the line
        dx, dy = -st, ct
        pts = []
        for t in (-2 * n, 2 * n):
            pts.append((x0 + t * dx, y0 + t * dy))
        clipped = [(min(max(p[0], 0.0), n - 1), min(max(p[1], 0.0), n - 1))
                   for p in pts]
        return HoughLine(angle, radius, score, clipped[0], clipped[1])
