"""Hough line transform (reference: src/image/hough.zig), the counterpart
of zignal_tpu/ops/hough.py.

Voting runs on the edge planes' device, for a whole batch at once. On a
card it is one call of the vote kernel (ops/hough_kernels.py), with no
host wait. The plain route, which a CPU tensor takes, resizes the planes
NEAREST, then every edge pixel of every frame votes at (rho_bin, theta)
for all theta, a chunk of thetas at a time (so the index tensors stay
bounded), as int32 ones added at ``frame * size^2 + rho_bin * size +
theta`` of one flat accumulator, a rho outside the accumulator sent to a
dump slot that is dropped: exact counts in any order, with one host wait
for the edge list. The fixed-point rho math replicates the reference's
16.16 tables exactly: ``rho = x * cos + y * sin`` in int32, exact for
``size <= 2048`` (``|rho| < 2^31``).

``find_lines_tensors`` finds each frame's lines on the device, equal to
the first ``max_lines`` of ``find_lines``, the host copy of the JAX
package's code: on a card the lines kernel, with no host wait; a CPU
accumulator takes ``find_lines``' own peaks and greedy pass. While a
profiler session runs, ``lines_batch`` records the span ``hough`` around
both, with ``hough.resize``, ``hough.vote`` and ``hough.peaks`` inside.
``FRAMES`` counts the frames voted on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..enums import Interpolation
from ..profiling import RECORDER, span_start
from ._build import COUNT_LOCK, cached
from .interpolation import resize

__all__ = ["HoughTransform", "HoughLine"]

_VOTES = 1 << 25  # rho indices a chunk of thetas
# frames voted on a CUDA device, under COUNT_LOCK
FRAMES = 0


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


def _device_tables(size: int, device):
    """int32 cos and sin tables and the int64 thetas on ``device``."""
    cos_t, sin_t, _, _ = _tables(size)
    return (torch.from_numpy(cos_t.astype(np.int32)).to(device),
            torch.from_numpy(sin_t.astype(np.int32)).to(device),
            torch.arange(size, dtype=torch.int64, device=device))


def _vote(planes, size: int):
    """Edges ``[B, size, size]`` (> 0 is an edge) -> int32 ``[B, size,
    size]`` accumulators ``[rho, theta]`` on the planes' device."""
    b, dev = planes.shape[0], planes.device
    cos_j, sin_j, theta = cached(_device_tables, size, dev)
    offset = _tables(size)[2]
    fs, ys, xs = torch.nonzero(planes > 0, as_tuple=True)  # a host wait
    base = (fs * (size * size))[None, :]                   # [1, N]
    yv = (2 * ys.to(torch.int32) - (size - 1))[None, :]
    xv = (2 * xs.to(torch.int32) - (size - 1))[None, :]
    dump = b * size * size
    acc = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    n = xv.shape[1]
    step = max(1, _VOTES // max(1, n))
    ones = torch.ones(1, dtype=torch.int32, device=dev).expand(
        min(step, size) * n)
    for t0 in range(0, size, step):
        t1 = min(size, t0 + step)
        rho = xv * cos_j[t0:t1, None] + yv * sin_j[t0:t1, None]  # [T, N]
        rr = ((rho >> 1) + (offset << 1)) >> 16
        valid = (rr >= 0) & (rr < size)
        idx = torch.where(valid, base + rr * size + theta[t0:t1, None], dump)
        acc.index_add_(0, idx.view(-1), ones[:idx.numel()])
    return acc[:dump].view(b, size, size)


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
        return self.compute_batch(plane[None])[0].to("cpu").numpy()

    def compute_batch(self, planes):
        """u8 edge planes ``[B, H, W]`` on their device (> 0 is an edge),
        each resized NEAREST to size x size -> int32 accumulators ``[B,
        size, size]`` ``[rho, theta]`` on that device; the votes of all
        frames are cast together. On a card the vote kernel
        (ops/hough_kernels.py) reads the planes through the NEAREST
        tables, with no host wait; the plain route waits once for the
        edge list."""
        global FRAMES
        if not isinstance(planes, torch.Tensor) or planes.ndim != 3:
            raise ValueError("compute_batch takes [B, H, W] edge planes")
        t0 = span_start()
        if planes.device.type == "cuda":
            from . import hough_kernels

            if planes.dtype != torch.uint8:
                planes = (planes > 0).to(torch.uint8)
            cos_j, sin_j, _ = cached(_device_tables, self.size, planes.device)
            t1 = t0 and RECORDER.add("hough.resize", t0)
            _, _, offset, even = _tables(self.size)
            acc = hough_kernels.vote(planes, self.size, cos_j, sin_j, offset,
                                     even)
            with COUNT_LOCK:
                FRAMES += planes.shape[0]
        else:
            if tuple(planes.shape[1:]) != (self.size, self.size):
                planes = resize(planes[..., None], self.size, self.size,
                                Interpolation.NEAREST)[..., 0]
            t1 = t0 and RECORDER.add("hough.resize", t0)
            acc = _vote(planes, self.size)
        if t1:
            RECORDER.add("hough.vote", t1)
        return acc

    def find_lines_tensors(self, accumulator, threshold: int = 100,
                           angle_nms_thresh: float = 5.0,
                           radius_nms_thresh: float = 10.0,
                           max_lines: int = 32):
        """Each frame's lines of int32 accumulators ``[B, size, size]`` on
        their device -> (int32 ``[B, max_lines, 3]`` rows (rho bin, theta
        bin, score), bool ``[B, max_lines]`` validity), on that device: a
        frame's valid rows are the first ``max_lines`` lines of
        ``find_lines`` of its accumulator, in its order (the same 3x3
        interior peaks, ordered by (score, r, c) descending, kept
        greedily), the rest zero and not valid."""
        acc = accumulator
        if not isinstance(acc, torch.Tensor) or acc.ndim != 3 or \
                tuple(acc.shape[1:]) != (self.size, self.size):
            raise ValueError("find_lines_tensors takes [B, size, size] "
                             "accumulators")
        if max_lines < 0:
            raise ValueError("max_lines must be >= 0")
        t0 = span_start()
        b, n, dev = acc.shape[0], self.size, acc.device
        if dev.type == "cuda" and n >= 3:
            from . import hough_kernels

            found = hough_kernels.lines(acc, threshold, angle_nms_thresh,
                                        radius_nms_thresh, max_lines,
                                        self.even_size)
        else:  # no interior bin on a card is no line
            rows = np.zeros((b, max_lines, 3), np.int32)
            valid = np.zeros((b, max_lines), bool)
            if n >= 3:
                host = acc.numpy()
                for f in range(b):
                    kept = self._kept(host[f], threshold, angle_nms_thresh,
                                      radius_nms_thresh, max_lines)[0]
                    rows[f, :len(kept)] = kept
                    valid[f, :len(kept)] = True
            found = (torch.from_numpy(rows).to(dev),
                     torch.from_numpy(valid).to(dev))
        if t0:
            RECORDER.add("hough.peaks", t0)
        return found

    def lines_batch(self, planes, threshold: int = 100,
                    angle_nms_thresh: float = 5.0,
                    radius_nms_thresh: float = 10.0, max_lines: int = 32):
        """``compute_batch`` then ``find_lines_tensors`` of its
        accumulators -> (accumulators, rows, validity), on the planes'
        device; during a profiler session the recorder's span ``hough``."""
        t0 = span_start()
        d0 = t0 and RECORDER.mark(planes)
        acc = self.compute_batch(planes)
        rows, valid = self.find_lines_tensors(
            acc, threshold, angle_nms_thresh, radius_nms_thresh, max_lines)
        if t0:
            RECORDER.add("hough", t0)
            d0 and RECORDER.add_device("hough", d0, planes)
        return acc, rows, valid

    def find_lines(self, accumulator: np.ndarray, threshold: int = 100,
                   angle_nms_thresh: float = 5.0,
                   radius_nms_thresh: float = 10.0) -> list:
        """Local-max peaks + neighborhood suppression
        (reference: hough.zig findLines:142)."""
        rows, angles, radii = self._kept(
            np.asarray(accumulator), threshold, angle_nms_thresh,
            radius_nms_thresh)
        return [self._make_line(float(a), float(r), int(score))
                for a, r, score in zip(angles, radii, rows[:, 2])]

    def _kept(self, acc, threshold, angle_thr, radius_thr, limit=None):
        """``find_lines``' lines of the host accumulator ``acc``, at most
        ``limit``: (int64 rows (rho bin, theta bin, score), f64 angles,
        f64 radii). The interior 3x3 peaks that reach ``threshold``, in
        (score, r, c) descending order, each kept where no line kept
        before lies within both ``angle_thr`` and ``radius_thr``."""
        n = self.size
        none = (np.zeros((0, 3), np.int64), np.zeros(0), np.zeros(0))
        if n < 3 or limit == 0:
            return none
        interior = acc[1:-1, 1:-1]
        win_max = np.stack([
            acc[1 + dr:n - 1 + dr, 1 + dc:n - 1 + dc]
            for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr, dc) != (0, 0)
        ]).max(axis=0)
        pr, pc = np.nonzero((interior >= threshold) & (interior >= win_max))
        if len(pr) == 0:
            return none
        scores = interior[pr, pc].astype(np.int64)
        rr = pr + 1
        cc = pc + 1
        # same ordering as sorting (score, r, c) tuples descending
        order = np.lexsort((-cc, -rr, -scores))
        scores, rr, cc = scores[order], rr[order], cc[order]
        angles = cc * (180.0 / self.even_size) - 90.0
        radii = (rr - self.even_size / 2.0) * math.sqrt(2.0)
        kept = []
        acc_a = np.empty(len(scores))
        acc_r = np.empty(len(scores))
        for i in range(len(scores)):
            m = len(kept)
            if m and np.any((np.abs(angles[i] - acc_a[:m]) < angle_thr)
                            & (np.abs(radii[i] - acc_r[:m]) < radius_thr)):
                continue
            acc_a[m] = angles[i]
            acc_r[m] = radii[i]
            kept.append(i)
            if len(kept) == limit:
                break
        k = np.asarray(kept, np.int64)
        return np.stack((rr[k], cc[k], scores[k]), -1), angles[k], radii[k]

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
