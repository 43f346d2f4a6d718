"""Edge tracer: raster edges -> polylines via neighbor chaining +
Ramer-Douglas-Peucker simplification (reference: src/features/Tracer.zig).

Copied from zignal_tpu/features/tracer.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Tracer"]

_NEIGHBORS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _rdp(points, epsilon: float):
    """Ramer-Douglas-Peucker polyline simplification."""
    if len(points) < 3:
        return list(points)
    p0 = np.asarray(points[0], dtype=np.float64)
    p1 = np.asarray(points[-1], dtype=np.float64)
    pts = np.asarray(points, dtype=np.float64)
    d = p1 - p0
    norm = np.hypot(*d)
    if norm == 0:
        dists = np.hypot(*(pts - p0).T)
    else:
        dists = np.abs(d[0] * (p0[1] - pts[:, 1]) - d[1] * (p0[0] - pts[:, 0])) / norm
    idx = int(np.argmax(dists))
    if dists[idx] > epsilon:
        left = _rdp(points[: idx + 1], epsilon)
        right = _rdp(points[idx:], epsilon)
        return left[:-1] + right
    return [points[0], points[-1]]


@dataclasses.dataclass
class Tracer:
    """Trace binary edge maps into simplified polylines
    (reference: Tracer.zig:17-46)."""

    simplify_epsilon: float = 1.5
    min_length: int = 8

    def trace(self, edges) -> list:
        """edges: Image or [H, W] binary array -> list of polylines,
        each a list of (x, y) tuples."""
        from ..image import Image

        if isinstance(edges, Image):
            arr = edges._host()[..., 0]
        else:
            arr = np.asarray(edges)
            if arr.ndim == 3:
                arr = arr[..., 0]
        remaining = arr > 0
        h, w = remaining.shape
        polylines = []

        ys, xs = np.nonzero(remaining)
        for y0, x0 in zip(ys, xs):
            if not remaining[y0, x0]:
                continue
            # walk in one direction, then the other
            chain = [(int(x0), int(y0))]
            remaining[y0, x0] = False
            for _direction in range(2):
                cy, cx = y0, x0
                while True:
                    found = None
                    for dy, dx in _NEIGHBORS:
                        ny, nx = cy + dy, cx + dx
                        if 0 <= ny < h and 0 <= nx < w and remaining[ny, nx]:
                            found = (ny, nx)
                            break
                    if found is None:
                        break
                    cy, cx = found
                    remaining[cy, cx] = False
                    if _direction == 0:
                        chain.append((cx, cy))
                    else:
                        chain.insert(0, (cx, cy))
            if len(chain) >= self.min_length:
                simplified = _rdp(chain, self.simplify_epsilon)
                polylines.append([(float(x), float(y)) for x, y in simplified])
        return polylines
