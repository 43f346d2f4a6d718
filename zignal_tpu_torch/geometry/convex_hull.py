"""Convex hull via Andrew's monotone chain
(reference: src/geometry/ConvexHull.zig).

Copied from zignal_tpu/geometry/convex_hull.py.
"""

from __future__ import annotations

from ..rectangle import Rectangle

__all__ = ["ConvexHull"]


def _cross(o, a, b):
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


class ConvexHull:
    """Stateful hull finder: `find` computes and stores the hull,
    `get_rectangle` returns the last hull's bounding box."""

    __slots__ = ("_hull",)

    def __init__(self):
        self._hull = None

    def find(self, points):
        """Hull vertices in counter-clockwise order, or None when fewer
        than 3 non-collinear points are given."""
        if isinstance(points, (str, bytes)) or not hasattr(points, "__iter__"):
            raise TypeError("find() expects a sequence of (x, y) points")
        try:
            pts = sorted({(float(p[0]), float(p[1])) for p in points})
        except (TypeError, IndexError) as e:
            raise TypeError("find() expects a sequence of (x, y) points") from e
        self._hull = None
        if len(pts) < 3:
            return None
        lower = []
        for p in pts:
            while len(lower) >= 2 and _cross(lower[-2], lower[-1], p) <= 0:
                lower.pop()
            lower.append(p)
        upper = []
        for p in reversed(pts):
            while len(upper) >= 2 and _cross(upper[-2], upper[-1], p) <= 0:
                upper.pop()
            upper.append(p)
        hull = lower[:-1] + upper[:-1]
        if len(hull) < 3:
            return None
        self._hull = hull
        return list(hull)

    def contains(self, point):
        """True if the point lies inside (or on) the last computed hull."""
        if self._hull is None:
            return False
        x, y = float(point[0]), float(point[1])
        n = len(self._hull)
        for i in range(n):
            if _cross(self._hull[i], self._hull[(i + 1) % n], (x, y)) < 0:
                return False
        return True

    def get_rectangle(self):
        if self._hull is None:
            return None
        xs = [p[0] for p in self._hull]
        ys = [p[1] for p in self._hull]
        return Rectangle(min(xs), min(ys), max(xs), max(ys))

    def __repr__(self):
        return "ConvexHull()"
