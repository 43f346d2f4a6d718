"""Rectangle (reference: src/geometry/Rectangle.zig; Python surface
bindings/python/src/rectangle.zig). Float (f64) backed, l/t/r/b with
right/bottom exclusive.

Copied from zignal_tpu/rectangle.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import math

__all__ = ["Rectangle"]


def _coerce(other):
    if isinstance(other, Rectangle):
        return other
    if isinstance(other, (tuple, list)) and len(other) == 4:
        return Rectangle(*other)
    raise TypeError("expected a Rectangle or a (left, top, right, bottom) tuple")


class Rectangle:
    """Axis-aligned rectangle; coordinates are floats, r/b exclusive."""

    __slots__ = ("left", "top", "right", "bottom")

    def __init__(self, left, top, right, bottom):
        if not (right >= left and bottom >= top):
            raise ValueError("Rectangle requires right >= left and bottom >= top")
        self.left = float(left)
        self.top = float(top)
        self.right = float(right)
        self.bottom = float(bottom)

    @classmethod
    def init_center(cls, x, y, width, height):
        if not (width > 0 and height > 0):
            raise ValueError("width and height must be positive")
        l = x - width / 2
        t = y - height / 2
        return cls(l, t, l + width, t + height)

    # -- properties ---------------------------------------------------------

    @property
    def width(self):
        return 0.0 if self.left >= self.right else self.right - self.left

    @property
    def height(self):
        return 0.0 if self.top >= self.bottom else self.bottom - self.top

    # -- predicates ---------------------------------------------------------

    def is_empty(self):
        return self.top >= self.bottom or self.left >= self.right

    def contains(self, x, y=None):
        if y is None:
            x, y = x
        if math.isnan(x) or math.isnan(y):
            return False
        return self.left <= x < self.right and self.top <= y < self.bottom

    def covers(self, other):
        other = _coerce(other)
        if self.is_empty():
            return False
        if other.is_empty():
            return True
        return (
            other.left >= self.left and other.top >= self.top
            and other.right <= self.right and other.bottom <= self.bottom
        )

    # -- measures -----------------------------------------------------------

    def area(self):
        return 0.0 if self.is_empty() else self.width * self.height

    def perimeter(self):
        return (self.width + self.height) * 2

    def diagonal(self):
        return math.hypot(self.width, self.height)

    def aspect_ratio(self):
        w, h = self.width, self.height
        if h == 0:
            return math.nan if w == 0 else math.inf
        return w / h

    # -- accessors ----------------------------------------------------------

    def center(self):
        return ((self.left + self.right) / 2, (self.top + self.bottom) / 2)

    def top_left(self):
        return (self.left, self.top)

    def top_right(self):
        return (self.right, self.top)

    def bottom_left(self):
        return (self.left, self.bottom)

    def bottom_right(self):
        return (self.right, self.bottom)

    # -- transforms ---------------------------------------------------------

    def reorder(self):
        return Rectangle(
            min(self.left, self.right), min(self.top, self.bottom),
            max(self.left, self.right), max(self.top, self.bottom),
        )

    def grow(self, amount):
        return Rectangle(
            self.left - amount, self.top - amount,
            self.right + amount, self.bottom + amount,
        )

    def shrink(self, amount):
        return Rectangle(
            self.left + amount, self.top + amount,
            self.right - amount, self.bottom - amount,
        )

    def translate(self, dx, dy):
        return Rectangle(self.left + dx, self.top + dy, self.right + dx, self.bottom + dy)

    def clip(self, bounds):
        bounds = _coerce(bounds)
        return Rectangle(
            max(self.left, bounds.left), max(self.top, bounds.top),
            min(self.right, bounds.right), min(self.bottom, bounds.bottom),
        )

    def intersect(self, other):
        other = _coerce(other)
        l = max(self.left, other.left)
        t = max(self.top, other.top)
        r = min(self.right, other.right)
        b = min(self.bottom, other.bottom)
        if l >= r or t >= b:
            return None
        return Rectangle(l, t, r, b)

    def merge(self, other):
        other = _coerce(other)
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return Rectangle(
            min(self.left, other.left), min(self.top, other.top),
            max(self.right, other.right), max(self.bottom, other.bottom),
        )

    # -- overlap metrics ----------------------------------------------------

    def iou(self, other):
        other = _coerce(other)
        inter = self.intersect(other)
        if inter is None:
            return 0.0
        ia = inter.area()
        union = self.area() + other.area() - ia
        return 0.0 if union == 0 else ia / union

    def overlaps(self, other, iou_thresh=0.5, coverage_thresh=1.0):
        other = _coerce(other)
        inter = self.intersect(other)
        if inter is None:
            return False
        ia = inter.area()
        sa, oa = self.area(), other.area()
        union = sa + oa - ia
        if union > 0 and ia / union > iou_thresh:
            return True
        if sa > 0 and ia / sa >= coverage_thresh:
            return True
        if oa > 0 and ia / oa >= coverage_thresh:
            return True
        return False

    def __repr__(self):
        return (
            f"Rectangle(left={self.left:g}, top={self.top:g}, "
            f"right={self.right:g}, bottom={self.bottom:g})"
        )

    def __eq__(self, other):
        if isinstance(other, Rectangle):
            return (self.left, self.top, self.right, self.bottom) == (
                other.left, other.top, other.right, other.bottom)
        return NotImplemented

    def __hash__(self):
        return hash((self.left, self.top, self.right, self.bottom))
