"""Geometry: transform solvers and convex hull
(reference: src/geometry/).

Copied from zignal_tpu/geometry/: host numpy, no device code.
"""

from .convex_hull import ConvexHull
from .transforms import AffineTransform, ProjectiveTransform, SimilarityTransform

__all__ = [
    "SimilarityTransform", "AffineTransform", "ProjectiveTransform", "ConvexHull",
]
