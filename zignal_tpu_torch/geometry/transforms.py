"""2-D geometric transform solvers (reference: src/geometry/transforms.zig).

Solved on host in f64 numpy (these are tiny dense problems); `project`
accepts a point or a list of points. The 3x3 homogeneous matrix feeds the
device warp (ops/warp.py).

Copied from zignal_tpu/geometry/transforms.py (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SimilarityTransform", "AffineTransform", "ProjectiveTransform"]


def _as_points(pts) -> np.ndarray:
    try:
        arr = np.asarray(
            [(float(p[0]), float(p[1])) for p in pts], dtype=np.float64
        )
    except (TypeError, IndexError) as e:
        raise TypeError("expected a sequence of (x, y) points") from e
    return arr


def _collinear(pts: np.ndarray) -> bool:
    if len(pts) < 3:
        return True
    p0 = pts[0]
    d = pts[1:] - p0
    cross = d[:, 0][:, None] * d[:, 1][None, :] - d[:, 1][:, None] * d[:, 0][None, :]
    return bool(np.all(np.abs(cross) < 1e-12))


class _Transform2D:
    """Common base: 2x2 matrix + bias, projecting (x, y) points."""

    __slots__ = ("matrix", "bias")

    def __init__(self):
        self.matrix = np.eye(2)
        self.bias = np.zeros(2)

    def project(self, point):
        if isinstance(point, (list, np.ndarray)) and len(point) and (
            isinstance(point[0], (tuple, list, np.ndarray))
        ):
            return [self.project(p) for p in point]
        p = np.asarray([float(point[0]), float(point[1])])
        out = self.matrix @ p + self.bias
        return (float(out[0]), float(out[1]))

    def homogeneous(self) -> np.ndarray:
        """3x3 matrix mapping (x, y, 1)."""
        m = np.eye(3)
        m[:2, :2] = self.matrix
        m[:2, 2] = self.bias
        return m

    def __repr__(self):
        return (f"{type(self).__name__}(matrix={self.matrix.tolist()}, "
                f"bias={self.bias.tolist()})")


class SimilarityTransform(_Transform2D):
    """Least-squares similarity fit (Umeyama; reference:
    geometry/transforms.zig:10-115)."""

    def __init__(self, from_points=None, to_points=None):
        super().__init__()
        if from_points is not None:
            self.find(from_points, to_points)

    def find(self, from_points, to_points):
        f = _as_points(from_points)
        t = _as_points(to_points)
        if len(f) < 2 or len(f) != len(t):
            raise ValueError("need at least 2 matching point pairs")
        n = len(f)
        mean_f = f.mean(axis=0)
        mean_t = t.mean(axis=0)
        fc = f - mean_f
        tc = t - mean_t
        sigma_from = (fc**2).sum() / n
        cov = (tc.T @ fc) / n
        det_cov = np.linalg.det(cov)
        u, s, vt = np.linalg.svd(cov)
        tol = s[0] * np.finfo(np.float64).eps * 2
        if np.sum(s > tol) == 0:
            raise ValueError("transform is rank deficient")
        d = np.eye(2)
        if det_cov < 0 or (det_cov == 0 and np.linalg.det(u) * np.linalg.det(vt.T) < 0):
            if s[1] < s[0]:
                d[1, 1] = -1
            else:
                d[0, 0] = -1
        r = u @ d @ vt
        c = 1.0
        if sigma_from != 0:
            c = (s * np.diag(d)).sum() / sigma_from
        self.matrix = c * r
        self.bias = mean_t - c * (r @ mean_f)


class AffineTransform(_Transform2D):
    """Least-squares affine fit via pseudo-inverse (reference:
    geometry/transforms.zig:118-194)."""

    def __init__(self, from_points=None, to_points=None):
        super().__init__()
        if from_points is not None:
            self.find(from_points, to_points)

    def find(self, from_points, to_points):
        f = _as_points(from_points)
        t = _as_points(to_points)
        if len(f) < 3 or len(f) != len(t):
            raise ValueError("need at least 3 matching point pairs")
        p = np.vstack([f.T, np.ones(len(f))])  # 3 x n
        q = t.T  # 2 x n
        if np.linalg.matrix_rank(p) < 3:
            raise ValueError("transform is rank deficient")
        m = q @ np.linalg.pinv(p)
        self.matrix = m[:, :2]
        self.bias = m[:, 2]


class ProjectiveTransform:
    """Homography from >= 4 correspondences (reference:
    geometry/transforms.zig:197-292). Exactly 4 points are solved
    exactly; more use the DLT nullspace via SVD."""

    __slots__ = ("matrix",)

    def __init__(self, from_points=None, to_points=None):
        self.matrix = np.eye(3)
        if from_points is not None:
            self.find(from_points, to_points)

    def find(self, from_points, to_points):
        f = _as_points(from_points)
        t = _as_points(to_points)
        if len(f) < 4 or len(f) != len(t):
            raise ValueError("need at least 4 matching point pairs")
        if _collinear(f) or _collinear(t):
            raise ValueError("transform is rank deficient")
        if len(f) == 4:
            a = np.zeros((8, 8))
            b = np.zeros(8)
            for i, ((fx, fy), (tx, ty)) in enumerate(zip(f, t)):
                a[2 * i] = [fx, fy, 1, 0, 0, 0, -tx * fx, -tx * fy]
                a[2 * i + 1] = [0, 0, 0, fx, fy, 1, -ty * fx, -ty * fy]
                b[2 * i] = tx
                b[2 * i + 1] = ty
            try:
                h = np.linalg.solve(a, b)
            except np.linalg.LinAlgError as e:
                raise ValueError("transform is rank deficient") from e
            self.matrix = np.array([
                [h[0], h[1], h[2]],
                [h[3], h[4], h[5]],
                [h[6], h[7], 1.0],
            ])
            return
        # DLT: smallest singular vector of the stacked constraint matrix
        rows = []
        for (fx, fy), (tx, ty) in zip(f, t):
            rows.append([fx, fy, 1, 0, 0, 0, -tx * fx, -tx * fy, -tx])
            rows.append([0, 0, 0, fx, fy, 1, -ty * fx, -ty * fy, -ty])
        a = np.asarray(rows)
        _, _, vt = np.linalg.svd(a)
        self.matrix = vt[-1].reshape(3, 3)

    def project(self, point):
        if isinstance(point, (list, np.ndarray)) and len(point) and (
            isinstance(point[0], (tuple, list, np.ndarray))
        ):
            return [self.project(p) for p in point]
        p = np.asarray([float(point[0]), float(point[1]), 1.0])
        out = self.matrix @ p
        if out[2] != 0:
            out = out / out[2]
        return (float(out[0]), float(out[1]))

    def inverse(self):
        try:
            m = np.linalg.inv(self.matrix)
        except np.linalg.LinAlgError:
            return None
        t = ProjectiveTransform()
        t.matrix = m
        return t

    def homogeneous(self) -> np.ndarray:
        return self.matrix

    def __repr__(self):
        return f"ProjectiveTransform(matrix={self.matrix.tolist()})"
