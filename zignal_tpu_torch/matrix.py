"""Matrix: runtime-shaped dense f64 matrix (reference: src/matrix/Matrix.zig).

Host numpy f64 backs the API for reference-grade precision (the
reference's Matrix is CPU f64). The image-scale statistics of PCA and
FDM run on torch on their input's device in their own modules; this
class is the general user-facing surface.

Copied from zignal_tpu/matrix.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Matrix"]


def _coerce_scalar(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


class Matrix:
    """Dense float64 matrix with zignal's call-for-call API."""

    __slots__ = ("_a",)

    def __init__(self, data=None):
        if data is None:
            self._a = np.zeros((0, 0))
            return
        if isinstance(data, Matrix):
            self._a = data._a.copy()
            return
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError("Matrix requires a 2-D nested sequence")
        self._a = arr.copy()

    # -- constructors -------------------------------------------------------

    @classmethod
    def _wrap(cls, arr) -> "Matrix":
        m = cls.__new__(cls)
        m._a = np.asarray(arr, dtype=np.float64)
        return m

    @classmethod
    def from_numpy(cls, arr) -> "Matrix":
        if not isinstance(arr, np.ndarray):
            raise TypeError("from_numpy expects a numpy.ndarray")
        if arr.dtype != np.float64:
            raise TypeError("from_numpy requires a float64 array")
        if arr.ndim != 2:
            raise ValueError("from_numpy requires a 2-D array")
        return cls._wrap(arr)  # borrowed, like Image.from_numpy

    @classmethod
    def full(cls, rows, cols, fill_value=0.0) -> "Matrix":
        return cls._wrap(np.full((int(rows), int(cols)), float(fill_value)))

    @classmethod
    def zeros(cls, rows, cols) -> "Matrix":
        return cls._wrap(np.zeros((int(rows), int(cols))))

    @classmethod
    def ones(cls, rows, cols) -> "Matrix":
        return cls._wrap(np.ones((int(rows), int(cols))))

    @classmethod
    def identity(cls, rows, cols) -> "Matrix":
        return cls._wrap(np.eye(int(rows), int(cols)))

    @classmethod
    def random(cls, rows, cols, seed=None) -> "Matrix":
        rng = np.random.default_rng(None if seed is None else int(seed))
        return cls._wrap(rng.random((int(rows), int(cols))))

    # -- properties ---------------------------------------------------------

    @property
    def rows(self) -> int:
        return self._a.shape[0]

    @property
    def cols(self) -> int:
        return self._a.shape[1]

    @property
    def shape(self):
        return self._a.shape

    @property
    def dtype(self) -> str:
        return "float64"

    @property
    def T(self) -> "Matrix":
        return Matrix._wrap(self._a.T.copy())

    def to_numpy(self) -> np.ndarray:
        return self._a

    def copy(self) -> "Matrix":
        return Matrix._wrap(self._a.copy())

    # -- indexing -----------------------------------------------------------

    def _check_key(self, key):
        if not (isinstance(key, tuple) and len(key) == 2):
            raise TypeError("matrix indices must be a (row, col) tuple")
        r, c = int(key[0]), int(key[1])
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise IndexError(f"index ({r}, {c}) out of bounds")
        return r, c

    def __getitem__(self, key):
        r, c = self._check_key(key)
        return float(self._a[r, c])

    def __setitem__(self, key, value):
        r, c = self._check_key(key)
        self._a[r, c] = float(value)

    # -- operators ----------------------------------------------------------

    def _other_array(self, other):
        if isinstance(other, Matrix):
            return other._a
        s = _coerce_scalar(other)
        return s

    def _binop(self, other, fn):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        return Matrix._wrap(fn(self._a, o))

    def __add__(self, other):
        return self._binop(other, np.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, np.subtract)

    def __rsub__(self, other):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        return Matrix._wrap(np.subtract(o, self._a))

    def __mul__(self, other):
        return self._binop(other, np.multiply)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, np.divide)

    def __matmul__(self, other):
        if not isinstance(other, Matrix):
            return NotImplemented
        return self.dot(other)

    def __neg__(self):
        return Matrix._wrap(-self._a)

    def __iadd__(self, other):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        self._a += o
        return self

    def __isub__(self, other):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        self._a -= o
        return self

    def __imul__(self, other):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        self._a *= o
        return self

    def __itruediv__(self, other):
        o = self._other_array(other)
        if o is None:
            return NotImplemented
        self._a /= o
        return self

    def __eq__(self, other):
        if isinstance(other, Matrix):
            return self._a.shape == other._a.shape and np.array_equal(self._a, other._a)
        return NotImplemented

    def __repr__(self):
        return f"Matrix({self._a.tolist()!r})"

    def __str__(self):
        return str(self._a)

    # -- linear algebra -----------------------------------------------------

    def dot(self, other: "Matrix") -> "Matrix":
        if not isinstance(other, Matrix):
            raise TypeError("dot expects a Matrix")
        if self.cols != other.rows:
            raise ValueError("matrix dimensions do not match for multiplication")
        return Matrix._wrap(self._a @ other._a)

    def transpose(self) -> "Matrix":
        return self.T

    def gram(self) -> "Matrix":
        """X @ X.T (reference: Matrix.zig gram)."""
        return Matrix._wrap(self._a @ self._a.T)

    def covariance(self) -> "Matrix":
        """X.T @ X (reference: Matrix.zig covariance)."""
        return Matrix._wrap(self._a.T @ self._a)

    def inv(self) -> "Matrix":
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        try:
            return Matrix._wrap(np.linalg.inv(self._a))
        except np.linalg.LinAlgError as e:
            raise ValueError("matrix is singular") from e

    def solve(self, b: "Matrix") -> "Matrix":
        if not isinstance(b, Matrix):
            raise TypeError("solve expects a Matrix right-hand side")
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        if b.rows != self.rows:
            raise ValueError("right-hand side dimensions do not match")
        if np.linalg.matrix_rank(self._a) < self.rows:
            raise ValueError("matrix is singular")
        return Matrix._wrap(np.linalg.solve(self._a, b._a))

    def pinv(self) -> "Matrix":
        return Matrix._wrap(np.linalg.pinv(self._a))

    def det(self) -> float:
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        return float(np.linalg.det(self._a))

    def rank(self, tolerance=None) -> int:
        return int(np.linalg.matrix_rank(self._a, tol=tolerance))

    def trace(self) -> float:
        return float(np.trace(self._a))

    def lu(self) -> dict:
        """Doolittle LU with partial pivoting -> {l, u, p, sign}
        (reference: Matrix.zig:1226)."""
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        n = self.rows
        a = self._a.copy()
        perm = list(range(n))
        sign = 1.0
        l = np.eye(n)
        for k in range(n):
            piv = k + int(np.argmax(np.abs(a[k:, k])))
            if piv != k:
                a[[k, piv]] = a[[piv, k]]
                l[[k, piv], :k] = l[[piv, k], :k]
                perm[k], perm[piv] = perm[piv], perm[k]
                sign = -sign
            if a[k, k] != 0:
                factors = a[k + 1:, k] / a[k, k]
                l[k + 1:, k] = factors
                a[k + 1:, k:] -= np.outer(factors, a[k, k:])
                a[k + 1:, k] = 0.0
        return {"l": Matrix._wrap(l), "u": Matrix._wrap(np.triu(a)),
                "p": perm, "sign": float(sign)}

    def chol(self) -> "Matrix":
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        try:
            return Matrix._wrap(np.linalg.cholesky(self._a))
        except np.linalg.LinAlgError as e:
            raise ValueError("matrix is not positive definite") from e

    def qr(self) -> dict:
        """Householder QR with column pivoting -> {q, r, rank, perm,
        col_norms} (reference: Matrix.zig:1396)."""
        a = self._a
        q, r, perm = _qr_col_pivot(a)
        col_norms = list(np.sqrt((a * a).sum(axis=0)))
        tol = max(a.shape) * np.finfo(np.float64).eps * (
            np.max(np.abs(np.diag(r))) if min(r.shape) else 0.0
        )
        rank = int(np.sum(np.abs(np.diag(r)) > tol))
        return {"q": Matrix._wrap(q), "r": Matrix._wrap(r), "rank": rank,
                "perm": perm, "col_norms": col_norms}

    def svd(self, full_matrices: bool = True, compute_uv: bool = True) -> dict:
        u, s, vt = np.linalg.svd(self._a, full_matrices=full_matrices)
        return {
            "u": Matrix._wrap(u),
            "s": Matrix._wrap(s.reshape(-1, 1)),
            "v": Matrix._wrap(vt.T),
            "converged": 0,
        }

    def eigh(self) -> dict:
        if self.rows != self.cols:
            raise ValueError("matrix must be square")
        w, v = np.linalg.eigh(self._a)
        return {"eigenvalues": Matrix._wrap(w.reshape(-1, 1)),
                "eigenvectors": Matrix._wrap(v)}

    # -- statistics ---------------------------------------------------------

    def sum(self) -> float:
        return float(self._a.sum())

    def mean(self) -> float:
        return float(self._a.mean())

    def min(self) -> float:
        return float(self._a.min())

    def max(self) -> float:
        return float(self._a.max())

    def variance(self) -> float:
        return float(self._a.var())

    def std(self) -> float:
        return float(self._a.std())

    def sum_rows(self) -> "Matrix":
        return Matrix._wrap(self._a.sum(axis=0, keepdims=True))

    def sum_cols(self) -> "Matrix":
        return Matrix._wrap(self._a.sum(axis=1, keepdims=True))

    def pow(self, n) -> "Matrix":
        return Matrix._wrap(self._a ** float(n))

    # -- norms (reference: Matrix.zig:905-1140) -----------------------------

    def frobenius_norm(self) -> float:
        return float(np.linalg.norm(self._a, "fro"))

    def l1_norm(self) -> float:
        return float(np.abs(self._a).sum())

    def max_norm(self) -> float:
        return float(np.abs(self._a).max())

    def element_norm(self, p: float = 2.0) -> float:
        p = float(p)
        if p < 1:
            raise ValueError("element norm requires p >= 1")
        return float((np.abs(self._a) ** p).sum() ** (1.0 / p))

    def schatten_norm(self, p: float = 2.0) -> float:
        p = float(p)
        if p < 1:
            raise ValueError("Schatten norm requires p >= 1")
        s = np.linalg.svd(self._a, compute_uv=False)
        return float((s**p).sum() ** (1.0 / p))

    def nuclear_norm(self) -> float:
        return float(np.linalg.svd(self._a, compute_uv=False).sum())

    def spectral_norm(self) -> float:
        s = np.linalg.svd(self._a, compute_uv=False)
        return float(s[0]) if s.size else 0.0

    def induced_norm(self, p: float = 2.0) -> float:
        p = float(p)
        if p == 1:
            return float(np.abs(self._a).sum(axis=0).max())
        if p == 2:
            return self.spectral_norm()
        if np.isinf(p) and p > 0:
            return float(np.abs(self._a).sum(axis=1).max())
        raise ValueError("induced norm supports p in {1, 2, inf}")

    # -- extraction ---------------------------------------------------------

    def row(self, r: int) -> "Matrix":
        if not 0 <= int(r) < self.rows:
            raise IndexError("row index out of bounds")
        return Matrix._wrap(self._a[int(r):int(r) + 1].copy())

    def col(self, c: int) -> "Matrix":
        if not 0 <= int(c) < self.cols:
            raise IndexError("column index out of bounds")
        return Matrix._wrap(self._a[:, int(c):int(c) + 1].copy())

    def submatrix(self, row_start, col_start, row_count, col_count) -> "Matrix":
        r0, c0 = int(row_start), int(col_start)
        rc, cc = int(row_count), int(col_count)
        if r0 < 0 or c0 < 0 or r0 + rc > self.rows or c0 + cc > self.cols:
            raise IndexError("submatrix out of bounds")
        return Matrix._wrap(self._a[r0:r0 + rc, c0:c0 + cc].copy())


def _qr_col_pivot(a: np.ndarray):
    """Householder QR with column pivoting."""
    m, n = a.shape
    r = a.copy()
    q = np.eye(m)
    perm = list(range(n))
    for k in range(min(m, n)):
        norms = (r[k:, k:] ** 2).sum(axis=0)
        j = k + int(np.argmax(norms))
        if j != k:
            r[:, [k, j]] = r[:, [j, k]]
            perm[k], perm[j] = perm[j], perm[k]
        x = r[k:, k]
        norm_x = np.linalg.norm(x)
        if norm_x == 0:
            continue
        v = x.copy()
        v[0] += np.sign(x[0]) * norm_x if x[0] != 0 else norm_x
        v = v / np.linalg.norm(v)
        r[k:, :] -= 2.0 * np.outer(v, v @ r[k:, :])
        q[:, k:] -= 2.0 * np.outer(q[:, k:] @ v, v)
    return q, np.triu(r), perm
