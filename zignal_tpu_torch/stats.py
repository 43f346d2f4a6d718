"""Streaming statistics (reference: src/stats.zig).

RunningStats is the Welford accumulator with skewness/kurtosis and
`combine` for parallel merging (host Python floats), and CovarianceStats
the streaming mean and covariance of dim-dimensional samples (host f64
numpy); both copied from zignal_tpu/stats.py.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["RunningStats", "CovarianceStats"]


class RunningStats:
    """Welford streaming mean/variance/skewness/kurtosis/extrema
    (reference: stats.zig:35-230)."""

    __slots__ = ("_n", "_mean", "_m2", "_m3", "_m4", "_min", "_max")

    def __init__(self):
        self.clear()

    def clear(self):
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._m3 = 0.0
        self._m4 = 0.0
        self._min = 0.0
        self._max = 0.0

    def add(self, value):
        value = float(value)
        if self._n == 0:
            self._min = value
            self._max = value
        else:
            self._min = min(self._min, value)
            self._max = max(self._max, value)
        n1 = self._n
        self._n += 1
        n = self._n
        delta = value - self._mean
        delta_n = delta / n
        delta_n2 = delta_n * delta_n
        term1 = delta * delta_n * n1
        self._mean += delta_n
        self._m4 += (term1 * delta_n2 * (n * n - 3 * n + 3)
                     + 6 * delta_n2 * self._m2 - 4 * delta_n * self._m3)
        self._m3 += term1 * delta_n * (n - 2) - 3 * delta_n * self._m2
        self._m2 += term1

    def extend(self, values):
        for v in values:
            self.add(v)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._mean * self._n

    @property
    def mean(self) -> float:
        return self._mean if self._n > 0 else 0.0

    @property
    def variance(self) -> float:
        if self._n <= 1:
            return 0.0
        return self._m2 / (self._n - 1)

    @property
    def std_dev(self) -> float:
        return math.sqrt(self.variance)

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    @property
    def skewness(self) -> float:
        n = self._n
        if n <= 2 or self._m2 == 0:
            return 0.0
        variance = self._m2 / (n - 1)
        skew = (n / ((n - 1) * (n - 2))) * (self._m3 / (self._m2 / n))
        return skew / (variance**1.5)

    @property
    def ex_kurtosis(self) -> float:
        n = self._n
        if n <= 3 or self._m2 == 0:
            return 0.0
        n1 = n - 1
        kurt = ((n * (n + 1)) / (n1 * (n - 2) * (n - 3))) * (
            self._m4 / ((self._m2 * self._m2) / (n * n))
        )
        return kurt - (3 * n1 * n1) / ((n - 2) * (n - 3))

    def scale(self, value) -> float:
        """Z-score of `value` under the accumulated distribution."""
        sd = self.std_dev
        if sd == 0:
            return 0.0
        return (float(value) - self._mean) / sd

    def combine(self, other: "RunningStats") -> "RunningStats":
        """Merged statistics of both accumulators (stats.zig:188)."""
        if not isinstance(other, RunningStats):
            raise TypeError("combine expects a RunningStats")
        out = RunningStats()
        if self._n == 0:
            out._copy_from(other)
            return out
        if other._n == 0:
            out._copy_from(self)
            return out
        a, b = self, other
        n = a._n + b._n
        delta = b._mean - a._mean
        d2 = delta * delta
        d3 = d2 * delta
        d4 = d2 * d2
        na, nb = float(a._n), float(b._n)
        out._n = n
        out._mean = (na * a._mean + nb * b._mean) / n
        out._m2 = a._m2 + b._m2 + d2 * na * nb / n
        out._m3 = (a._m3 + b._m3
                   + d3 * na * nb * (na - nb) / (n * n)
                   + 3.0 * delta * (na * b._m2 - nb * a._m2) / n)
        out._m4 = (a._m4 + b._m4
                   + d4 * na * nb * (na * na - na * nb + nb * nb) / (n**3)
                   + 6.0 * d2 * (na * na * b._m2 + nb * nb * a._m2) / (n * n)
                   + 4.0 * delta * (na * b._m3 - nb * a._m3) / n)
        out._min = min(a._min, b._min)
        out._max = max(a._max, b._max)
        return out

    def _copy_from(self, other):
        self._n = other._n
        self._mean = other._mean
        self._m2 = other._m2
        self._m3 = other._m3
        self._m4 = other._m4
        self._min = other._min
        self._max = other._max

    def __repr__(self):
        return (f"RunningStats(count={self._n}, mean={self.mean:g}, "
                f"std_dev={self.std_dev:g})")


class CovarianceStats:
    """Streaming mean + covariance accumulation (Welford-style) for
    dim-dimensional samples (reference: src/stats.zig:234 CovarianceStats).

    `add` accepts a single sample; `extend` ingests an [N, dim] array in
    one vectorized update (the bulk path)."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.clear()

    def clear(self):
        self.count = 0
        self.mean_vec = np.zeros(self.dim, dtype=np.float64)
        self.m2 = np.zeros((self.dim, self.dim), dtype=np.float64)

    def add(self, sample):
        sample = np.asarray(sample, dtype=np.float64)
        self.count += 1
        delta = sample - self.mean_vec
        self.mean_vec += delta / self.count
        self.m2 += np.outer(delta, sample - self.mean_vec)

    def extend(self, samples):
        """Bulk update from [N, dim] (exact merge of per-chunk moments)."""
        samples = np.asarray(samples, dtype=np.float64).reshape(-1, self.dim)
        n_b = len(samples)
        if n_b == 0:
            return
        mean_b = samples.mean(axis=0)
        centered = samples - mean_b
        m2_b = centered.T @ centered
        n_a = self.count
        n = n_a + n_b
        delta = mean_b - self.mean_vec
        self.m2 += m2_b + np.outer(delta, delta) * (n_a * n_b / n)
        self.mean_vec += delta * (n_b / n)
        self.count = n

    def mean(self):
        return self.mean_vec.copy()

    def variance_vector(self):
        if self.count <= 1:
            return np.zeros(self.dim, dtype=np.float64)
        return np.diag(self.m2) / (self.count - 1)

    def covariance_matrix(self):
        """-> Matrix [dim, dim] (reference: stats.zig covarianceMatrix)."""
        from .matrix import Matrix

        if self.count <= 1:
            return Matrix.zeros(self.dim, self.dim)
        return Matrix.from_numpy(self.m2 / (self.count - 1))
