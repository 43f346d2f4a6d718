"""Principal Component Analysis (reference: src/pca.zig), the counterpart
of zignal_tpu/pca.py.

The reference auto-selects a covariance (dim x dim) or Gram (n x n) path;
both are equivalent to the SVD of the centered data matrix, which is what
``fit`` computes on host f64 for the user-facing Matrix API (``fit``,
``project``, ``reconstruct`` and ``transform`` are copied from the JAX
package). The ``*_array`` variants run on torch on the tensor's own
device (a numpy input names its ``device=``), with every matmul in full
fp32: TF32 is switched off for the call and restored after it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .matrix import Matrix

__all__ = ["PCA"]


@contextlib.contextmanager
def _full_fp32():
    """f32 matmuls in full precision for the body (no TF32 on the card),
    the caller's setting restored after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _as_tensor(arr, device):
    """A torch tensor stays on its device; anything else goes to
    ``device``, which must be named."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    if device is None:
        raise ValueError("a numpy input needs device=")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class PCA:
    """Fit/project/reconstruct/transform over zignal Matrix data."""

    __slots__ = ("_mean", "_components", "_eigenvalues")

    def __init__(self):
        self._mean = None
        self._components = None  # [dim, k]
        self._eigenvalues = None

    # -- properties mirrored from the reference binding ---------------------

    @property
    def dim(self) -> int:
        if self._mean is None:
            return 0
        return len(self._mean)

    @property
    def num_components(self) -> int:
        if self._components is None:
            return 0
        return self._components.shape[1]

    @property
    def mean(self):
        if self._mean is None:
            return []
        return [float(v) for v in self._mean]

    @property
    def eigenvalues(self):
        if self._eigenvalues is None:
            return []
        return [float(v) for v in self._eigenvalues]

    # -- API ----------------------------------------------------------------

    def fit(self, data, num_components=None) -> None:
        """Fit on an (n_samples x dim) Matrix (reference: pca.zig:104)."""
        if isinstance(data, Matrix):
            x = data.to_numpy()
        else:
            x = np.asarray(data, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError("fit expects an (n_samples, dim) matrix")
        n, dim = x.shape
        if n == 0:
            raise ValueError("no samples given")
        if n == 1:
            raise ValueError("at least 2 samples are required")
        max_components = min(n - 1, dim)
        if num_components is not None:
            num_components = int(num_components)
            if num_components <= 0:
                raise ValueError("num_components must be positive")
        k = min(num_components or max_components, max_components)

        self._mean = x.mean(axis=0)
        centered = x - self._mean
        # SVD of centered data == both reference paths
        _, s, vt = np.linalg.svd(centered, full_matrices=False)
        self._components = vt[:k].T.copy()  # [dim, k]
        self._eigenvalues = (s[:k] ** 2) / (n - 1)

    def _require_fit(self):
        if self._components is None:
            raise RuntimeError("PCA instance has not been fitted")

    def project(self, vector):
        """Coefficients of one vector (length dim) -> list of length k."""
        self._require_fit()
        v = np.asarray([float(x) for x in vector], dtype=np.float64)
        if v.shape[0] != self.dim:
            raise ValueError(f"vector must have length {self.dim}")
        coeffs = (v - self._mean) @ self._components
        return [float(c) for c in coeffs]

    def reconstruct(self, coefficients):
        """Inverse of project -> list of length dim."""
        self._require_fit()
        c = np.asarray([float(x) for x in coefficients], dtype=np.float64)
        if c.shape[0] != self.num_components:
            raise ValueError(f"coefficients must have length {self.num_components}")
        out = self._components @ c + self._mean
        return [float(v) for v in out]

    def transform(self, data) -> Matrix:
        """Project an (n x dim) Matrix -> (n x k) Matrix."""
        self._require_fit()
        x = data.to_numpy() if isinstance(data, Matrix) else np.asarray(data, np.float64)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"data must have {self.dim} columns")
        return Matrix._wrap((x - self._mean) @ self._components)

    # -- device variants on torch -------------------------------------------

    def fit_array(self, arr, num_components=None, *, device=None) -> None:
        """Device-statistics fit for image-scale data: a ``[..., dim]``
        tensor of millions of samples. Mean and (n-1)-normalized
        covariance in f32 on the tensor's device (two-pass centered, the
        FDM pattern); the tiny [dim, dim] eigendecomposition stays host
        f64. Equivalent to fit() to f32 statistics precision."""
        x = _as_tensor(arr, device).to(torch.float32)
        dim = x.shape[-1]
        x = x.reshape(-1, dim)
        n = x.shape[0]
        if n < 2:
            raise ValueError("at least 2 samples are required")
        with _full_fp32():
            mean = x.mean(dim=0)
            xc = x - mean
            cov = (xc.T @ xc) / np.float32(n - 1)
        packed = torch.cat([mean[None], cov]).to("cpu").numpy()
        packed = packed.astype(np.float64)
        self._mean = packed[0]
        cov = packed[1:]
        evals, evecs = np.linalg.eigh(cov)      # ascending
        order = np.argsort(evals)[::-1]
        evals = np.maximum(evals[order], 0.0)
        evecs = evecs[:, order]
        max_components = min(n - 1, dim)
        k = min(num_components or max_components, max_components)
        self._components = evecs[:, :k].copy()
        self._eigenvalues = evals[:k].copy()

    def transform_array(self, arr, *, device=None):
        """Batched projection on the tensor's device: ``[..., dim]`` ->
        ``[..., k]`` f32 tensor, ``(x - mean) @ components``."""
        self._require_fit()
        x = _as_tensor(arr, device).to(torch.float32)
        if x.shape[-1] != self.dim:
            raise ValueError(f"data must have {self.dim} channels")
        comp = torch.from_numpy(self._components.astype(np.float32)).to(
            x.device)
        mean = torch.from_numpy(self._mean.astype(np.float32)).to(x.device)
        with _full_fp32():
            return (x - mean) @ comp

    def reconstruct_array(self, coeffs, *, device=None):
        """Batched inverse of transform_array on the tensor's device:
        ``[..., k]`` -> ``[..., dim]`` f32."""
        self._require_fit()
        c = _as_tensor(coeffs, device).to(torch.float32)
        if c.shape[-1] != self.num_components:
            raise ValueError(
                f"coefficients must have {self.num_components} channels")
        comp = torch.from_numpy(self._components.astype(np.float32)).to(
            c.device)
        mean = torch.from_numpy(self._mean.astype(np.float32)).to(c.device)
        with _full_fp32():
            return c @ comp.T + mean

    def __repr__(self):
        return f"PCA(dim={self.dim}, num_components={self.num_components})"
