"""Feature Distribution Matching style transfer (reference: src/fdm.zig;
paper: Abramov et al. 2020, fdm.zig:296-299), the counterpart of
zignal_tpu/fdm.py.

The channel mean and covariance (f32, centred two-pass), the gray
statistics and the per-pixel map ``x @ W + bias`` run on the Image's
device; the 3x3 SVD stays host f64, as in the JAX package. The map is
W = U_s diag(sqrt(lambda_t / lambda_s)) U_t^T in [0, 1] pixel space, then
round and clamp to u8.

The statistics come back in one device-to-host copy a call (a packed
``[..., 4, 3]`` of mean and covariance). Every sum takes the order of
XLA's CPU tree reduction (``_tree_sum``: windows of 32 added in order,
then the windows' sums), so the means and the gray variance equal the
JAX package's; the covariance's products are summed the same way, not by
a matmul (no TF32 mode can touch them), where XLA's CPU dot chains all N
products through one FMA accumulator. Every step is an f32 operation
rounded alone, so the card and the CPU give the same bits.

The colour map rounds as the JAX package's compiled CPU program does
(found against it on the CPU): ``x = u8 * f32(1/255)``; output channels 0
and 1 sum their three products left to right with each operation
rounded, channel 2 chains them as ``fma(x2, w2, fma(x1, w1, x0 * w0))``;
then ``+ bias``, clip to [0, 1] and ``floor(fma(r, 255, 0.5))``. The gray
paths run op by op in JAX (eager), each operation rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import Image
from .ops.fma import fma

__all__ = ["FeatureDistributionMatching"]

_F32 = np.float32
_INV255 = _F32(1.0 / 255.0)


def _unit(x_u8):
    """u8 -> f32 in [0, 1] as XLA compiles ``/ 255.0``: times f32(1/255)."""
    return x_u8.to(torch.float32) * _INV255


def _add_in_order(x, squares: bool):
    """Sum over the last dim, left to right; of the squares when
    ``squares``, each square fused into its add (``fma(v, v, acc)``)."""
    if not squares:
        acc = x[..., 0]
        for i in range(1, x.shape[-1]):
            acc = acc + x[..., i]
        return acc
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = fma(x[..., i], x[..., i], acc)
    return acc


def _tree_sum(x, nd: int, squares: bool = False, k: int = 32):
    """Sum of the last ``nd`` dims of an f32 tensor (of their squares when
    ``squares``) in the order of XLA's CPU tree reduction: while a summed
    dim is longer than ``k``, cut each such dim into windows of ``k``
    (zero padding split low/high; shorter dims whole), add each window's
    values in row-major order, and go on with the windows' sums; then add
    what is left in row-major order. XLA fuses a square into the first of
    these passes, as an FMA."""
    while max(x.shape[-nd:]) > k:
        sizes = x.shape[-nd:]
        win = [k if n > k else n for n in sizes]
        pads = []
        for n, w in zip(reversed(sizes), reversed(win)):
            p = -n % w
            pads += [p // 2, p - p // 2]
        x = torch.nn.functional.pad(x, pads)
        lead = x.ndim - nd
        shape = list(x.shape[:lead])
        for n, w in zip(x.shape[lead:], win):
            shape += [n // w, w]
        # [..., n0, w0, n1, w1] -> [..., n0, n1, w0 * w1]
        x = x.reshape(shape).permute(
            *range(lead), *(lead + 2 * i for i in range(nd)),
            *(lead + 2 * i + 1 for i in range(nd)))
        x = _add_in_order(x.reshape(*x.shape[:lead + nd], -1), squares)
        squares = False
    return _add_in_order(x.reshape(*x.shape[:x.ndim - nd], -1), squares)


def _mean_cov(x):
    """``[..., N, 3]`` f32 -> host f64 ``(mean [..., 3], cov [..., 3, 3])``:
    the sample covariance of the centred values, one copy to the host."""
    n = x.shape[-2]
    cols = x.movedim(-1, -2)                                # [..., 3, N]
    mean = _tree_sum(cols, 1) * _F32(1.0 / n)
    xc = cols - mean[..., None]
    cov = _tree_sum(xc[..., :, None, :] * xc[..., None, :, :], 1) * \
        _F32(1.0 / max(n - 1, 1))
    packed = torch.cat([mean[..., None, :], cov], dim=-2)
    packed = packed.to("cpu").numpy().astype(np.float64)
    return packed[..., 0, :], packed[..., 1:, :]


def _gray_stats(img: Image):
    """Luminance mean and variance in [0, 1] on the image's device, one
    copy to the host."""
    plane = _unit(img._gray_u8_plane())
    n = plane.numel()
    mean = _tree_sum(plane, 2) * _F32(1.0 / n)
    var = _tree_sum(plane - mean, 2, squares=True) * _F32(1.0 / max(n - 1, 1))
    mv = torch.stack([mean, var]).to("cpu").numpy().astype(np.float64)
    return float(mv[0]), float(mv[1])


def _map_for(mean_s, cov_s, target_mean, target_s, target_u):
    """Host f64 W [3, 3] and bias [3] that carry the source statistics to
    the target's (fdm.zig:141-272)."""
    u_s, s_s, _ = np.linalg.svd(cov_s)
    sigma = np.zeros((3, 3))
    for i in range(3):
        if s_s[i] > 1e-10:
            sigma[i, i] = np.sqrt(target_s[i] / s_s[i])
    w = u_s @ sigma @ target_u.T
    return w, target_mean - mean_s @ w


def _apply_map(x, w, bias):
    """``x`` ``[..., N, 3]`` f32 in [0, 1], ``w`` ``[..., 3, 3]`` and
    ``bias`` ``[..., 3]`` host f64 -> u8 ``[..., N, 3]`` on x's device, in
    the compiled program's rounding (module docstring)."""
    w = torch.from_numpy(np.asarray(w, _F32)).to(x.device).unsqueeze(-3)
    bias = torch.from_numpy(np.asarray(bias, _F32)).to(x.device)
    x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    w0, w1, w2 = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    d01 = x0 * w0[..., :2] + x1 * w1[..., :2] + x2 * w2[..., :2]
    d2 = fma(x2, w2[..., 2:], fma(x1, w1[..., 2:], x0 * w0[..., 2:]))
    res = torch.clamp(torch.cat([d01, d2], dim=-1) + bias.unsqueeze(-2),
                      0.0, 1.0)
    scaled = fma(res, torch.full((), 255.0, device=x.device),
                 torch.full((), 0.5, device=x.device))
    return torch.floor(scaled).to(torch.uint8)


def _gray_map(plane_u8, scale: float, offset: float):
    """``clip(plane / 255 * scale + offset)`` rounded to u8, each operation
    rounded alone (JAX's eager gray paths; divided by a tensor, since
    PyTorch multiplies a CUDA tensor by the reciprocal of a Python
    divisor)."""
    dev = plane_u8.device
    plane = plane_u8.to(torch.float32) / torch.full((), 255.0, device=dev)
    out = torch.clamp(plane * _F32(scale) + _F32(offset), 0.0, 1.0)
    return torch.floor(out * 255.0 + 0.5).to(torch.uint8)


def _is_grayscale(img: Image) -> bool:
    if img._space == "gray":
        return True
    a = img._host()
    return bool(np.all(a[..., 0] == a[..., 1]) and np.all(a[..., 1] == a[..., 2]))


class FeatureDistributionMatching:
    """Stateful FDM: `set_target` once, re-use across sources
    (reference: fdm.zig:19-299)."""

    __slots__ = ("_target_mean", "_target_s", "_target_u",
                 "_target_gray", "_source")

    def __init__(self):
        self._target_mean = None
        self._target_s = None
        self._target_u = None
        self._target_gray = False
        self._source = None

    def set_target(self, target: Image) -> None:
        if not isinstance(target, Image):
            raise TypeError("target must be an Image")
        if _is_grayscale(target):
            mean, var = _gray_stats(target)
            self._target_gray = True
            self._target_mean = np.array([mean, mean, mean])
            self._target_s = np.array([var, 0.0, 0.0])
            self._target_u = None
            return
        mean, cov = _mean_cov(_unit(target._device()[..., :3]).reshape(-1, 3))
        u, s, _ = np.linalg.svd(cov)
        self._target_gray = False
        self._target_mean = mean
        self._target_s = s
        self._target_u = u

    def set_source(self, source: Image) -> None:
        if not isinstance(source, Image):
            raise TypeError("source must be an Image")
        self._source = source

    def match(self, source: Image, target: Image) -> None:
        """Match source's distribution to target's, in place."""
        if not isinstance(source, Image) or not isinstance(target, Image):
            raise TypeError("match expects two Images")
        self.set_target(target)
        self.set_source(source)
        self.update()

    def update(self) -> None:
        """Apply the transform to the current source, in place: the result
        is written into the source's host array (reference:
        fdm.zig:141-272)."""
        if self._target_mean is None:
            raise RuntimeError("no target set")
        if self._source is None:
            raise RuntimeError("no source set")
        src = self._source
        if src._space == "gray" or self._target_gray:
            mean_s, var_s = _gray_stats(src)
            scale = (np.sqrt(self._target_s[0] / var_s)
                     if var_s > 1e-10 else 1.0)
            offset = self._target_mean[0] - mean_s * scale
            if src._space == "gray":
                res = _gray_map(src._device()[..., 0], scale, offset)
                src._host()[:] = res.to("cpu").numpy()[..., None]
            else:
                res = _gray_map(src._gray_u8_plane(), scale, offset)
                src._host()[..., :3] = res.to("cpu").numpy()[..., None]
            return

        dev = src._device()[..., :3]
        x = _unit(dev).reshape(-1, 3)
        mean_s, cov_s = _mean_cov(x)
        w, bias = _map_for(mean_s, cov_s, self._target_mean,
                           self._target_s, self._target_u)
        out = _apply_map(x, w, bias).reshape(dev.shape)
        src._host()[..., :3] = out.to("cpu").numpy()

    def match_batch(self, batch, target: Image, *, device=None):
        """Batched FDM: match every ``[H, W, 3]`` u8 image of a
        ``[B, H, W, C]`` batch (C >= 3) to `target`, one device pass a
        stage: the B covariances at once, B 3x3 SVDs on the host, the
        batched pixel map. ``batch`` is a torch tensor or an ImageBatch
        (run on its device) or a numpy array (``device=`` names where).
        Returns a new ``[B, H, W, 3]`` u8 tensor on that device."""
        from .batch import ImageBatch

        self.set_target(target)
        if self._target_gray:
            raise ValueError("match_batch requires a color target")
        if isinstance(batch, ImageBatch):
            x = batch.device_array()
        elif isinstance(batch, torch.Tensor):
            x = batch
        else:
            if device is None:
                raise ValueError("a numpy batch needs device=")
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        if x.ndim != 4 or x.shape[-1] < 3 or x.dtype != torch.uint8:
            raise ValueError("match_batch expects [B, H, W, 3] u8")
        b, h, w = x.shape[:3]
        xf = _unit(x[..., :3]).reshape(b, -1, 3)
        means, covs = _mean_cov(xf)
        ws = np.zeros((b, 3, 3))
        biases = np.zeros((b, 3))
        for i in range(b):
            ws[i], biases[i] = _map_for(means[i], covs[i], self._target_mean,
                                        self._target_s, self._target_u)
        return _apply_map(xf, ws, biases).reshape(b, h, w, 3)

    def match_sharded(self, source_dev, target: Image, mesh,
                      axis_name: str = "batch"):
        """FDM on an H-sharded image across a device mesh: not ported yet,
        it comes with the port's ``parallel/`` (ROADMAP item 15)."""
        raise NotImplementedError(
            "match_sharded is not ported yet: it comes with the mesh and "
            "sharding ops of parallel/ (ROADMAP item 15)")

    def __repr__(self):
        return "FeatureDistributionMatching()"
