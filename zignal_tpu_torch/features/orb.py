"""ORB: FAST on an image pyramid + intensity-centroid orientation +
rotated BRIEF descriptors from the learned pattern
(reference: src/features/orb.zig), the counterpart of
zignal_tpu/features/orb.py.

The device path (``use_device=True``) is plain torch on the planes'
device, batched over a ``[B, H, W]`` stack: the pyramid (one u8 Gaussian
blur of the stack, then one bilinear resize a level: on a card the
separable and fused resize kernels), FAST, its non-maximum suppression,
the Harris map, the top-k, the intensity-centroid angle and the rotated
BRIEF, with one device-to-host copy of the packed rows at the end. The
host path (``use_device=False``, the oracle) is the JAX package's numpy
code, copied.

Where the JAX package's compiled CPU program fixes a float, the device
path does the same (found against it on the CPU): the Harris response is
``fma(-(k * trace), trace, fma(ixx, iyy, -(ixy * ixy)))`` on exact box
sums, and BRIEF's rotated sample is ``fma(-sin, y, fma(cos, x, kx))``
(``fma(cos, y, fma(sin, x, ky))``), rounded half to even. The angle's
``atan2`` and BRIEF's ``cos`` and ``sin`` are the f64 functions rounded
to f32, so a keypoint's bits do not depend on its place in the batch or
on the device (XLA's f32 ``atan2`` is within an ulp). The top-k breaks
ties by the lower flat index, as ``lax.top_k`` does, through a stable
descending sort.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..image import plane_of
from ..ops.fma import fma
from ..ops.pyramid import ImagePyramid
from ._orb_pattern import ORB_PATTERN
from .descriptor import BinaryDescriptor
from .fast import KeyPoint, _nms_device, fast_response_map

__all__ = ["Orb"]

PATCH_SIZE = 31
_HALF = PATCH_SIZE // 2

# circular orientation mask (orb.zig orientation_weights)
_YY, _XX = np.mgrid[-_HALF:_HALF + 1, -_HALF:_HALF + 1]
_CIRC = (_XX**2 + _YY**2 <= _HALF * _HALF).astype(np.float32)

_PAT = np.asarray(ORB_PATTERN, dtype=np.float32)  # [256, 4]
_F32 = np.float32
_ROW = 5 + 32  # packed row: resp, x, y, valid, angle, 32 descriptor bytes


@dataclasses.dataclass
class Orb:
    """ORB detector/descriptor (reference: orb.zig:85-110 options)."""

    n_features: int = 500
    scale_factor: float = 1.2
    n_levels: int = 8
    edge_threshold: int = _HALF
    first_level: int = 0
    fast_threshold: int = 20
    score_type: str = "harris_score"
    use_device: bool = True  # batched device path (host = oracle)

    def _level_shapes(self, h, w):
        """Replica of ImagePyramid.build's level sizing."""
        shapes = [(h, w)]
        for i in range(1, self.n_levels):
            scale = self.scale_factor ** i
            shapes.append((max(1, int(np.trunc(h / scale))),
                           max(1, int(np.trunc(w / scale)))))
        return shapes

    def _analyze(self, plane):
        """Host copies of the pyramid levels and of the FAST scores after
        the non-maximum suppression (zero on levels under 16 px), from
        the device pyramid of one ``[H, W]`` plane."""
        pyr = ImagePyramid.build(plane, self.n_levels, self.scale_factor, 1.6)
        levels, scores = [], []
        for level, lvl in enumerate(pyr.levels):
            levels.append(lvl.to("cpu").numpy())
            if min(lvl.shape) < 16:
                scores.append(np.zeros(tuple(lvl.shape), np.int16))
                continue
            thr = max(5, int(self.fast_threshold * (0.9 ** level)))
            s = fast_response_map(lvl, thr, 9)
            s = torch.where(_nms_device(s), s, 0)
            scores.append(s.to("cpu").numpy().astype(np.int16))
        return levels, scores

    def _features_per_level(self):
        """Geometric distribution of the feature budget (orb.zig)."""
        factor = 1.0 / self.scale_factor
        n_desired = []
        total = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        for lvl in range(self.n_levels):
            n_desired.append(int(round(total * factor**lvl)))
        return n_desired

    def detect(self, image, *, device=None) -> list:
        plane = plane_of(image, device)
        if self.use_device:
            return self._device_detect_compute(plane[None], False)[0][0]
        levels, scores = self._analyze(plane)
        return self._detect_host(levels, scores)

    def compute(self, image, keypoints, *, device=None) -> list:
        levels, _ = self._analyze(plane_of(image, device))
        return self._compute_host(levels, keypoints)

    def detect_and_compute(self, image, *, device=None):
        plane = plane_of(image, device)
        if self.use_device:
            return self._device_detect_compute(plane[None], True)[0]
        levels, scores = self._analyze(plane)
        kps = self._detect_host(levels, scores)
        return kps, self._compute_host(levels, kps)

    def _fused_params(self, h, w):
        shapes = self._level_shapes(h, w)
        per_level = self._features_per_level()
        ks, margins, lv_ids = [], [], []
        for level in range(self.n_levels):
            lh, lw = shapes[level]
            skip = (level < self.first_level or per_level[level] == 0
                    or min(lh, lw) < 16)
            k = 0 if skip else per_level[level]
            scale = self.scale_factor ** level
            ks.append(k)
            margins.append(float(max(3.0, self.edge_threshold / scale)))
            if k:
                lv_ids.append(level)
        return tuple(ks), tuple(margins), lv_ids

    def _unpack(self, rows, ks, lv_ids, want_desc: bool):
        """Host side: one image's packed ``[sum(k), 37]`` f32 rows ->
        KeyPoints (+ descriptors); rows not valid (the top-k's padding,
        the margin) are dropped."""
        out_kps, out_desc = [], []
        off = 0
        for level in lv_ids:
            k = ks[level]
            scale = self.scale_factor ** level
            for r in rows[off:off + k]:
                if r[3] < 0.5:
                    continue
                out_kps.append(KeyPoint(
                    x=float(r[1]) * scale, y=float(r[2]) * scale,
                    size=7.0 * scale, angle=float(r[4]),
                    response=float(r[0]), octave=level))
                if want_desc:
                    out_desc.append(BinaryDescriptor(r[5:].astype(np.uint8)))
            off += k
        return out_kps, (out_desc if want_desc else None)

    def _device_detect_compute(self, planes, want_desc: bool):
        """The whole ORB pipeline on a u8 ``[B, H, W]`` stack on its
        device, one copy to the host -> B (keypoints, descriptors)."""
        h, w = planes.shape[-2:]
        ks, margins, lv_ids = self._fused_params(h, w)
        packed = _orb_device(planes, self.n_levels, self.scale_factor,
                             self.fast_threshold, ks, margins,
                             self.score_type == "harris_score")
        rows = packed.to("cpu").numpy()
        return [self._unpack(r, ks, lv_ids, want_desc) for r in rows]

    def detect_and_compute_batch(self, images, *, device=None):
        """Batched detect+compute over same-shape images: one pyramid for
        the whole ``[B, H, W]`` stack (on a card one separable-blur launch
        and one resize launch a level) and one device-to-host copy.
        Images run on their device (all the same); numpy arrays and
        tensors on ``device=`` when it is named. Host gray planes are
        computed on the host and uploaded as one stack. Returns a list of
        (keypoints, descriptors) pairs identical to per-image
        detect_and_compute (reference: orb.zig:133 detectAndCompute,
        batched)."""
        from ..image import Image

        images = list(images)
        if not images:
            return []
        if not self.use_device:
            return [self.detect_and_compute(im, device=device)
                    for im in images]
        devices = {_canonical(im.device) for im in images
                   if isinstance(im, Image)}
        if len(devices) > 1:
            raise ValueError("detect_and_compute_batch requires the images "
                             "on one device")
        if device is None and devices:
            device = devices.pop()
        host_planes = [None if isinstance(im, torch.Tensor)
                       else self._plane_host_np(im) for im in images]
        if all(p is not None for p in host_planes):
            if device is None:
                raise ValueError("numpy images need device=")
            if any(p.shape != host_planes[0].shape for p in host_planes):
                raise ValueError("detect_and_compute_batch requires "
                                 "same-shape images")
            planes = torch.from_numpy(np.stack(host_planes)).to(device)
        else:
            planes = [plane_of(im, device) for im in images]
            if any(p.shape != planes[0].shape for p in planes):
                raise ValueError("detect_and_compute_batch requires "
                                 "same-shape images")
            planes = torch.stack(planes)
        return self._device_detect_compute(planes, True)

    def _plane_host_np(self, image):
        """Host-side gray plane: the integer BT.709 16.16 twin of
        color._array.rgb_to_gray_u8 (color.zig:1031): pure int math,
        bit-identical to the device conversion, so the batch path can
        upload 1-channel planes instead of converting RGB on the device.
        Returns None when the image has no host mirror (device-resident
        Images keep the device conversion path)."""
        from ..image import Image

        if isinstance(image, Image):
            if image._np is None:
                return None
            arr, space = image._np, image._space
        else:
            # raw arrays mirror _plane_of exactly: channel 0, no conversion
            arr = np.asarray(image)
            return np.ascontiguousarray(
                arr[..., 0] if arr.ndim == 3 else arr)
        if space == "gray" or arr.shape[-1] == 1:
            return np.ascontiguousarray(arr[..., 0])
        from ..color._scalar import _GRAY_FWD

        wr, wg, wb = _GRAY_FWD
        a = arr[..., :3].astype(np.int32)
        y = (a[..., 0] * wr + a[..., 1] * wg + a[..., 2] * wb
             + 32768) >> 16
        return np.clip(y, 0, 255).astype(np.uint8)

    def _detect_host(self, levels, scores) -> list:
        """Per-level candidate selection, vectorized across keypoints
        (the oracle of the device path; copied from the JAX package)."""
        per_level = self._features_per_level()
        out = []
        for level in range(self.first_level, self.n_levels):
            n_desired = per_level[level]
            if n_desired == 0:
                continue
            arr = levels[level]
            if min(arr.shape) < 16:
                continue
            s = scores[level]
            ys, xs = np.nonzero(s)
            if len(ys) == 0:
                continue
            if self.score_type == "harris_score":
                resp = _harris_batch(arr, xs, ys)
            else:
                resp = s[ys, xs].astype(np.float64)
            # stable argsort on -resp == the old stable python sort by
            # descending response (ties keep row-major candidate order)
            order = np.argsort(-resp, kind="stable")[:n_desired]

            scale = self.scale_factor ** level
            margin = max(3.0, self.edge_threshold / scale)
            h, w = arr.shape
            kx, ky = xs[order], ys[order]
            keep = ((kx >= margin) & (kx < w - margin)
                    & (ky >= margin) & (ky < h - margin))
            sel = order[keep]
            angles = _orientation_batch(arr, xs[sel], ys[sel])
            for i, idx in enumerate(sel):
                out.append(KeyPoint(
                    x=float(xs[idx]) * scale, y=float(ys[idx]) * scale,
                    size=7.0 * scale, angle=float(angles[i]),
                    response=float(resp[idx]), octave=level))
        return out

    def _compute_host(self, levels, keypoints) -> list:
        descs = [None] * len(keypoints)
        by_level: dict = {}
        for i, kp in enumerate(keypoints):
            level = min(max(kp.octave, 0), self.n_levels - 1)
            by_level.setdefault(level, []).append(i)
        for level, idxs in by_level.items():
            scale = self.scale_factor ** level
            kx = np.array([keypoints[i].x / scale for i in idxs])
            ky = np.array([keypoints[i].y / scale for i in idxs])
            ang = np.array([keypoints[i].angle for i in idxs])
            packed = _brief_batch(levels[level], kx, ky, ang)
            for j, i in enumerate(idxs):
                descs[i] = BinaryDescriptor(packed[j])
        return descs


# -- the device path --------------------------------------------------------

def _canonical(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _harris_map(lvl, k: float = 0.04):
    """Dense Harris response of u8 ``[..., h, w]`` (7x7 gradient windows,
    _harris_batch semantics): 7-tap window sums of ix^2, iy^2 and ix*iy,
    rows then columns (every partial sum is a multiple of 1/4 under 2^22,
    so exact in any order); the 4-pixel border, where the host scores 0,
    is 0."""
    a = lvl.to(torch.float32)
    h, w = a.shape[-2:]
    pad = torch.nn.functional.pad
    ix = 0.5 * (pad(a[..., :, 1:], (0, 1)) - pad(a[..., :, :-1], (1, 0)))
    iy = 0.5 * (pad(a[..., 1:, :], (0, 0, 0, 1))
                - pad(a[..., :-1, :], (0, 0, 1, 0)))

    def box7(m):
        rows = pad(m, (0, 0, 3, 3)).unfold(-2, 7, 1).sum(-1)
        return pad(rows, (3, 3)).unfold(-1, 7, 1).sum(-1)

    ixx = box7(ix * ix)
    iyy = box7(iy * iy)
    ixy = box7(ix * iy)
    det = fma(ixx, iyy, -(ixy * ixy))
    trace = ixx + iyy
    resp = fma(-(_F32(k) * trace), trace, det)
    inner = torch.zeros((h, w), dtype=torch.bool, device=a.device)
    inner[4:h - 4, 4:w - 4] = True
    return torch.where(inner, resp, 0.0)


def _gather(plane, pad: int, ys, xs):
    """``plane`` ``[B, h, w]`` zero-padded by ``pad`` and read at integer
    ``ys``, ``xs`` ``[B, ...]`` (relative to the unpadded plane)."""
    b, h, w = plane.shape
    p = torch.nn.functional.pad(plane, (pad, pad, pad, pad))
    flat = ((ys + pad) * (w + 2 * pad) + xs + pad).reshape(b, -1)
    return torch.gather(p.reshape(b, -1), 1, flat).reshape(ys.shape)


def _angles(lvl, ysel, xsel):
    """Intensity-centroid angle in degrees (f32) of each keypoint's
    circular 31x31 patch; the moments are integer sums, exact."""
    dev = lvl.device
    yy = torch.from_numpy(_YY.ravel()).to(dev)
    xx = torch.from_numpy(_XX.ravel()).to(dev)
    circ = torch.from_numpy(_CIRC.ravel().astype(np.int64)).to(dev)
    patch = _gather(lvl.to(torch.int64), _HALF, ysel[..., None] + yy,
                    xsel[..., None] + xx) * circ
    m00 = patch.sum(-1).to(torch.float32)
    m10 = (patch * xx).sum(-1).to(torch.float32)
    m01 = (patch * yy).sum(-1).to(torch.float32)
    safe = torch.clamp_min(m00, _F32(1e-6))
    ang = _f32_of_f64(torch.atan2, m01 / safe, m10 / safe) * \
        _F32(180.0 / np.pi)
    return torch.where(m00 < 0.001, 0.0, ang)


def _f32_of_f64(fn, *args):
    """An f32 transcendental as the f64 one rounded to f32: the same bits
    at every position of a tensor and on every device (PyTorch's
    vectorized f32 loops and their scalar tails can differ by an ulp)."""
    return fn(*(a.double() for a in args)).to(torch.float32)


def _brief(lvl, ysel, xsel, angles):
    """Rotated BRIEF of each keypoint -> u8 ``[B, K, 32]`` (bits little
    first); samples off the level leave their bit 0."""
    h, w = lvl.shape[-2:]
    dev = lvl.device
    rad = angles * _F32(np.pi / 180.0)
    cos_a = _f32_of_f64(torch.cos, rad)[..., None]
    sin_a = _f32_of_f64(torch.sin, rad)[..., None]
    x1, y1, x2, y2 = (torch.from_numpy(np.ascontiguousarray(_PAT[:, i]))
                      .to(dev) for i in range(4))
    kx = xsel.to(torch.float32)[..., None]
    ky = ysel.to(torch.float32)[..., None]

    def rotated(px, py):
        rx = torch.round(fma(-sin_a, py, fma(cos_a, px, kx)))
        ry = torch.round(fma(cos_a, py, fma(sin_a, px, ky)))
        return rx.to(torch.int64), ry.to(torch.int64)

    rx1, ry1 = rotated(x1, y1)
    rx2, ry2 = rotated(x2, y2)
    ok = ((rx1 >= 0) & (rx1 < w) & (ry1 >= 0) & (ry1 < h)
          & (rx2 >= 0) & (rx2 < w) & (ry2 >= 0) & (ry2 < h))
    p1 = _gather(lvl, 32, ry1, rx1)
    p2 = _gather(lvl, 32, ry2, rx2)
    bits = (ok & (p1 < p2)).to(torch.int32)
    bits = bits.reshape(*bits.shape[:-1], 32, 8)
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32))
    return (bits * weights).sum(-1).to(torch.uint8)


def _orb_device(planes, n_levels, scale_factor, thr0, ks, margins, harris):
    """Device ORB of a u8 ``[B, H, W]`` stack -> f32 ``[B, sum(ks), 37]``
    rows of [resp, x, y, valid, angle, 32 descriptor bytes] per kept
    level (every value but resp and angle integer, f32-exact)."""
    pyr = ImagePyramid.build(planes, n_levels, scale_factor, 1.6)
    pieces = []
    for level, lvl in enumerate(pyr.levels):
        k = ks[level]
        if k == 0:
            continue
        h, w = lvl.shape[-2:]
        thr = max(5, int(thr0 * (0.9 ** level)))
        scores = fast_response_map(lvl, thr, 9)
        keep = _nms_device(scores)
        resp_map = _harris_map(lvl) if harris else scores.to(torch.float32)
        cand = torch.where(keep & (scores > 0), resp_map, -torch.inf)
        # lax.top_k's order: descending, the lower flat index first on ties
        top_resp, top_idx = torch.sort(cand.reshape(cand.shape[0], -1),
                                       dim=-1, descending=True, stable=True)
        top_resp, top_idx = top_resp[:, :k], top_idx[:, :k]
        ysel, xsel = top_idx // w, top_idx % w
        m = margins[level]
        valid = (torch.isfinite(top_resp) & (xsel >= m) & (xsel < w - m)
                 & (ysel >= m) & (ysel < h - m))
        angles = _angles(lvl, ysel, xsel)
        desc = _brief(lvl, ysel, xsel, angles)
        pieces.append(torch.cat([
            torch.stack([top_resp, xsel.to(torch.float32),
                         ysel.to(torch.float32), valid.to(torch.float32),
                         angles], dim=-1),
            desc.to(torch.float32)], dim=-1))
    if not pieces:
        return torch.zeros((planes.shape[0], 0, _ROW), dtype=torch.float32,
                           device=planes.device)
    return torch.cat(pieces, dim=1)


# -- the host oracle (copied from the JAX package) ---------------------------

def _orientation_batch(arr: np.ndarray, xs: np.ndarray,
                       ys: np.ndarray) -> np.ndarray:
    """Intensity centroid in circular 31x31 patches (orb.zig
    computeOrientation) -> angles in degrees, for all keypoints at
    once. Out-of-bounds patch pixels read as 0 (zero padding == the
    scalar version's zero-initialized patch)."""
    if len(xs) == 0:
        return np.zeros(0, np.float64)
    a = np.pad(arr, _HALF).astype(np.float32)
    yy = ys[:, None, None] + (_YY + _HALF)[None]
    xx = xs[:, None, None] + (_XX + _HALF)[None]
    weighted = a[yy, xx] * _CIRC  # [K, 31, 31]
    m00 = weighted.sum(axis=(1, 2))
    m10 = (weighted * _XX).sum(axis=(1, 2))
    m01 = (weighted * _YY).sum(axis=(1, 2))
    safe = np.maximum(m00, np.float32(1e-6))
    ang = np.degrees(np.arctan2(m01 / safe, m10 / safe))
    return np.where(m00 < 0.001, 0.0, ang)


def _brief_batch(arr: np.ndarray, kx: np.ndarray, ky: np.ndarray,
                 angles: np.ndarray) -> np.ndarray:
    """Rotated BRIEF from the learned pattern (orb.zig
    computeBriefDescriptor) for all keypoints at once -> [K, 32] packed
    bytes; out-of-bounds points leave bits at 0."""
    h, w = arr.shape
    if len(kx) == 0:
        return np.zeros((0, 32), np.uint8)
    cos_a = np.cos(np.radians(angles))[:, None]
    sin_a = np.sin(np.radians(angles))[:, None]
    x1, y1, x2, y2 = (_PAT[:, i][None] for i in range(4))
    rx1 = np.round(kx[:, None] + cos_a * x1 - sin_a * y1).astype(int)
    ry1 = np.round(ky[:, None] + sin_a * x1 + cos_a * y1).astype(int)
    rx2 = np.round(kx[:, None] + cos_a * x2 - sin_a * y2).astype(int)
    ry2 = np.round(ky[:, None] + sin_a * x2 + cos_a * y2).astype(int)
    valid = ((rx1 >= 0) & (rx1 < w) & (ry1 >= 0) & (ry1 < h)
             & (rx2 >= 0) & (rx2 < w) & (ry2 >= 0) & (ry2 < h))
    p1 = arr[np.clip(ry1, 0, h - 1), np.clip(rx1, 0, w - 1)]
    p2 = arr[np.clip(ry2, 0, h - 1), np.clip(rx2, 0, w - 1)]
    bits = valid & (p1 < p2)
    return np.packbits(bits, axis=1, bitorder="little")


def _harris_batch(arr: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                  k: float = 0.04) -> np.ndarray:
    """Harris scores over 7x7 windows (orb.zig computeHarrisResponse)
    for all candidates at once; off-edge candidates score 0."""
    h, w = arr.shape
    half = 3
    resp = np.zeros(len(xs), np.float64)
    ok = ((xs >= half + 1) & (xs < w - half - 1)
          & (ys >= half + 1) & (ys < h - half - 1))
    if not ok.any():
        return resp
    cx, cy = xs[ok], ys[ok]
    dy, dx = np.mgrid[-half - 1:half + 2, -half - 1:half + 2]
    win = arr[cy[:, None, None] + dy, cx[:, None, None] + dx] \
        .astype(np.float32)  # [K, 9, 9]
    ix = (win[:, 1:-1, 2:] - win[:, 1:-1, :-2]) * 0.5
    iy = (win[:, 2:, 1:-1] - win[:, :-2, 1:-1]) * 0.5
    ixx = (ix * ix).sum(axis=(1, 2))
    iyy = (iy * iy).sum(axis=(1, 2))
    ixy = (ix * iy).sum(axis=(1, 2))
    det = ixx * iyy - ixy * ixy
    trace = ixx + iyy
    resp[ok] = (det - np.float32(k) * trace * trace).astype(np.float64)
    return resp
