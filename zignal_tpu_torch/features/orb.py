"""ORB: FAST on an image pyramid + intensity-centroid orientation +
rotated BRIEF descriptors from the learned pattern
(reference: src/features/orb.zig), the counterpart of
zignal_tpu/features/orb.py.

The device path (``use_device=True``) runs on the planes' device,
batched over a ``[B, H, W]`` stack: the pyramid (one u8 Gaussian blur of
the stack, then one bilinear resize a level: on a card the separable and
fused resize kernels), FAST, its non-maximum suppression and the Harris
map (on a card one kernel, ``ops/orb_detect``; elsewhere plain torch),
the top-k in plain torch, then the intensity-centroid angle and the
rotated BRIEF (on a card one kernel, ``ops/orb_describe``; elsewhere
plain torch). ``Orb.detect_and_compute_tensors`` returns its keypoints,
descriptors and validity mask as tensors on the planes' device; the list
entries copy them to the host once and unpack them. Its constants live on
each device once (``ops/_build.cached``), so a request on a card after the
first copies nothing from the host and waits for nothing. The host path
(``use_device=False``, the oracle) is the JAX package's numpy code,
copied.

While a profiler session runs, a request records the spans ``orb`` (entry
to return), and inside it, one after the other, ``orb.pyramid``,
``orb.detect`` (FAST, NMS and the score map of every level),
``orb.select`` (the top-k of every level) and ``orb.describe`` (angles,
BRIEF and the rows); ``LEVELS`` counts the levels run on a CUDA device.

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
from ..ops import orb_describe, orb_detect
from ..ops._build import COUNT_LOCK, cached
from ..ops.fma import fma
from ..ops.pyramid import ImagePyramid
from ..profiling import RECORDER, span_start
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
# a keypoint row of detect_and_compute_tensors: response, x and y on its
# level, angle in degrees, level
KEYPOINT_FIELDS = ("response", "x", "y", "angle", "level")

LEVELS = 0  # pyramid levels run on a CUDA device, under COUNT_LOCK


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
        """Each level's budget (0 where it is skipped) and margin."""
        shapes = self._level_shapes(h, w)
        per_level = self._features_per_level()
        ks, margins = [], []
        for level in range(self.n_levels):
            lh, lw = shapes[level]
            skip = (level < self.first_level or per_level[level] == 0
                    or min(lh, lw) < 16)
            ks.append(0 if skip else per_level[level])
            scale = self.scale_factor ** level
            margins.append(float(max(3.0, self.edge_threshold / scale)))
        return tuple(ks), tuple(margins)

    def detect_and_compute_tensors(self, planes):
        """Detect and describe on a u8 ``[B, H, W]`` tensor, on its device:
        ``(keypoints, descriptors, valid)``, f32 ``[B, K, 5]`` rows of
        ``KEYPOINT_FIELDS`` (x and y on the keypoint's own level), u8
        ``[B, K, 32]`` and bool ``[B, K]``. K is the sum of the levels'
        budgets; each level's rows are its top-k by response, descending,
        and a row is valid where it holds a candidate outside the level's
        margin. Nothing is copied to the host."""
        if not isinstance(planes, torch.Tensor) or planes.dtype != \
                torch.uint8 or planes.ndim != 3:
            raise ValueError("detect_and_compute_tensors needs a u8 "
                             "[B, H, W] tensor")
        ks, margins = self._fused_params(*planes.shape[-2:])
        return _orb_device(planes, self.n_levels, self.scale_factor,
                           self.fast_threshold, ks, margins,
                           self.score_type == "harris_score")

    def _unpack(self, rows, want_desc: bool):
        """Host side: one image's ``[K, 38]`` f32 rows (the keypoint's
        fields, valid, 32 descriptor bytes) -> KeyPoints (+ descriptors);
        rows not valid (the top-k's padding, the margin) are dropped."""
        out_kps, out_desc = [], []
        for r in rows:
            if r[5] < 0.5:
                continue
            level = int(r[4])
            scale = self.scale_factor ** level
            out_kps.append(KeyPoint(
                x=float(r[1]) * scale, y=float(r[2]) * scale,
                size=7.0 * scale, angle=float(r[3]),
                response=float(r[0]), octave=level))
            if want_desc:
                out_desc.append(BinaryDescriptor(r[6:].astype(np.uint8)))
        return out_kps, (out_desc if want_desc else None)

    def _device_detect_compute(self, planes, want_desc: bool):
        """The whole ORB pipeline on a u8 ``[B, H, W]`` stack on its
        device, one copy to the host -> B (keypoints, descriptors)."""
        kps, desc, valid = self.detect_and_compute_tensors(planes)
        rows = torch.cat([kps, valid[..., None].to(torch.float32),
                          desc.to(torch.float32)], -1).to("cpu").numpy()
        return [self._unpack(r, want_desc) for r in rows]

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


def _patch_grids(device):
    """The orientation patch's pixels in the circle, ``(yy, xx)``, their
    int64 ``[709]`` offsets on ``device``."""
    inside = _CIRC.ravel() > 0
    return tuple(torch.from_numpy(np.ascontiguousarray(g.ravel()[inside],
                                                       np.int64)).to(device)
                 for g in (_YY, _XX))


def _read(plane, geom, ys, xs):
    """``plane`` ``[B, H, W]`` read at ``ys``, ``xs`` ``[B, K, S]`` on the
    keypoints' levels, each clamped to its level: ``geom`` = (row, col, h,
    w), int64 ``[K, 1]``, places keypoint k's level in the plane."""
    row, col, h, w = geom
    b, _, width = plane.shape
    y = torch.minimum(ys.clamp_min(0), h - 1) + row
    x = torch.minimum(xs.clamp_min(0), w - 1) + col
    return torch.gather(plane.reshape(b, -1), 1,
                        (y * width + x).reshape(b, -1)).reshape(ys.shape)


def _whole(plane):
    """The geometry of a plane that is one level."""
    h, w = plane.shape[-2:]
    return tuple(torch.full((1, 1), v, dtype=torch.int64, device=plane.device)
                 for v in (0, 0, h, w))


def _angles(plane, ysel, xsel, geom=None):
    """Intensity-centroid angle in degrees (f32) of each keypoint's
    circular 31x31 patch on its level (pixels off the level read 0); the
    moments are integer sums, exact. ``geom`` as ``_read``'s, None where
    ``plane`` is the level."""
    geom = _whole(plane) if geom is None else geom
    yy, xx = cached(_patch_grids, plane.device)
    ys, xs = ysel[..., None] + yy, xsel[..., None] + xx
    h, w = geom[2], geom[3]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    patch = _read(plane, geom, ys, xs).to(torch.int64) * inside
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


def _brief(plane, ysel, xsel, angles, geom=None):
    """Rotated BRIEF of each keypoint -> u8 ``[B, K, 32]`` (bits little
    first); samples off the keypoint's level leave their bit 0. ``geom``
    as ``_read``'s, None where ``plane`` is the level."""
    geom = _whole(plane) if geom is None else geom
    h, w = geom[2], geom[3]
    rad = angles * _F32(np.pi / 180.0)
    cos_a = _f32_of_f64(torch.cos, rad)[..., None]
    sin_a = _f32_of_f64(torch.sin, rad)[..., None]
    x1, y1, x2, y2, weights = cached(_brief_pattern, plane.device)
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
    p1 = _read(plane, geom, ry1, rx1)
    p2 = _read(plane, geom, ry2, rx2)
    bits = (ok & (p1 < p2)).to(torch.int32)
    bits = bits.reshape(*bits.shape[:-1], 32, 8)
    return (bits * weights).sum(-1).to(torch.uint8)


def _brief_pattern(device):
    """The pattern's columns x1, y1, x2, y2, f32 ``[256]``, and the bit
    weights of a byte, int32 ``[8]``, on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(_PAT[:, i]))
                 .to(device) for i in range(4)) + (
        torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                     device=device),)


class _Atlas:
    """The kept levels of a pyramid laid side by side in one plane, so
    that each stage runs once for all of them, not once a level. Levels
    go in order onto shelves as wide as the widest, each into the first
    shelf with room, touching: every value a stage keeps is read within
    its own level (FAST's ring and Harris's window from 3 and 4 pixels
    inside it), and the NMS reads at most one pixel past a level, where
    another level's outer row or column or an empty place scores 0.
    Holds the level table of the detect kernel (``levels``: each kept
    level's row, column, height, width, FAST threshold and first
    candidate; ``n`` candidates in all) and, on ``device``, the describe
    stage's row table (``table``: each output row's level, place, size
    and margin). The plain detect stage's
    planes (each pixel's FAST threshold, the masks of each level's FAST
    and Harris interiors, the levels' pixels in level order) are built at
    its first call."""

    def __init__(self, shapes, ks, margins, thresholds, device):
        kept = [lv for lv in range(len(shapes)) if ks[lv]]
        width = max(shapes[lv][1] for lv in kept)
        shelves, places = [], {}  # shelves: [top, height, used]
        for lv in kept:
            h, w = shapes[lv]
            shelf = next((s for s in shelves if h <= s[1]
                          and s[2] + w <= width), None)
            if shelf is None:
                shelf = [sum(s[1] for s in shelves), h, 0]
                shelves.append(shelf)
            places[lv] = (shelf[0], shelf[2])
            shelf[2] += w
        height = sum(s[1] for s in shelves)
        levels, rows, self.segments, start = [], [], [], 0
        for lv in kept:
            (h, w), (r, c) = shapes[lv], places[lv]
            levels.append((r, c, h, w, thresholds[lv], start))
            k = min(ks[lv], h * w)
            self.segments.append((start, start + h * w, k))
            rows.append(np.array([[lv, r, c, h, w]] * k, np.int64))
            start += h * w
        rows = np.concatenate(rows)
        self.kept, self.places, self.shape = kept, places, (height, width)
        self.levels, self.n, self.device = tuple(levels), start, device
        self._plain = None
        # each row's level, place, size, and its margin as the integers a
        # valid x and y start from and end before: an integer x >= m (or
        # < w - m) where x >= ceil(m) (< ceil(w - m)), the f64 margin
        margin = np.array([margins[lv] for lv in rows[:, 0]])
        ends = np.ceil(np.stack([margin, rows[:, 4] - margin,
                                 rows[:, 3] - margin], 1))
        self.table = orb_describe.RowTable(
            np.concatenate([rows, ends.astype(np.int64)], 1), self.shape,
            device)

    def _plain_planes(self):
        """(threshold, FAST interior, Harris interior, order) of the plain
        detect stage, built on the first call."""
        if self._plain is None:
            height, width = self.shape
            thr = np.zeros((height, width), np.int32)
            fast_in = np.zeros((height, width), bool)
            harris_in = np.zeros((height, width), bool)
            order = []
            for r, c, h, w, t, _ in self.levels:
                thr[r:r + h, c:c + w] = t
                fast_in[r + 3:r + h - 3, c + 3:c + w - 3] = True
                harris_in[r + 4:r + h - 4, c + 4:c + w - 4] = True
                order.append(((r + np.arange(h))[:, None] * width
                              + c + np.arange(w)[None, :]).ravel())
            self._plain = tuple(_upload(a, self.device) for a in (
                thr, fast_in, harris_in, np.concatenate(order)))
        return self._plain

    def paste(self, levels):
        """u8 ``[B, H, W]``: each kept level of ``levels`` in its place."""
        first = levels[self.kept[0]]
        plane = torch.zeros((first.shape[0],) + self.shape,
                            dtype=torch.uint8, device=first.device)
        for lv in self.kept:
            (r, c), (h, w) = self.places[lv], levels[lv].shape[-2:]
            plane[:, r:r + h, c:c + w] = levels[lv]
        return plane

    def candidates(self, plane, harris: bool):
        """f32 ``[B, N]``, the levels' pixels in level order: each FAST
        corner that survives the NMS scored by its response, -inf
        elsewhere. A CUDA plane runs one kernel (``ops/orb_detect``), any
        other the plain version."""
        if plane.device.type == "cuda":
            return orb_detect.candidates(plane, self.levels, self.n, harris)
        return self.candidates_reference(plane, harris)

    def candidates_reference(self, plane, harris: bool):
        """``candidates`` as plain torch on the plane's device."""
        thr, fast_in, harris_in, order = self._plain_planes()
        scores = torch.where(fast_in, fast_response_map(plane, thr, 9), 0)
        keep = _nms_device(scores) & (scores > 0)
        resp = torch.where(harris_in, _harris_map(plane), 0.0) \
            if harris else scores.to(torch.float32)
        cand = torch.where(keep, resp, -torch.inf)
        return cand.reshape(cand.shape[0], -1)[:, order]

    def select(self, cand):
        """Each level's top-k: (responses, flat indices on the level),
        ``[B, K]``."""
        tops = [_top_k(cand[:, s:e], k) for s, e, k in self.segments]
        return (torch.cat([t[0] for t in tops], dim=1),
                torch.cat([t[1] for t in tops], dim=1))

    def describe(self, plane, resp, idx):
        """The keypoint rows ``[B, K, 5]``, descriptors ``[B, K, 32]`` and
        validity ``[B, K]`` of the selected pixels. A CUDA plane runs one
        kernel (``ops/orb_describe``), any other the plain version."""
        if plane.device.type == "cuda":
            return orb_describe.describe(plane, resp, idx, self.table)
        return self.describe_reference(plane, resp, idx)

    def describe_reference(self, plane, resp, idx):
        """``describe`` as plain torch on the plane's device, from the
        kernel's row table."""
        t = self.table.tensor.to(torch.int64)
        geom = tuple(t[:, i:i + 1] for i in (1, 2, 3, 4))
        ysel, xsel = idx // t[:, 4], idx % t[:, 4]
        valid = (torch.isfinite(resp) & (xsel >= t[:, 5]) & (xsel < t[:, 6])
                 & (ysel >= t[:, 5]) & (ysel < t[:, 7]))
        angles = _angles(plane, ysel, xsel, geom)
        desc = _brief(plane, ysel, xsel, angles, geom)
        rows = torch.stack([resp, xsel.to(torch.float32),
                            ysel.to(torch.float32), angles,
                            t[:, 0].to(torch.float32).expand_as(resp)],
                           dim=-1)
        return rows, desc, valid


def _upload(a, device):
    """A numpy array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _top_k(cand, k: int):
    """The ``k`` best of each row of ``cand``, as ``lax.top_k`` orders
    them: descending, the lower flat index first on ties -> (responses,
    flat indices)."""
    resp, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    return resp[:, :k], idx[:, :k]


def _atlas(levels, thr0, ks, margins):
    """The atlas (``_Atlas``, cached) of the pyramid ``levels``, FAST's
    threshold ``max(5, int(thr0 * 0.9 ** level))`` on each."""
    thresholds = tuple(max(5, int(thr0 * (0.9 ** lv)))
                       for lv in range(len(levels)))
    return cached(_Atlas, tuple(tuple(lvl.shape[-2:]) for lvl in levels), ks,
                  margins, thresholds, levels[0].device)


def _orb_device(planes, n_levels, scale_factor, thr0, ks, margins, harris):
    """Device ORB of a u8 ``[B, H, W]`` stack -> (f32 ``[B, K, 5]``
    keypoint rows, u8 ``[B, K, 32]`` descriptors, bool ``[B, K]``
    validity), K = sum(ks); every value of a row but the response and the
    angle is an integer, f32-exact. The kept levels run together, laid
    in one plane (``_Atlas``)."""
    global LEVELS
    t0 = span_start()
    d0 = t0 and RECORDER.mark(planes)
    b, dev = planes.shape[0], planes.device
    pyr = ImagePyramid.build(planes, n_levels, scale_factor, 1.6)
    if not any(ks):
        return (torch.zeros((b, 0, len(KEYPOINT_FIELDS)), dtype=torch.float32,
                            device=dev),
                torch.zeros((b, 0, 32), dtype=torch.uint8, device=dev),
                torch.zeros((b, 0), dtype=torch.bool, device=dev))
    atlas = _atlas(pyr.levels, thr0, ks, margins)
    plane = atlas.paste(pyr.levels)
    t1 = t0 and RECORDER.add("orb.pyramid", t0)
    d1 = d0 and RECORDER.add_device("orb.pyramid", d0, plane)
    cand = atlas.candidates(plane, harris)
    t2 = t1 and RECORDER.add("orb.detect", t1)
    d2 = d1 and RECORDER.add_device("orb.detect", d1, plane)
    resp, idx = atlas.select(cand)
    t3 = t2 and RECORDER.add("orb.select", t2)
    d3 = d2 and RECORDER.add_device("orb.select", d2, plane)
    out = atlas.describe(plane, resp, idx)
    if t0:
        RECORDER.add("orb", t0, RECORDER.add("orb.describe", t3))
        d3 and RECORDER.add_device("orb.describe", d3, plane)
    if dev.type == "cuda":
        with COUNT_LOCK:
            LEVELS += len(atlas.kept)
    return out


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
