"""Plain reference of the orb_stereo deployment: ORB on each grayscale u8
frame of a request, one frame at a time, then a cross-checked
brute-force Hamming match of each left frame ``2p`` with its right frame
``2p + 1``. It follows the upstream library (https://github.com/arrufat/
zignal): ``src/image/pyramid.zig`` (a u8 Gaussian blur of sigma 1.6 of
the frame, then each level a bilinear resize of the blurred frame to
``trunc(size / scale_factor**level)``), ``src/features/Fast.zig``
(FAST-9 on the 16-pixel circle of radius 3, 3-pixel border, the score a
sum of the differences past the threshold; non-maximum suppression at
distance^2 < 25, the strictly greater score wins), ``src/features/
orb.zig`` (the budget split geometrically over the levels, the FAST
threshold ``max(5, int(t * 0.9**level))``, Harris over 7x7 windows of
central differences, a stable descending order of the responses and its
first ``budget``, then the margin ``max(3, edge_threshold / scale)``; the
intensity-centroid angle of the radius-15 patch; rotated BRIEF from the
learned pattern) and ``src/features/matcher.zig`` (each query's nearest
train descriptor, the first on ties, kept where the train's nearest query
is that query).

Harris and the angle are computed in ``dtype``: float64 for the
reference, where every sum is exact; bfloat16 for the control, the
precision below the float32 that the configuration states. The u8 stages
(pyramid, FAST, NMS, BRIEF's comparisons, the Hamming distances) are
exact integers.

Departures, none of which changes a value the check compares:
- the port reads FAST's circle and the NMS window through wrap-around
  shifts (as the JAX package's ``jnp.roll``); here they are slices and
  zero padding. Every pixel a wrapped read reaches lies in the 3-pixel
  border, whose score is 0, so both give the same maps;
- upstream keeps its keypoints in lists; here each level's ``budget``
  rows are laid out as the port lays them (the top of the order, then
  rows marked not valid where the level has fewer candidates), so that
  the check and the control see one layout;
- BRIEF rounds a rotated sample half to even, as the JAX package's host
  oracle does; an exact half never occurs at the angles' cosines and
  sines.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import blur_u8
from .north_star import resize_u8

PYRAMID_SIGMA = 1.6
HARRIS_K = 0.04
PATCH_RADIUS = 15
MIN_RUN = 9
# Fast.zig: the Bresenham circle of radius 3, clockwise from 12 o'clock,
# as (dx, dy)
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3))
# the NMS window: distance^2 < 25, the centre left out
NEAR = tuple((dx, dy) for dy in range(-4, 5) for dx in range(-4, 5)
             if (dx, dy) != (0, 0) and dx * dx + dy * dy < 25)
# ORB's learned BRIEF pattern, 256 (x1, y1, x2, y2) pairs in the 31x31
# patch: Rublee et al., "ORB: an efficient alternative to SIFT or SURF",
# ICCV 2011, as OpenCV's orb.cpp (bit_pattern_31_) and orb.zig ship it.
# Frozen here.
PATTERN = (
    (8, -3, 9, 5), (4, 2, 7, -12), (-11, 9, -8, 2), (7, -12, 12, -13),
    (2, -13, 2, 12), (1, -7, 1, 6), (-2, -10, -2, -4), (-13, -13, -11, -8),
    (-13, -3, -12, -9), (10, 4, 11, 9), (-13, -8, -8, -9), (-11, 7, -9, 12),
    (7, 7, 12, 6), (-4, -5, -3, 0), (-13, 2, -12, -3), (-9, 0, -7, 5),
    (12, -6, 12, -1), (-3, 6, -2, 12), (-6, -13, -4, -8), (11, -13, 12, -8),
    (4, 7, 5, 1), (5, -3, 10, -3), (3, -7, 6, 12), (-8, -7, -6, -2),
    (-2, 11, -1, -10), (-13, 12, -8, 10), (-7, 3, -5, -3), (-4, 2, -3, 7),
    (-10, -12, -6, 11), (5, -12, 6, -7), (5, -6, 7, -1), (1, 0, 4, -5),
    (9, 11, 11, -13), (4, 7, 4, 12), (2, -1, 4, 4), (-4, -12, -2, 7),
    (-8, -5, -7, -10), (4, 11, 9, 12), (0, -8, 1, -13), (-13, -2, -8, 2),
    (-3, -2, -2, 3), (-6, 9, -4, -9), (8, 12, 10, 7), (0, 9, 1, 3),
    (7, -5, 11, -10), (-13, -6, -11, 0), (10, 7, 12, 1), (-6, -3, -6, 12),
    (10, -9, 12, -4), (-13, 8, -8, -12), (-13, 0, -8, -4), (3, 3, 7, 8),
    (5, 7, 10, -7), (-1, 7, 1, -12), (3, -10, 5, 6), (2, -4, 3, -10),
    (-13, 0, -13, 5), (-13, -7, -12, 12), (-13, 3, -11, 8), (-7, 12, -4, 7),
    (6, -10, 12, 8), (-9, -1, -7, -6), (-2, -5, 0, 12), (-12, 5, -7, 5),
    (3, -10, 8, -13), (-7, -7, -4, 5), (-3, -2, -1, -7), (2, 9, 5, -11),
    (-11, -13, -5, -13), (-1, 6, 0, -1), (5, -3, 5, 2), (-4, -13, -4, 12),
    (-9, -6, -9, 6), (-12, -10, -8, -4), (10, 2, 12, -3), (7, 12, 12, 12),
    (-7, -13, -6, 5), (-4, 9, -3, 4), (7, -1, 12, 2), (-7, 6, -5, 1),
    (-13, 11, -12, 5), (-3, 7, -2, -6), (7, -8, 12, -7), (-13, -7, -11, -12),
    (1, -3, 12, 12), (2, -6, 3, 0), (-4, 3, -2, -13), (-1, -13, 1, 9),
    (7, 1, 8, -6), (1, -1, 3, 12), (9, 1, 12, 6), (-1, -9, -1, 3),
    (-13, -13, -10, 5), (7, 7, 10, 12), (12, -5, 12, 9), (6, 3, 7, 11),
    (5, -13, 6, 10), (2, -12, 2, 3), (3, 8, 4, -6), (2, 6, 12, -13),
    (9, -12, 10, 3), (-8, 4, -7, 9), (-11, 12, -4, -6), (1, 12, 2, -8),
    (6, -9, 7, -4), (2, 3, 3, -2), (6, 3, 11, 0), (3, -3, 8, -8),
    (7, 8, 9, 3), (-11, -5, -6, -4), (-10, 11, -5, 10), (-5, -8, -3, 12),
    (-10, 5, -9, 0), (8, -1, 12, -6), (4, -6, 6, -11), (-10, 12, -8, 7),
    (4, -2, 6, 7), (-2, 0, -2, 12), (-5, -8, -5, 2), (7, -6, 10, 12),
    (-9, -13, -8, -8), (-5, -13, -5, -2), (8, -8, 9, -13), (-9, -11, -9, 0),
    (1, -8, 1, -2), (7, -4, 9, 1), (-2, 1, -1, -4), (11, -6, 12, -11),
    (-12, -9, -6, 4), (3, 7, 7, 12), (5, 5, 10, 8), (0, -4, 2, 8),
    (-9, 12, -5, -13), (0, 7, 2, 12), (-1, 2, 1, 7), (5, 11, 7, -9),
    (3, 5, 6, -8), (-13, -4, -8, 9), (-5, 9, -3, -3), (-4, -7, -3, -12),
    (6, 5, 8, 0), (-7, 6, -6, 12), (-13, 6, -5, -2), (1, -10, 3, 10),
    (4, 1, 8, -4), (-2, -2, 2, -13), (2, -12, 12, 12), (-2, -13, 0, -6),
    (4, 1, 9, 3), (-6, -10, -3, -5), (-3, -13, -1, 1), (7, 5, 12, -11),
    (4, -2, 5, -7), (-13, 9, -9, -5), (7, 1, 8, 6), (7, -8, 7, 6),
    (-7, -4, -7, 1), (-8, 11, -7, -8), (-13, 6, -12, -8), (2, 4, 3, 9),
    (10, -5, 12, 3), (-6, -5, -6, 7), (8, -3, 9, -8), (2, -12, 2, 8),
    (-11, -2, -10, 3), (-12, -13, -7, -9), (-11, 0, -10, -5), (5, -3, 11, 8),
    (-2, -13, -1, 12), (-1, -8, 0, 9), (-13, -11, -12, -5), (-10, -2, -10, 11),
    (-3, 9, -2, -13), (2, -3, 3, 2), (-9, -13, -4, 0), (-4, 6, -3, -10),
    (-4, 12, -2, -7), (-6, -11, -4, 9), (6, -3, 6, 11), (-13, 11, -5, 5),
    (11, 11, 12, 6), (7, -5, 12, -2), (-1, 12, 0, 7), (-4, -8, -3, -2),
    (-7, 1, -6, 7), (-13, -12, -8, -13), (-7, -2, -6, -8), (-8, 5, -6, -9),
    (-5, -1, -4, 5), (-13, 7, -8, 10), (1, 5, 5, -13), (1, 0, 10, -13),
    (9, 12, 10, -1), (5, -8, 10, -9), (-1, 11, 1, -13), (-9, -3, -6, 2),
    (-1, -10, 1, 12), (-13, 1, -8, -10), (8, -11, 10, -6), (2, -13, 3, -6),
    (7, -13, 12, -9), (-10, -10, -5, -7), (-10, -8, -8, -13), (4, -6, 8, 5),
    (3, 12, 8, -13), (-4, 2, -3, -3), (5, -13, 10, -12), (4, -13, 5, -1),
    (-9, 9, -4, 3), (0, 3, 3, -9), (-12, 1, -6, 1), (3, 2, 4, -8),
    (-10, -10, -10, 9), (8, -13, 12, 12), (-8, -12, -6, -5), (2, 2, 3, 7),
    (10, 6, 11, -8), (6, 8, 8, -12), (-7, 10, -6, 5), (-3, -9, -3, 9),
    (-1, -13, -1, 5), (-3, -7, -3, 4), (-8, -2, -8, 3), (4, 2, 12, 12),
    (2, -5, 3, 11), (6, -9, 11, -13), (3, -1, 7, 12), (11, -1, 12, 4),
    (-3, 0, -3, 6), (4, -11, 4, 12), (2, -4, 2, 1), (-10, -6, -8, 1),
    (-13, 7, -11, 1), (-13, 12, -11, -13), (6, 0, 11, -13), (0, -1, 1, 4),
    (-13, 3, -9, -2), (-9, 8, -6, -3), (-13, -6, -8, -2), (5, -9, 8, 10),
    (2, 7, 3, -9), (-1, -6, -1, -1), (9, 5, 11, -2), (11, -3, 12, -8),
    (3, 0, 3, 5), (-1, 4, 0, 10), (3, -6, 4, 5), (-13, 0, -10, 5),
    (5, 8, 12, 11), (8, 9, 9, -6), (7, -4, 8, -12), (-10, 4, -10, 9),
    (7, 3, 12, 4), (9, -7, 10, -2), (7, 0, 12, -2), (-1, -6, 0, -11),
)
POPCOUNT = tuple(bin(i).count("1") for i in range(256))

# no float32 product here may run in TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def budgets(cfg) -> list:
    """Each level's feature budget, 0 for a level under 16 px."""
    n, scale, levels = cfg["n_features"], cfg["scale_factor"], cfg["n_levels"]
    factor = 1.0 / scale
    total = n * (1 - factor) / (1 - factor ** levels)
    out = []
    for level, (h, w) in enumerate(level_shapes(cfg)):
        k = int(round(total * factor ** level))
        out.append(0 if min(h, w) < 16 else k)
    return out


def level_shapes(cfg) -> list:
    h, w = cfg["rows"], cfg["cols"]
    return [(h, w)] + [(max(1, int(np.trunc(h / cfg["scale_factor"] ** i))),
                        max(1, int(np.trunc(w / cfg["scale_factor"] ** i))))
                       for i in range(1, cfg["n_levels"])]


def pyramid(frame, cfg) -> list:
    """u8 ``[H, W]`` -> the levels, u8 ``[h, w]``; level 0 is the frame."""
    blurred = blur_u8(frame[..., None], PYRAMID_SIGMA)
    return [frame] + [resize_u8(blurred, h, w)[..., 0]
                      for h, w in level_shapes(cfg)[1:]]


def _arc(bits, n: int):
    """Whether the 16 circle bits ``[16, ...]`` hold ``n`` contiguous set
    ones, around the circle."""
    run = torch.zeros(bits.shape[1:], dtype=torch.int32, device=bits.device)
    found = torch.zeros(bits.shape[1:], dtype=torch.bool, device=bits.device)
    for j in range(16 + n - 1):
        run = (run + 1) * bits[j % 16]
        found |= run >= n
    return found


def fast_scores(level, threshold: int):
    """int32 ``[h, w]``: each corner's score, 0 elsewhere and on the
    3-pixel border."""
    a = level.to(torch.int32)
    h, w = a.shape
    out = torch.zeros((h, w), dtype=torch.int32, device=a.device)
    if h <= 6 or w <= 6:
        return out
    c = a[3:h - 3, 3:w - 3]
    ring = torch.stack([a[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx]
                        for dx, dy in CIRCLE])
    corner = _arc(ring > torch.clamp_max(c + threshold, 255), MIN_RUN) | \
        _arc(ring < torch.clamp_min(c - threshold, 0), MIN_RUN)
    diff = (ring - c).abs()
    score = torch.where(diff > threshold, diff, 0).sum(0, dtype=torch.int32)
    out[3:h - 3, 3:w - 3] = torch.where(corner, score, 0)
    return out


def nms(scores):
    """The corners no neighbour at distance^2 < 25 beats."""
    h, w = scores.shape
    padded = F.pad(scores, (4, 4, 4, 4))
    best = scores
    for dx, dy in NEAR:
        best = torch.maximum(best,
                             padded[4 + dy:4 + dy + h, 4 + dx:4 + dx + w])
    return (scores > 0) & (scores >= best)


def harris(level, ys, xs, dtype):
    """Harris response of each candidate over the 7x7 window of its
    central differences, in ``dtype``; 0 within 4 px of the border."""
    h, w = level.shape
    d = torch.arange(-4, 5, device=level.device)
    yy = (ys[:, None, None] + d[None, :, None]).clamp(0, h - 1)
    xx = (xs[:, None, None] + d[None, None, :]).clamp(0, w - 1)
    win = level[yy, xx].to(dtype)
    ix = (win[:, 1:-1, 2:] - win[:, 1:-1, :-2]) * 0.5
    iy = (win[:, 2:, 1:-1] - win[:, :-2, 1:-1]) * 0.5
    ixx, iyy, ixy = ((u * v).sum((1, 2)) for u, v in
                     ((ix, ix), (iy, iy), (ix, iy)))
    trace = ixx + iyy
    resp = ixx * iyy - ixy * ixy - HARRIS_K * trace * trace
    inside = (xs >= 4) & (xs < w - 4) & (ys >= 4) & (ys < h - 4)
    return torch.where(inside, resp, torch.zeros_like(resp))


def angles(level, ys, xs, dtype):
    """Intensity-centroid angle, degrees, of each keypoint's circular
    patch (pixels off the level read 0), the moments in ``dtype``."""
    h, w = level.shape
    d = torch.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, device=level.device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    circle = oy * oy + ox * ox <= PATCH_RADIUS * PATCH_RADIUS
    oy, ox = oy[circle], ox[circle]
    py, px = ys[:, None] + oy, xs[:, None] + ox
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    v = (level[py.clamp(0, h - 1), px.clamp(0, w - 1)] * inside).to(dtype)
    m00 = v.sum(1)
    m10 = (v * ox.to(dtype)).sum(1)
    m01 = (v * oy.to(dtype)).sum(1)
    ang = torch.rad2deg(torch.atan2(m01 / m00, m10 / m00))
    return torch.where(m00 < 0.001, torch.zeros_like(ang), ang)


def brief(level, ys, xs, angle_deg):
    """u8 ``[n, 32]``: bit ``i`` (byte ``i // 8``, bit ``i % 8``) is set
    where the pattern's first rotated sample is darker than its second,
    both on the level."""
    h, w = level.shape
    pat = torch.tensor(PATTERN, dtype=torch.float64, device=level.device)
    rad = torch.deg2rad(angle_deg.to(torch.float64))[:, None]
    cos, sin = torch.cos(rad), torch.sin(rad)
    kx, ky = xs.to(torch.float64)[:, None], ys.to(torch.float64)[:, None]

    def sample(px, py):
        rx = torch.round(kx + cos * px - sin * py).to(torch.int64)
        ry = torch.round(ky + sin * px + cos * py).to(torch.int64)
        ok = (rx >= 0) & (rx < w) & (ry >= 0) & (ry < h)
        return level[ry.clamp(0, h - 1), rx.clamp(0, w - 1)], ok

    p1, ok1 = sample(pat[:, 0], pat[:, 1])
    p2, ok2 = sample(pat[:, 2], pat[:, 3])
    bits = (ok1 & ok2 & (p1 < p2)).to(torch.int32).reshape(-1, 32, 8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                           device=level.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def frame_features(frame, cfg, dtype=torch.float64):
    """ORB of one u8 ``[H, W]`` frame -> (float64 ``[K, 5]`` rows of
    response, x, y, angle, level; u8 ``[K, 32]`` descriptors; bool ``[K]``
    validity), each level's ``budget`` rows in turn."""
    dev = frame.device
    rows, descs, valids = [], [], []
    for level, (lvl, k) in enumerate(zip(pyramid(frame, cfg), budgets(cfg))):
        if k == 0:
            continue
        h, w = lvl.shape
        thr = max(5, int(cfg["fast_threshold"] * (0.9 ** level)))
        scores = fast_scores(lvl, thr)
        ys, xs = torch.nonzero(nms(scores), as_tuple=True)  # row-major
        resp = harris(lvl, ys, xs, dtype)
        order = torch.sort(resp, descending=True, stable=True).indices[:k]
        ys, xs, resp = ys[order], xs[order], resp[order]
        scale = cfg["scale_factor"] ** level
        margin = max(3.0, cfg["edge_threshold"] / scale)
        valid = ((xs >= margin) & (xs < w - margin) & (ys >= margin)
                 & (ys < h - margin))
        ang = angles(lvl, ys, xs, dtype)
        desc = brief(lvl, ys, xs, ang)
        row = torch.stack([resp.to(torch.float64), xs.to(torch.float64),
                           ys.to(torch.float64), ang.to(torch.float64),
                           torch.full_like(xs, level, dtype=torch.float64)],
                          -1)
        pad = k - len(order)  # a level with fewer candidates than its budget
        rows.append(F.pad(row, (0, 0, 0, pad)))
        descs.append(F.pad(desc, (0, 0, 0, pad)))
        valids.append(F.pad(valid, (0, pad)))
    if not rows:
        return (torch.zeros((0, 5), dtype=torch.float64, device=dev),
                torch.zeros((0, 32), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return torch.cat(rows), torch.cat(descs), torch.cat(valids)


def hamming(a, b):
    """int64 ``[n, m]`` Hamming distances of u8 ``[n, 32]`` and ``[m,
    32]``, by a popcount table, 256 query rows at a time."""
    table = torch.tensor(POPCOUNT, dtype=torch.int64, device=a.device)
    return torch.cat([table[(a[i:i + 256, None, :] ^ b[None]).long()].sum(-1)
                      for i in range(0, len(a), 256)]) if len(a) else \
        torch.zeros((0, len(b)), dtype=torch.int64, device=a.device)


def match_pair(q, q_valid, t, t_valid, cross_check: bool = True):
    """Each valid query row's nearest valid train row (the first on
    ties) -> (int64 ``[N]`` train rows, int32 ``[N]`` distances), -1 where
    a query is not valid, has no train row, or fails the cross-check."""
    n = len(q)
    idx = torch.full((n,), -1, dtype=torch.int64, device=q.device)
    dist = torch.full((n,), -1, dtype=torch.int32, device=q.device)
    qi = torch.nonzero(q_valid)[:, 0]
    ti = torch.nonzero(t_valid)[:, 0]
    if len(qi) == 0 or len(ti) == 0:
        return idx, dist
    d = hamming(q[qi], t[ti])
    best = d.argmin(1)
    best_d = d.gather(1, best[:, None])[:, 0]
    keep = torch.ones(len(qi), dtype=torch.bool, device=q.device)
    if cross_check:
        keep &= d.argmin(0)[best] == torch.arange(len(qi), device=q.device)
    idx[qi[keep]] = ti[best[keep]]
    dist[qi[keep]] = best_d[keep].to(torch.int32)
    return idx, dist


def orb_stereo(frames, cfg, dtype=torch.float64):
    """The request on u8 ``[B, H, W]``, frames laid ``[L0, R0, L1, R1,
    ...]`` -> (keypoint rows ``[B, K, 5]``, descriptors ``[B, K, 32]``,
    validity ``[B, K]``, (train rows ``[B / 2, K]``, distances ``[B / 2,
    K]``)), each frame alone."""
    feats = [frame_features(f, cfg, dtype) for f in frames]
    rows, desc, valid = (torch.stack(x) for x in zip(*feats))
    matches = [match_pair(desc[p], valid[p], desc[p + 1], valid[p + 1],
                          cfg["cross_check"])
               for p in range(0, len(frames), 2)]
    idx, dist = (torch.stack(x) for x in zip(*matches))
    return rows, desc, valid, (idx, dist)


def _keys(rows, valid, h: int, w: int):
    """Sorted int64 keys ``(level, y, x)`` of the valid rows, and the
    order that sorts them."""
    r = rows[valid].to(torch.float64)
    key = (r[:, 4] * h + r[:, 2]) * w + r[:, 1]
    key, order = torch.sort(key.to(torch.int64))
    return key, order


def compare(cfg, out, ref) -> dict:
    """The program's request ``out`` against the reference's ``ref``, both
    as ``orb_stereo`` lays them out:
    - ``keypoints_differing``: valid (frame, level, x, y) of one not in the
      other, both ways, summed over the frames;
    - ``descriptor_bits_differing``: the largest share of the 256 bits
      that differ between the two descriptors of a keypoint both hold;
    - ``angle_max_gap_deg``: the widest gap of such a keypoint's angle;
    - ``matches_differing``: query rows whose match differs from the
      reference matcher's on the program's own descriptors (exact)."""
    rows, desc, valid, (idx, dist) = out
    r_rows, r_desc, r_valid, _ = ref
    h, w = cfg["rows"], cfg["cols"]
    table = torch.tensor(POPCOUNT, dtype=torch.int64, device=desc.device)
    differing, bits, gap, matches = 0, 0.0, 0.0, 0
    for f in range(rows.shape[0]):
        key, order = _keys(rows[f], valid[f], h, w)
        r_key, r_order = _keys(r_rows[f], r_valid[f], h, w)
        mine, theirs = torch.isin(key, r_key), torch.isin(r_key, key)
        differing += int((~mine).sum()) + int((~theirs).sum())
        if not bool(mine.any()):
            continue
        a = order[mine]
        b = r_order[theirs]
        d = desc[f][valid[f]][a] ^ r_desc[f][r_valid[f]][b]
        bits = max(bits, float(table[d.long()].sum(-1).max()) / 256)
        da = (rows[f][valid[f]][a, 3].to(torch.float64)
              - r_rows[f][r_valid[f]][b, 3].to(torch.float64)).abs() % 360
        gap = max(gap, float(torch.minimum(da, 360 - da).max()))
    for p in range(idx.shape[0]):
        want_idx, want_dist = match_pair(desc[2 * p], valid[2 * p],
                                         desc[2 * p + 1], valid[2 * p + 1],
                                         cfg["cross_check"])
        matches += int(((idx[p] != want_idx)
                        | (dist[p].to(torch.int32) != want_dist)).sum())
    return {"keypoints_differing": float(differing),
            "descriptor_bits_differing": bits,
            "angle_max_gap_deg": gap,
            "matches_differing": float(matches)}

