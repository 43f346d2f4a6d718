"""Planes of ORB's detect stage for the tests of ``_Atlas.candidates``:
each case's atlas (``features/orb._Atlas``) and its u8 plane ``[B, H,
W]`` on a device. Imports no JAX, so the card's tests can use it.

Cases:
- ``kitti_b1``, ``kitti_b8``: the orb_stereo configuration's atlas (8
  levels of 1241 x 376) of textured frames through the pyramid;
- ``shelves``: an atlas whose shelves leave empty space, noise over the
  whole plane, that space included;
- ``one_level``: an atlas of one level;
- ``flat``: a flat frame, no corner;
- ``planted``: single bright and dark pixels at 2 to 5 px from every
  edge of every level, so that some lie next to another level;
- ``arc``: rings of 8 and 9 consecutive taps brighter or darker than
  their centre, starting at every tap, those past tap 15 wrapping.

The describe stage's keypoints (``keypoints``): those the detect and
select stages choose on a case, or (``PLACED``) keypoints anywhere on
their levels, a third of them -inf, on ``planted``, ``shelves`` and 40
levels (``levels40_any``: more than the detect kernel takes), and
``wide``: keypoints past x = 2^20 on a level 1.12 M px wide, each on a
ramp that turns its angle to one of 2,000 steps from 133 to 136 degrees,
where the f32 spacing moves some rotated samples past the describe
kernel's window.
"""

import numpy as np
import torch

from zignal_tpu_torch.features import Orb
from zignal_tpu_torch.features import orb as porb
from zignal_tpu_torch.features.fast import CIRCLE_OFFSETS
from zignal_tpu_torch.ops.pyramid import ImagePyramid

CASES = ("kitti_b1", "kitti_b8", "shelves", "one_level", "flat", "planted",
         "arc")
# the cases small enough for the plain route on the CPU
SMALL = ("shelves", "one_level", "flat", "planted", "arc")
PLACED = ("planted_any", "shelves_any", "levels40_any", "wide")
KITTI = Orb(n_features=2000, edge_threshold=31)


def atlas_of(orb, h, w, device):
    """The atlas of ``orb``'s kept levels of ``h x w`` frames."""
    ks, margins = orb._fused_params(h, w)
    thresholds = tuple(max(5, int(orb.fast_threshold * 0.9 ** lv))
                       for lv in range(orb.n_levels))
    return porb._Atlas(tuple(orb._level_shapes(h, w)), ks, margins,
                       thresholds, torch.device(device))


def _pasted(orb, frames, device):
    """The atlas and plane of u8 ``frames [B, h, w]`` through ``orb``'s
    pyramid."""
    x = torch.from_numpy(frames).to(device)
    pyr = ImagePyramid.build(x, orb.n_levels, orb.scale_factor, 1.6)
    atlas = atlas_of(orb, *frames.shape[1:], device)
    return atlas, atlas.paste(pyr.levels)


def _textured(b, h, w, seed):
    """Noise with a darker block: structure beside grain."""
    x = np.random.default_rng(seed).integers(0, 256, (b, h, w), np.uint8)
    x[:, h // 4:2 * h // 3, w // 4:3 * w // 4] //= 4
    return x


def _planted(atlas, b):
    """Single pixels 160 above and below a ground of 90, at 2 to 5 px in
    from each edge of each level, along the edge."""
    plane = np.full((b,) + atlas.shape, 90, np.uint8)
    for r, c, h, w, _, _ in atlas.levels:
        for d in range(2, 6):
            value = 250 if d % 2 else 0
            for y in range(r + d, r + h - d, 11):
                plane[:, y, c + d] = plane[:, y, c + w - 1 - d] = value
            for x in range(c + d + 5, c + w - d, 13):
                plane[:, r + d, x] = plane[:, r + h - 1 - d, x] = value
    return plane


def _arcs(atlas):
    """On each level, spots on a grid of 12 px: a ring whose taps from
    ``start`` on are 110 above (or below) the centre, 8 or 9 of them,
    every start from 0 to 15."""
    plane = np.full((1,) + atlas.shape, 120, np.uint8)
    spot = 0
    for r, c, h, w, _, _ in atlas.levels:
        for y in range(r + 6, r + h - 6, 12):
            for x in range(c + 6, c + w - 6, 12):
                start, run = spot % 16, 8 + (spot // 16) % 2
                value = 230 if (spot // 32) % 2 == 0 else 10
                for k in range(start, start + run):
                    dx, dy = CIRCLE_OFFSETS[k % 16]
                    plane[0, y + dy, x + dx] = value
                spot += 1
    return plane


def case(name, device):
    """(atlas, u8 plane ``[B, H, W]`` on ``device``) of case ``name``."""
    if name in ("kitti_b1", "kitti_b8"):
        b = 1 if name == "kitti_b1" else 8
        return _pasted(KITTI, _textured(b, 376, 1241, 86), device)
    if name == "one_level":
        return _pasted(Orb(n_features=100, n_levels=1),
                       _textured(2, 70, 90, 7), device)
    if name == "shelves":
        atlas = atlas_of(Orb(n_features=500, n_levels=6), 120, 200, device)
        plane = np.random.default_rng(3).integers(0, 256, (2,) + atlas.shape,
                                                  np.uint8)
    else:
        atlas = atlas_of(Orb(n_features=300, edge_threshold=31), 96, 160,
                         device)
        plane = np.full((1,) + atlas.shape, 128, np.uint8) \
            if name == "flat" else _planted(atlas, 2) \
            if name == "planted" else _arcs(atlas)
    return atlas, torch.from_numpy(plane).to(device)


def _wide(device):
    """The ``wide`` case: (atlas, plane, keypoint x)."""
    from zignal_tpu_torch.ops.orb_describe import REACH

    side, k = 2 * REACH + 1, 2000
    atlas = atlas_of(Orb(n_features=k, n_levels=1), 48,
                     2 ** 20 + side * (k + 1), device)
    x = 2 ** 20 + REACH + 1 + side * np.arange(k)
    turn = np.deg2rad(133 + 3 * np.arange(k) / k)
    d = np.arange(-REACH, REACH + 1)
    plane = np.full((1,) + atlas.shape, 128, np.uint8)
    for xj, t in zip(x, turn):
        plane[0, 24 - REACH:24 + REACH + 1, xj - REACH:xj + REACH + 1] = \
            128 + np.rint(3.4 * (np.cos(t) * d[None] + np.sin(t) * d[:, None]))
    return atlas, plane, x


def keypoints(name, device):
    """(atlas, plane, resp f32 ``[B, K]``, idx int64 ``[B, K]``) of the
    describe stage's case ``name`` on ``device``."""
    if name in CASES:
        atlas, plane = case(name, device)
        return (atlas, plane) + atlas.select(atlas.candidates(plane, True))
    rng = np.random.default_rng(28)
    if name == "wide":
        atlas, plane, x = _wide(device)
        idx = (24 * atlas.shape[1] + x)[None]
    else:
        name = name.removesuffix("_any")
        if name == "levels40":
            atlas = atlas_of(Orb(n_features=500, scale_factor=1.05,
                                 n_levels=40), 120, 160, device)
        else:
            atlas, _ = case(name, device)
        plane = rng.integers(0, 256, (2,) + atlas.shape, np.uint8)
        t = atlas.table.tensor
        hw = (t[:, 3] * t[:, 4]).cpu().numpy()
        idx = (rng.random((2, hw.size)) * hw).astype(np.int64)
    resp = rng.normal(0, 1e4, idx.shape).astype(np.float32)
    resp[rng.random(idx.shape) < 1 / 3] = -np.inf
    return atlas, torch.from_numpy(plane).to(device), \
        torch.from_numpy(resp).to(device), torch.from_numpy(idx).to(device)
