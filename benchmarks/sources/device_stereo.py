"""Stereo pairs of KITTI-like grayscale u8 frames resident on the card: a
ring of ``ring`` distinct request inputs ``[B, H, W]``, laid ``[L0, R0,
L1, R1, ...]``, made on the device from the seed, read in turn. Sized past
the card's 50 MB L2, so no request finds its input in cache.

A left frame is a smooth background (a 6 x 20 grid of uniform values in
[40, 200], upsampled bilinearly) with some hundreds of shapes painted over
it, the largest first, 400 at 376 x 1241 and as many a pixel at other
sizes (at least 24): rectangles (seven in ten) and discs, of sizes
log-uniform from 6 px to 200 px (scaled down with the frame's height
below 376 rows), each of one value, dark (in [0, 60]) or bright (in
[195, 255]); then grain, uniform integers in [-4, 4]. Its corners fill
every pyramid level's budget at FAST's threshold with room to spare (at
least 1.5 times the budget on every level), which the grain alone
(differences of at most 8) never passes. Its right frame is the same
scene before the grain, shifted left by a disparity drawn for each of 4
horizontal depth bands (in [4, 48] px, growing towards the bottom as a
road scene's does; the last column repeats at the edge), with fresh
grain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GRID = (6, 20)
BG_LOW, BG_HIGH = 40.0, 200.0
SHAPES, AREA = 400, 376 * 1241
MIN_SHAPES = 24
SIZE_MIN, SIZE_MAX, FULL_ROWS = 6.0, 200.0, 376
RECTANGLES = 0.7
DARK = 60.0  # a shape's value lies in [0, 60] or [195, 255]
GRAIN = 4
BANDS, DISPARITY = 4, (4, 48)
CHUNK = 32  # shapes painted a pass


def _scene(h: int, w: int, gen, device):
    """One clean left scene, f32 ``[h, w]``."""
    grid = BG_LOW + (BG_HIGH - BG_LOW) * torch.rand(
        (1, 1) + GRID, generator=gen, device=device)
    scene = F.interpolate(grid, size=(h, w), mode="bilinear",
                          align_corners=True)[0, 0]
    n = max(MIN_SHAPES, round(SHAPES * h * w / AREA))
    top = SIZE_MAX * min(1.0, h / FULL_ROWS)
    u = torch.rand((6, n), generator=gen, device=device)
    # painted largest first, so that the small shapes stay in view
    size = torch.exp(math.log(SIZE_MIN) + torch.sort(u[0], descending=True)
                     .values * math.log(top / SIZE_MIN))
    cy, cx = u[1] * h, u[2] * w
    rect = u[3] < RECTANGLES
    aspect = 0.4 + 0.6 * u[4]  # a rectangle's height over its width
    half_w = size / 2
    half_h = torch.where(rect, half_w * aspect, half_w)
    # dark or bright, so that most edges pass FAST's threshold on every
    # blurred level
    value = torch.where(u[5] < 0.5, DARK * 2 * u[5],
                        255 - DARK * 2 * (1 - u[5])).round()
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    last = torch.full((h, w), -1, dtype=torch.int64, device=device)
    for i in range(0, n, CHUNK):
        s = slice(i, i + CHUNK)
        dy = (ys - cy[s, None, None]).abs()
        dx = (xs - cx[s, None, None]).abs()
        hh, hw = half_h[s, None, None], half_w[s, None, None]
        inside = torch.where(rect[s, None, None], (dy <= hh) & (dx <= hw),
                             dy * dy + dx * dx <= hw * hw)
        order = torch.arange(i, i + inside.shape[0], device=device)
        last = torch.maximum(last, torch.where(inside, order[:, None, None],
                                               -1).amax(0))
    return torch.where(last >= 0, value[last.clamp_min(0)], scene)


def _shifted(scene, gen):
    """The right view of ``scene``: each band of rows read ``d`` columns
    to the right, ``d`` its disparity."""
    h, w = scene.shape
    lo, hi = DISPARITY
    d = torch.sort(torch.randint(lo, hi + 1, (BANDS,), generator=gen,
                                 device=scene.device)).values
    band = torch.arange(h, device=scene.device) * BANDS // h
    cols = (torch.arange(w, device=scene.device)[None, :]
            + d[band][:, None]).clamp_max(w - 1)
    return torch.gather(scene, 1, cols)


def _u8(scene, gen):
    grain = torch.randint(-GRAIN, GRAIN + 1, scene.shape, generator=gen,
                          device=scene.device)
    return (torch.round(scene) + grain).clamp(0, 255).to(torch.uint8)


def frames(shape, gen, device):
    """``[B, H, W]`` u8 stereo frames, B even, from the generator ``gen``."""
    b, h, w = shape
    if b % 2:
        raise ValueError("stereo frames come in pairs: B must be even")
    out = []
    for _ in range(b // 2):
        scene = _scene(h, w, gen, device)
        out += [_u8(scene, gen), _u8(_shifted(scene, gen), gen)]
    return torch.stack(out)


class Ring:
    def __init__(self, shape, ring: int, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.data = [frames(shape, gen, device) for _ in range(ring)]

    def __len__(self) -> int:
        return len(self.data)

    def issue(self, adapter, cfg, i: int, span):
        return adapter.run_device(cfg, self.data[i % len(self.data)], span)

    def on_device(self, i: int):
        """Request ``i``'s input on the card, for the reference."""
        return self.data[i % len(self.data)]
