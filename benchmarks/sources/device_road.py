"""Drive frames of KITTI-like grayscale u8 road scenes resident on the card:
a ring of ``ring`` distinct request inputs ``[B, H, W]``, made on the device
from the seed, read in turn. Sized past the card's 50 MB L2, so no request
finds its input in cache.

A request is ``B`` frames of one drive: its vanishing point starts near
the middle of the frame (the horizon at 0.36-0.46 of the height, the
column within a tenth of the width of the centre) and moves a few pixels
from frame to frame. A frame is:
- a smooth background (a 6 x 20 grid of uniform values in [90, 170],
  upsampled bilinearly), 30 brighter above the horizon;
- a road of a uniform grey in [55, 85] between two edges that converge to
  the vanishing point, wider than the frame at the bottom, with lane
  markings at four positions across it (its two edges solid, two lanes
  between them dashed, the dashes evenly spaced in depth), each as wide
  as 2.5 % of the road's half-width, at least 0.8 px;
- markings whose contrast over the road falls from 120 at the bottom row
  to 24 at the horizon, so that their far parts pass Canny's low
  threshold and not its high one: hysteresis grows them from the near
  parts through weak stretches of hundreds of pixels;
- 3 shadows, bands of rows across the road that darken whatever they
  cover to 0.5 of its value, the markings under them weaker still;
- shapes painted over that, as many as 160 at 376 x 1241 and as many a
  pixel at other sizes (at least 12): rectangles (six in ten, buildings
  above the horizon, vehicles and signs below it) and discs, of sizes
  log-uniform from 6 px to 120 px (scaled down with the frame's height
  below 376 rows), each of one value, dark (in [0, 50]) or bright (in
  [205, 255]);
- grain, uniform integers in [-4, 4] (``device_stereo``'s).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.sources.device_stereo import CHUNK, GRID, _u8

BG_LOW, BG_HIGH, SKY = 90.0, 170.0, 30.0
ROAD = (55.0, 85.0)
HORIZON = (0.36, 0.46)        # of the height
VANISH_X = 0.1                # of the width, either side of the centre
DRIFT = 3.0                   # px a frame, at most, each way
SPREAD = (2.6, 3.4)           # road half-width over the rows below the horizon
LANES = (-1.0, -1.0 / 3.0, 1.0 / 3.0, 1.0)  # across the road, edges solid
MARK_WIDTH, MARK_MIN = 0.025, 0.8
NEAR, FAR = 120.0, 24.0       # marking contrast at the bottom, at the horizon
DASHES = 0.35                 # dash periods a unit of depth (rows / rows below)
SHADOWS, SHADE = 3, 0.5
SHAPES, AREA, MIN_SHAPES = 160, 376 * 1241, 12
SIZE_MIN, SIZE_MAX, FULL_ROWS = 6.0, 120.0, 376
RECTANGLES = 0.6
DARK = 50.0  # a shape's value lies in [0, 50] or [205, 255]


def _background(b, h, w, horizon, gen, device):
    grid = BG_LOW + (BG_HIGH - BG_LOW) * torch.rand(
        (b, 1) + GRID, generator=gen, device=device)
    bg = F.interpolate(grid, size=(h, w), mode="bilinear",
                       align_corners=True)[:, 0]
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    return bg + SKY * (ys < horizon[:, None, None])


def _road(scene, horizon, vx, gen):
    """Paint the road, its markings and its shadows over ``scene``."""
    b, h, w = scene.shape
    dev = scene.device
    u = torch.rand((b, 3), generator=gen, device=dev)
    spread = SPREAD[0] + (SPREAD[1] - SPREAD[0]) * u[:, 0]
    grey = ROAD[0] + (ROAD[1] - ROAD[0]) * u[:, 1]
    phase = u[:, 2]
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    below = ys - horizon[:, None, None]                 # rows below it
    half = below.clamp_min(1e-3) * spread[:, None, None]
    lateral = (xs - vx[:, None, None]) / half           # -1 .. 1 on the road
    on_road = (below > 0) & (lateral.abs() <= 1.0 + MARK_WIDTH)
    scene = torch.where(on_road, grey[:, None, None], scene)
    depth = 1.0 / below.clamp_min(1.0)                  # falls with the rows
    dash = torch.frac(depth * (DASHES * h) + phase[:, None, None]) < 0.5
    # a marking's half-width in lateral units: 2.5 % of the road's half,
    # at least MARK_MIN px
    reach = torch.maximum(torch.full_like(half, MARK_WIDTH), MARK_MIN / half)
    t = (below / (h - horizon[:, None, None])).clamp(0.0, 1.0)
    contrast = FAR + (NEAR - FAR) * t
    mark = torch.zeros_like(on_road)
    for lane in LANES:
        hit = (lateral - lane).abs() <= reach
        mark |= hit if abs(lane) == 1.0 else hit & dash
    scene = torch.where(on_road & mark & (below > 0), scene + contrast, scene)
    # shadows: bands of rows below the horizon
    v = torch.rand((b, SHADOWS, 2), generator=gen, device=dev)
    top = horizon[:, None] + (h - horizon[:, None]) * v[..., 0] * 0.9
    height = 6.0 + (h - horizon[:, None]) * 0.12 * v[..., 1]
    rows = ys[..., 0]                                   # [1, h]
    band = (rows[:, None, :] >= top[..., None]) & \
        (rows[:, None, :] < (top + height)[..., None])  # [b, SHADOWS, h]
    shade = band.any(1)[..., None] & on_road
    return torch.where(shade, scene * SHADE, scene)


def _shapes(scene, horizon, gen):
    """Paint buildings and vehicles over ``scene``, the largest first."""
    b, h, w = scene.shape
    dev = scene.device
    n = max(MIN_SHAPES, round(SHAPES * h * w / AREA))
    top = SIZE_MAX * min(1.0, h / FULL_ROWS)
    u = torch.rand((b, 6, n), generator=gen, device=dev)
    size = torch.exp(math.log(SIZE_MIN) + torch.sort(
        u[:, 0], descending=True).values * math.log(top / SIZE_MIN))
    cy, cx = u[:, 1] * h, u[:, 2] * w
    rect = u[:, 3] < RECTANGLES
    # buildings stand on the horizon, taller than wide; vehicles lie on the
    # road, wider than tall
    building = cy < horizon[:, None]
    aspect = torch.where(building, 1.2 + 1.3 * u[:, 4], 0.4 + 0.4 * u[:, 4])
    half_w = size / 2
    half_h = torch.where(rect, half_w * aspect, half_w)
    cy = torch.where(rect & building, horizon[:, None] - half_h, cy)
    value = torch.where(u[:, 5] < 0.5, DARK * 2 * u[:, 5],
                        255 - DARK * 2 * (1 - u[:, 5])).round()
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    last = torch.full((b, h, w), -1, dtype=torch.int64, device=dev)
    for i in range(0, n, CHUNK):
        s = slice(i, i + CHUNK)
        dy = (ys - cy[:, s, None, None]).abs()
        dx = (xs - cx[:, s, None, None]).abs()
        hh, hw = half_h[:, s, None, None], half_w[:, s, None, None]
        inside = torch.where(rect[:, s, None, None], (dy <= hh) & (dx <= hw),
                             dy * dy + dx * dx <= hw * hw)
        order = torch.arange(i, i + inside.shape[1], device=dev)
        last = torch.maximum(last, torch.where(
            inside, order[None, :, None, None], -1).amax(1))
    painted = value.gather(1, last.clamp_min(0).view(b, -1)).view(b, h, w)
    return torch.where(last >= 0, painted, scene)


def frames(shape, gen, device):
    """``[B, H, W]`` u8 frames of one drive from the generator ``gen``."""
    b, h, w = shape
    u = torch.rand((2,), generator=gen, device=device)
    drift = DRIFT * (2 * torch.rand((2, b), generator=gen, device=device)
                     - 1)
    horizon = h * (HORIZON[0] + (HORIZON[1] - HORIZON[0]) * u[0]) \
        + drift[0].cumsum(0)
    vx = w * (0.5 + VANISH_X * (2 * u[1] - 1)) + drift[1].cumsum(0)
    scene = _background(b, h, w, horizon, gen, device)
    scene = _road(scene, horizon, vx, gen)
    scene = _shapes(scene, horizon, gen)
    return _u8(scene.clamp(0, 255), gen)


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
