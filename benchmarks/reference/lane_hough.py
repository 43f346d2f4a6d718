"""Plain reference of the lane_hough deployment: Canny edges of each
grayscale u8 frame of a request, one frame at a time, then the Hough
transform of the edges and its lines. It follows the upstream library
(https://github.com/arrufat/zignal): ``src/image/edges.zig`` (canny,
edges.zig:212-275: a Gaussian blur of ``sigma`` with MIRROR borders, Sobel
gradients with REPLICATE borders and their magnitude, the non-maximum
suppression quantized to four directions at tan 22.5 degrees with the
frame's pixels 0, then hysteresis, edges.zig:499-580: the pixels that
reach ``high`` and those that reach ``low`` 8-connected to them) and
``src/image/hough.zig`` (init :38: the theta tables ``trunc(2^16 cos / sqrt
2)`` and ``trunc(2^16 sin / sqrt 2)`` over ``size`` thetas of ``pi /
even``; compute :75: the edges resized NEAREST to size x size, each edge
pixel's vote at ``rho = ((x cos + y sin) >> 1 + 2 offset) >> 16`` for
every theta; findLines :142: the interior 3x3 local maxima that reach the
threshold, by (score, rho, theta) descending, each kept unless an earlier
kept line lies within the angle and the radius thresholds).

The Gaussian, the gradients and the magnitude are computed in ``dtype``:
float64 for the reference, bfloat16 for the control, the precision below
the float32 that the configuration states. The rest is exact: masks,
integer votes and integer peaks.

Departures, none of which moves a value the check compares beyond its
limit:
- the Gaussian's taps are upstream's f32 kernel (radius ceil(3 sigma),
  normalised in f32), summed here in ``dtype``, upstream in f32;
- tan 22.5 degrees is the float64 value; upstream's f32 constant differs
  by less than 1e-8, which moves a pixel only where the two gradients'
  ratio falls between them;
- hysteresis grows by a 3x3 max-pool of the edges so far, each step
  tested for the fixpoint, where upstream walks a stack of pixels: the
  same set;
- findLines keeps only its first ``max_lines`` lines and lays them as
  rows ``(rho bin, theta bin, score)`` with a validity mask, as the
  program's ``find_lines_tensors`` does.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import mirror

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SOBEL_X = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
SOBEL_Y = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))
TAN_22_5 = math.tan(math.pi / 8)


def gaussian_f32(sigma: float) -> np.ndarray:
    """Upstream's 1-D Gaussian: radius ceil(3 sigma), normalised, in f32."""
    f32 = np.float32
    s = f32(sigma)
    radius = int(np.ceil(f32(3) * s))
    x = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    k = np.exp(-(x * x) / (f32(2) * s * s)).astype(f32)
    return (k / k.sum()).astype(f32)


def _blur(x, sigma: float, dtype):
    """Separable Gaussian of ``[H, W]`` with MIRROR borders, rows of taps
    then columns, in ``dtype``."""
    if sigma <= 0:
        return x.to(dtype)
    taps = gaussian_f32(sigma)
    r = len(taps) // 2
    x = x.to(dtype)
    for axis in (1, 0):
        n = x.shape[axis]
        total = torch.zeros_like(x)
        for k, wk in enumerate(taps.tolist()):
            src = torch.from_numpy(mirror(np.arange(n) + k - r, n)).to(
                x.device)
            total = total + x.index_select(axis, src) * torch.tensor(
                wk, dtype=dtype, device=x.device)
        x = total
    return x


def _sobel(x):
    """Sobel ``(gx, gy)`` of ``[H, W]`` with REPLICATE borders, in x's
    dtype."""
    h, w = x.shape
    rows = [torch.arange(h, device=x.device).add(d).clamp(0, h - 1)
            for d in (-1, 0, 1)]
    cols = [torch.arange(w, device=x.device).add(d).clamp(0, w - 1)
            for d in (-1, 0, 1)]
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    for i in range(3):
        band = x.index_select(0, rows[i])
        for j in range(3):
            px = band.index_select(1, cols[j])
            if SOBEL_X[i][j]:
                gx = gx + px * SOBEL_X[i][j]
            if SOBEL_Y[i][j]:
                gy = gy + px * SOBEL_Y[i][j]
    return gx, gy


def _nms(gx, gy, mag):
    """Quantized non-maximum suppression; neighbours off the frame read 0
    and the frame's own pixels stay 0."""
    h, w = mag.shape
    ax, ay = gx.abs(), gy.abs()
    horiz = ay <= TAN_22_5 * ax
    vert = ax <= TAN_22_5 * ay
    diag45 = ~horiz & ~vert & (gx * gy > 0)
    p = F.pad(mag, (1, 1, 1, 1))

    def at(dr, dc):
        return p[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    def pick(hz, vt, d45, d135):
        return torch.where(horiz, at(*hz), torch.where(
            vert, at(*vt), torch.where(diag45, at(*d45), at(*d135))))

    n1 = pick((0, -1), (-1, 0), (-1, 1), (-1, -1))
    n2 = pick((0, 1), (1, 0), (1, -1), (1, 1))
    keep = (mag >= n1) & (mag >= n2)
    keep[0, :] = keep[-1, :] = False
    keep[:, 0] = keep[:, -1] = False
    return keep


def _hysteresis(cand, mag, low: float, high: float):
    """The candidates that reach ``high``, and those that reach ``low``
    8-connected to them through others that do: grown a 3x3 max-pool at a
    time until a step adds nothing."""
    weak = cand & (mag >= low)
    edges = cand & (mag >= high)
    while True:
        grown = F.max_pool2d(edges[None, None].to(torch.float32), 3, 1, 1)
        nxt = edges | (weak & (grown[0, 0] > 0))
        if torch.equal(nxt, edges):
            return edges
        edges = nxt


def canny(frame, sigma: float, low: float, high: float,
          dtype=torch.float64):
    """u8 0/255 Canny edges of a u8 ``[H, W]`` frame."""
    x = _blur(frame.to(torch.float64), sigma, dtype)
    gx, gy = _sobel(x)
    mag = torch.sqrt(gx * gx + gy * gy)
    gx, gy, mag = gx.double(), gy.double(), mag.double()
    low, high = float(np.float32(low)), float(np.float32(high))
    return _hysteresis(_nms(gx, gy, mag), mag, low, high).to(
        torch.uint8) * 255


def nearest(n_src: int, n_dst: int) -> np.ndarray:
    """Upstream's NEAREST source index of each output position:
    ``floor((i + 0.5) * src / dst - 0.5 + 0.5)`` in f32, clamped."""
    f32 = np.float32
    ratio = f32(n_src) / f32(n_dst)
    pos = (np.arange(n_dst, dtype=f32) + f32(0.5)) * ratio - f32(0.5)
    return np.clip(np.floor(pos + f32(0.5)), 0, n_src - 1).astype(np.int64)


def hough_tables(size: int):
    """(cos, sin) int64 ``[size]`` in 16.16 over sqrt 2, the offset and
    the even size."""
    even = size if size % 2 == 0 else size - 1
    theta = np.arange(size, dtype=np.float64) * np.pi / even
    cos_t = np.trunc(65536 * np.cos(theta) / np.sqrt(2.0)).astype(np.int64)
    sin_t = np.trunc(65536 * np.sin(theta) / np.sqrt(2.0)).astype(np.int64)
    return cos_t, sin_t, int(round(65536 * even / 4.0)), even


def votes(edges, size: int):
    """int32 ``[size, size]`` accumulator ``[rho, theta]`` of a u8 ``[H,
    W]`` edge frame, resized NEAREST to size x size."""
    dev = edges.device
    rows = torch.from_numpy(nearest(edges.shape[0], size)).to(dev)
    cols = torch.from_numpy(nearest(edges.shape[1], size)).to(dev)
    plane = edges.index_select(0, rows).index_select(1, cols)
    cos_t, sin_t, offset, _ = hough_tables(size)
    cos_t = torch.from_numpy(cos_t).to(dev)
    sin_t = torch.from_numpy(sin_t).to(dev)
    ys, xs = torch.nonzero(plane > 0, as_tuple=True)
    y = 2 * ys - (size - 1)
    x = 2 * xs - (size - 1)
    acc = torch.zeros(size * size, dtype=torch.int64, device=dev)
    step = max(1, (1 << 24) // max(1, len(x)))
    for t0 in range(0, size, step):
        theta = torch.arange(t0, min(size, t0 + step), device=dev)
        rho = x[None, :] * cos_t[theta, None] + y[None, :] * sin_t[theta, None]
        r = ((rho >> 1) + (offset << 1)) >> 16
        ok = (r >= 0) & (r < size)
        flat = (r * size + theta[:, None])[ok]
        acc += torch.bincount(flat, minlength=size * size)
    return acc.view(size, size).to(torch.int32)


def find_lines(acc, threshold: int, angle_thr: float, radius_thr: float,
               max_lines: int):
    """The first ``max_lines`` lines of an accumulator ``[size, size]``:
    int32 ``[max_lines, 3]`` rows (rho bin, theta bin, score) and their
    bool validity."""
    a = acc.to("cpu").numpy().astype(np.int64)
    n = a.shape[0]
    even = n if n % 2 == 0 else n - 1
    rows = np.zeros((max_lines, 3), np.int32)
    valid = np.zeros(max_lines, bool)
    peaks = []
    if n >= 3:
        c = a[1:-1, 1:-1]
        nb = [a[1 + dr:n - 1 + dr, 1 + dc:n - 1 + dc]
              for dr in (-1, 0, 1) for dc in (-1, 0, 1) if dr or dc]
        ok = (c >= threshold) & np.all([c >= v for v in nb], axis=0)
        peaks = sorted(((int(c[r, q]), r + 1, q + 1)
                        for r, q in zip(*np.nonzero(ok))), reverse=True)
    kept = []
    for score, r, q in peaks:
        if len(kept) == max_lines:
            break
        angle = q * (180.0 / even) - 90.0
        radius = (r - even / 2.0) * math.sqrt(2.0)
        if any(abs(angle - ka) < angle_thr and abs(radius - kr) < radius_thr
               for ka, kr in kept):
            continue
        rows[len(kept)] = (r, q, score)
        valid[len(kept)] = True
        kept.append((angle, radius))
    return (torch.from_numpy(rows).to(acc.device),
            torch.from_numpy(valid).to(acc.device))


def _lines(acc, cfg):
    return find_lines(acc, cfg["threshold"], float(cfg["angle_nms"]),
                      float(cfg["radius_nms"]), cfg["max_lines"])


def lane_hough(frames, cfg, dtype=torch.float64):
    """A request of u8 frames ``[B, H, W]`` -> (u8 0/255 edges ``[B, H,
    W]``, int32 accumulators ``[B, S, S]``, int32 line rows ``[B,
    max_lines, 3]``, bool validity ``[B, max_lines]``), frame by frame."""
    edges, accs, rows, valid = [], [], [], []
    for frame in frames:
        e = canny(frame, cfg["sigma"], cfg["low"], cfg["high"], dtype)
        acc = votes(e, cfg["hough_size"])
        r, v = _lines(acc, cfg)
        edges.append(e)
        accs.append(acc)
        rows.append(r)
        valid.append(v)
    return (torch.stack(edges), torch.stack(accs), torch.stack(rows),
            torch.stack(valid))


def compare(cfg, out, ref) -> dict:
    """The program's request ``out`` against the reference's ``ref``, both
    as ``lane_hough`` lays them out:
    - ``edge_pixels_differing``: pixels of the request's frames where the
      program's edges differ from the reference's Canny;
    - ``accumulator_bins_differing``: bins where the program's accumulators
      differ from the reference's votes over the program's own edges
      (exact);
    - ``lines_differing``: frames whose valid rows differ from the
      reference's findLines of the program's own accumulator (exact)."""
    edges, acc, rows, valid = out
    r_edges = ref[0]
    edge_px = int((edges != r_edges).sum())
    bins = lines = 0
    for f in range(edges.shape[0]):
        bins += int((votes(edges[f], cfg["hough_size"]) != acc[f]).sum())
        want_rows, want_valid = _lines(acc[f], cfg)
        same = torch.equal(valid[f], want_valid) and torch.equal(
            rows[f][valid[f]], want_rows[want_valid])
        lines += 0 if same else 1
    return {"edge_pixels_differing": float(edge_px),
            "accumulator_bins_differing": float(bins),
            "lines_differing": float(lines)}
