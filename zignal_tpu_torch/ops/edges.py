"""Edge detectors: Canny and Shen-Castan (reference: src/image/edges.zig,
src/image/ShenCastan.zig), the counterpart of zignal_tpu/ops/edges.py, on
float ``[..., H, W]`` planes (leading dims are batch).

The float stages follow the JAX package's compiled program op for op, so
the thresholded masks come out the same:

- the Gaussian, the Sobel taps and ``gx * gx + gy * gy`` are contracted
  into fused multiply-adds as XLA's CPU backend contracts them
  (ops/fma.py);
- the ISEF recursive filter (a first-order IIR, forward then backward) is
  the log-depth scan of ``jax.lax.associative_scan`` over ``(A, B)``
  pairs of ``y_i = A * y_{i-1} + B_i``, combined in the same order, each
  ``A2 * B1 + B2`` one fused multiply-add: elementwise ops on the whole
  plane, never a loop over columns;
- hysteresis grows strong edges through weak ones to a fixpoint, which
  does not depend on how many growth steps run between two convergence
  tests, so several run per test (one host sync on a card). Canny on a
  card takes kernels instead (ops/canny_front.py, ops/hysteresis.py),
  equal bit for bit, with no test at all.

Canny records its spans while a profiler session runs: ``canny`` around
the call, with ``canny.smooth``, ``canny.gradients``, ``canny.nms`` (or,
on a card, ``canny.front`` for the three) and ``canny.hysteresis`` inside
and a ``canny.test`` around each convergence test.
``HYSTERESIS_TESTS`` counts the tests run on a CUDA device.

Shen-Castan's window counts and sums are exact: integer window sums of
the 0/1 sign plane, and f64 window sums of the gray plane (exact for the
integer-valued planes ``ImageBatch`` passes), rounded to f32 once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..enums import BorderMode
from ..profiling import RECORDER, span_start
from ._build import COUNT_LOCK, cached
from .binary import histogram256
from .convolution import convolve_separable, gradient_magnitude, \
    sobel_gradients
from .fma import fma
from .integral import window_sums
from .tables import extents, gaussian_kernel

__all__ = ["canny", "isef_filter", "shen_castan"]

_K = np.float32(0.414213562)  # tan(22.5 deg), as the JAX package's f32
_GROWTH_STEPS = 8  # hysteresis steps between two convergence tests
# convergence tests run on a CUDA device (each a host wait), under
# COUNT_LOCK
HYSTERESIS_TESTS = 0


def _shift(a, dr: int, dc: int, fill=0):
    """``out[..., r, c] = a[..., r + dr, c + dc]``, ``fill`` outside."""
    h, w = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dr) < h and abs(dc) < w:
        out[..., max(0, -dr):h - max(0, dr), max(0, -dc):w - max(0, dc)] = \
            a[..., max(0, dr):h - max(0, -dr), max(0, dc):w - max(0, -dc)]
    return out


def _interior_mask(h: int, w: int, device):
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def _interior(a):
    """True off the one-pixel frame of ``[..., H, W]``, made once a shape
    and device."""
    return cached(_interior_mask, a.shape[-2], a.shape[-1], a.device)


def _tan_k(device):
    return torch.tensor(_K, device=device)


def _padded(a, fill=0):
    """``a`` with a one-pixel frame of ``fill``: ``_at(p, dr, dc)`` of it
    reads ``_shift(a, dr, dc, fill)`` without a copy."""
    return F.pad(a, (1, 1, 1, 1), value=fill)


def _at(p, dr: int, dc: int):
    """The view of the padded ``p`` that ``_shift(a, dr, dc)`` gives."""
    h, w = p.shape[-2] - 2, p.shape[-1] - 2
    return p[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]


def _quantized_nms(gx, gy, magnitude):
    """Directional non-max suppression (edges.zig:692-763); the frame
    stays 0."""
    ax, ay = gx.abs(), gy.abs()
    k = cached(_tan_k, gx.device)  # an upload waits for the card
    horiz = ay <= k * ax
    vert = ax <= k * ay
    diag45 = ~horiz & ~vert & (gx * gy > 0)
    m = magnitude
    p = _padded(m)

    def pick(h_, v_, d45, d135):
        return torch.where(horiz, _at(p, *h_), torch.where(
            vert, _at(p, *v_), torch.where(diag45, _at(p, *d45),
                                           _at(p, *d135))))

    n1 = pick((0, -1), (-1, 0), (-1, 1), (-1, -1))
    n2 = pick((0, 1), (1, 0), (1, -1), (1, 1))
    return (m >= n1) & (m >= n2) & _interior(m)


def _dilate8(mask):
    """3x3 neighbourhood OR, rows then columns, over one padded copy."""
    p = _padded(mask, False)
    h = p[..., :-2] | p[..., 1:-1] | p[..., 2:]
    return h[..., :-2, :] | h[..., 1:-1, :] | h[..., 2:, :]


def _hysteresis(candidate, gradients, t_low, t_high, span=None):
    """Grow strong edges (``grad >= high``) through weak ones (``grad >=
    low``), 8-connected, to the fixpoint (edges.zig:499-580). A growth
    step keeps the members (weak or strong) that touch the edges so far,
    the same as ``(weak & dilate(cur)) | cur``, since the edges so far are
    members that touch themselves. During a profiler session each
    convergence test is the recorder's span ``span`` when one is given."""
    global HYSTERESIS_TESTS
    weak = candidate & (gradients >= t_low)
    strong = candidate & (gradients >= t_high)
    members = weak | strong
    cur = (weak & _dilate8(strong)) | strong
    while True:
        prev = cur
        for _ in range(_GROWTH_STEPS):
            cur = members & _dilate8(cur)
        t0 = span_start() if span else 0
        done = torch.equal(prev, cur)
        if t0:
            RECORDER.add(span, t0)
        if cur.device.type == "cuda":
            with COUNT_LOCK:
                HYSTERESIS_TESTS += 1
        if done:
            return cur


def canny(gray_f32, sigma: float = 1.4, low: float = 50.0,
          high: float = 150.0):
    """Canny edges of a 0-255 float ``[..., H, W]`` plane -> u8 0/255
    (reference: edges.zig:212-275). A plane on a card takes two kernels
    with no host wait: the blur, Sobel, magnitude and NMS in one
    (ops/canny_front.py, the span ``canny.front`` in place of the three
    stages'), then the union-find hysteresis (ops/hysteresis.py); there a
    plane that is not f32, or a blur wider than the front kernel's, is
    refused. A CPU plane takes the plain route."""
    t0 = span_start()
    low, high = float(np.float32(low)), float(np.float32(high))
    x = gray_f32
    if x.device.type == "cuda":
        from . import canny_front
        from .hysteresis import hysteresis_u8

        d0 = t0 and RECORDER.mark(x)
        magnitude, nms = canny_front.front(x, sigma)
        t3 = t0 and RECORDER.add("canny.front", t0)
        out = hysteresis_u8(nms, magnitude, low, high)
        if t0:
            RECORDER.add("canny", t0, RECORDER.add("canny.hysteresis", t3))
            RECORDER.add_device("canny", d0, x)
        return out
    if sigma > 0:
        k = gaussian_kernel(sigma)
        x = convolve_separable(x[..., None], k, k, BorderMode.MIRROR)[..., 0]
    t1 = t0 and RECORDER.add("canny.smooth", t0)
    gx, gy = sobel_gradients(x, BorderMode.REPLICATE)
    magnitude = gradient_magnitude(gx, gy)
    t2 = t1 and RECORDER.add("canny.gradients", t1)
    nms = _quantized_nms(gx, gy, magnitude)
    t3 = t2 and RECORDER.add("canny.nms", t2)
    out = _hysteresis(nms, magnitude, low, high, "canny.test").to(
        torch.uint8) * 255
    if t0:
        RECORDER.add("canny", t0, RECORDER.add("canny.hysteresis", t3))
    return out


# ---------------------------------------------------------------------------
# Shen-Castan
# ---------------------------------------------------------------------------


def _along(axis: int, s: slice):
    """The index that applies ``s`` along the negative ``axis``."""
    return (Ellipsis, s) + (slice(None),) * (-1 - axis)


def _sl(x, axis: int, start: int, stop=None, step: int = 1):
    return x[_along(axis, slice(start, stop, step))]


def _combine(lhs, rhs):
    (a1, b1), (a2, b2) = lhs, rhs
    return a2 * a1, fma(a2, b1, b2)


def _interleave(even, odd, axis: int):
    shape = list(even.shape)
    shape[axis] += odd.shape[axis]
    out = even.new_empty(shape)
    out[_along(axis, slice(0, None, 2))] = even
    out[_along(axis, slice(1, None, 2))] = odd
    return out


def _associative_scan(a, b, axis: int):
    """Inclusive scan of ``(a, b)`` pairs along the negative ``axis``
    under ``_combine``, in ``jax.lax.associative_scan``'s order: combine
    adjacent pairs, scan the half recursively, then fill the even
    positions."""
    n = a.shape[axis]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine(
        (_sl(a, axis, 0, n - 1, 2), _sl(b, axis, 0, n - 1, 2)),
        (_sl(a, axis, 1, None, 2), _sl(b, axis, 1, None, 2))), axis)
    if n % 2 == 0:
        lhs = tuple(_sl(t, axis, 0, -1) for t in odd)
    else:
        lhs = odd
    even = _combine(lhs, (_sl(a, axis, 2, None, 2), _sl(b, axis, 2, None, 2)))
    even = [torch.cat([_sl(t, axis, 0, 1), e], dim=axis)
            for t, e in zip((a, b), even)]
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _isef_axis(x, b, axis: int):
    """Forward then backward first-order IIR along ``axis``
    (edges.zig isefFilter1D:281-303): ``temp_i = a * temp_{i-1} + b * x_i``
    from ``temp_0 = b * x_0``, then the same backward from the last
    ``temp``, with ``a = 1 - b``."""
    bf = torch.tensor(np.float32(b), device=x.device)
    coeff = np.float32(1.0 - b)

    def linear_scan(vals, first=None):
        bs = bf * vals
        if first is not None:
            bs = torch.cat([_sl(first, axis, 0, 1), _sl(bs, axis, 1)], dim=axis)
        avals = torch.full_like(bs, float(coeff))
        avals[_along(axis, slice(0, 1))] = 0
        return _associative_scan(avals, bs, axis)[1]

    trev = linear_scan(x).flip(axis)
    return linear_scan(trev, first=trev).flip(axis)


def isef_filter(x, b: float):
    """2-D ISEF of a float ``[..., H, W]`` plane: rows, then columns
    (edges.zig isefFilter2D:306-355)."""
    return _isef_axis(_isef_axis(x, b, -1), b, -2)


def shen_castan(gray_f32, smooth: float = 0.9, window_size: int = 7,
                high_ratio: float = 0.99, low_rel: float = 0.5,
                hysteresis: bool = True, use_nms: bool = False):
    """Shen-Castan ISEF edge detector of a 0-255 float ``[..., H, W]``
    plane -> u8 0/255 (reference: edges.zig shenCastan:84-210)."""
    h, w = gray_f32.shape[-2], gray_f32.shape[-1]
    smoothed = isef_filter(gray_f32, smooth)
    bli = (smoothed - gray_f32) >= 0

    if use_nms:  # 4-neighbour transitions, interior only
        edges = ((bli != _shift(bli, 0, -1)) | (bli != _shift(bli, 0, 1))
                 | (bli != _shift(bli, -1, 0)) | (bli != _shift(bli, 1, 0)))
        edges = edges & _interior(bli)
    else:  # forward-neighbour thinning: east, south, south-east, south-west
        cols = torch.arange(w, device=bli.device)
        rows = torch.arange(h, device=bli.device)[:, None]
        in_e, in_s, in_w = cols < w - 1, rows < h - 1, cols > 0
        edges = (((bli != _shift(bli, 0, 1)) & in_e)
                 | ((bli != _shift(bli, 1, 0)) & in_s)
                 | ((bli != _shift(bli, 1, 1)) & in_e & in_s)
                 | ((bli != _shift(bli, 1, -1)) & in_s & in_w))

    # adaptive gradients: |mean(gray where bli) - mean(gray where not)|
    radius = window_size // 2
    area = extents(h, radius)[:, None] * extents(w, radius)[None, :]
    area = torch.from_numpy(area).to(gray_f32.device)
    count1, sum1, sum_total = (
        window_sums(v, radius, (-2, -1)).to(torch.float32)
        for v in (bli.to(torch.uint8), gray_f32 * bli, gray_f32))
    count0 = area - count1
    sum0 = sum_total - sum1
    both = (count0 > 0) & (count1 > 0)
    mean0 = sum0 / torch.where(count0 == 0, 1.0, count0)
    mean1 = sum1 / torch.where(count1 == 0, 1.0, count1)
    gradients = torch.where(edges & both, (mean1 - mean0).abs(), 0.0)

    # percentile threshold over the edge pixels' gradient histogram
    bins = torch.floor(gradients.clamp(0, 255) + 0.5).to(torch.int32)
    hist = torch.stack([histogram256(v, m) for v, m in zip(
        bins.reshape(-1, h, w), edges.reshape(-1, h, w))])
    lead = gray_f32.shape[:-2] + (1, 1)
    total = hist.sum(-1)
    target = torch.floor(total.to(torch.float32) * float(np.float32(high_ratio)))
    reached = hist.cumsum(-1).to(torch.float32) >= target[:, None]
    k = torch.where(reached.any(-1), reached.to(torch.uint8).argmax(-1), 255)
    t_high = torch.clamp(k + 1, max=255).to(torch.float32)
    t_high = torch.where(target <= 0, 0.0, t_high)
    t_low = float(np.float32(low_rel)) * t_high
    t_high, t_low = t_high.reshape(lead), t_low.reshape(lead)

    if use_nms:
        half = float(np.float32(0.5))
        gx = half * (_shift(smoothed, 0, 1) - _shift(smoothed, 0, -1))
        gy = half * (_shift(smoothed, 1, 0) - _shift(smoothed, -1, 0))
        edges = edges & _quantized_nms(gx, gy, gradients)

    if hysteresis:
        out = _hysteresis(edges, gradients, t_low, t_high)
    else:
        out = edges & (gradients >= t_high)
    out = out & (total != 0).reshape(lead)
    return out.to(torch.uint8) * 255
