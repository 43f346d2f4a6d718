"""Flood fill on the device (reference: src/image/flood_fill.zig:5-131),
the counterpart of zignal_tpu/ops/flood_fill.py.

The reference's stack DFS computes an order-independent fixed point:

- SEED mode: the connected component (4/8-connectivity) of the seed
  inside the candidate mask ``dist(pixel, seed) <= threshold``;
- NEIGHBOR mode: the transitive closure of the seed over the symmetric
  edge relation ``dist(pixel, neighbor) <= threshold``.

Both grow a boolean region mask ``[..., H, W]`` until it stops changing.
Each iteration propagates runs along rows and then columns without bound
(JAX's segmented ORs ``s[j] = a[j] | (b[j] & s[j-1])`` forward and
backward, each of which crosses a whole row in one step) and then dilates
one hop in every direction (diagonals too), so the loop takes O(number of
turns in the region) iterations, not O(region diameter). PyTorch has no
associative scan over booleans, but the gates never change: where each
pixel's forward run may start and its backward run end is found once
(``_run_bounds``), and an iteration counts the region along the axis with
one ``cumsum``: a pixel is reached when its run holds a region pixel,
``A[j] > A'[start(j)]`` forward and ``A[end(j)] > A'[j]`` backward, with
``A`` the inclusive and ``A'`` the exclusive count. Both directions from
the same count give what JAX's forward-then-backward scans give, so the
iterations are JAX's. Columns are counted on the transposed plane, where
the scan is along the innermost dimension (much faster on the card at one
image). The stop test is one host sync an iteration; ``ITERATIONS``
counts them.

Distances: the reference compares f64 Euclidean distances; the pixels
are u8, so the squared distance is a small exact integer, compared with
the largest int N with sqrt(N) <= threshold (``threshold_sq_int``, copied
from the JAX package): the reference's f64 compare, exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import COUNT_LOCK

__all__ = ["fill_region", "flood_region", "threshold_sq_int", "ITERATIONS"]

_OFFSETS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_OFFSETS8 = _OFFSETS4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))

ITERATIONS = 0  # propagation iterations run, over every call


def threshold_sq_int(threshold: float) -> int:
    """Largest integer N with sqrt(N) <= threshold (f64 math), so the
    reference's ``dist <= threshold`` becomes ``sq_dist <= N``."""
    thr = float(threshold)
    if thr < 0:
        return -1
    n = int(np.floor(thr * thr))
    while n > 0 and np.sqrt(n) > thr:
        n -= 1
    while np.sqrt(n + 1.0) <= thr:
        n += 1
    return n


def _shift(m: torch.Tensor, dr: int, dc: int, dim: int) -> torch.Tensor:
    """out[..., r, c, ...] = m[..., r + dr, c + dc, ...] with rows and cols
    at dims (dim, dim + 1); zeros (False) outside."""
    out = torch.zeros_like(m)
    dst, src = _windows(m.shape[dim], m.shape[dim + 1], dr, dc,
                        dim % m.ndim)
    out[dst] = m[src]
    return out


def _windows(h: int, w: int, dr: int, dc: int, lead: int):
    """The index pair of a shift by (dr, dc): ``out[dst] = m[src]``."""
    pre = (slice(None),) * lead
    dst = pre + (slice(max(-dr, 0), h - max(dr, 0)),
                 slice(max(-dc, 0), w - max(dc, 0)))
    src = pre + (slice(max(dr, 0), h - max(-dr, 0)),
                 slice(max(dc, 0), w - max(-dc, 0)))
    return dst, src


def _run_bounds(gate_fwd: torch.Tensor, gate_rev: torch.Tensor):
    """Along the last dim: for each j, the first index its forward run may
    come from (the last k <= j whose ``gate_fwd`` is shut, else 0) and the
    last its backward run may come from (the first k >= j whose
    ``gate_rev`` is shut, else n - 1). ``gate[j]`` admits propagation INTO
    j from its predecessor in that direction."""
    n = gate_fwd.shape[-1]
    idx = torch.arange(n, device=gate_fwd.device)
    start = torch.cummax(torch.where(gate_fwd, 0, idx), dim=-1).values
    flipped = torch.where(gate_rev.flip(-1), 0, idx)
    end = (n - 1) - torch.cummax(flipped, dim=-1).values.flip(-1)
    return start, end


def _runs(region: torch.Tensor, start: torch.Tensor,
          end: torch.Tensor) -> torch.Tensor:
    """Every pixel whose forward or backward run along the last dim holds a
    pixel of ``region``."""
    count = torch.cumsum(region, dim=-1, dtype=torch.int32)
    before = count - region.to(torch.int32)
    return (count > before.gather(-1, start)) | \
        (count.gather(-1, end) > before)


def _edge_mask(img: torch.Tensor, dr: int, dc: int, thr_sq: int):
    """dist(img[p], img[p + (dr, dc)])^2 <= thr_sq, False out of bounds;
    img is int32 [..., H, W, C]."""
    d = img - _shift(img, dr, dc, -3)
    inb = _shift(torch.ones(img.shape[:-1], dtype=torch.bool,
                            device=img.device), dr, dc, -2)
    return ((d * d).sum(dim=-1) <= thr_sq) & inb


def flood_region(img_u8: torch.Tensor, row: int, col: int, thr_sq: int,
                 connectivity: int = 4,
                 neighbor_mode: bool = False) -> torch.Tensor:
    """Region mask ``[..., H, W]`` of a flood fill from (row, col) of every
    image of ``img_u8`` ``[..., H, W, C]`` u8, on its device."""
    global ITERATIONS
    img = img_u8.to(torch.int32)
    offsets = _OFFSETS8 if connectivity == 8 else _OFFSETS4
    seed = torch.zeros(img.shape[:-1], dtype=torch.bool, device=img.device)
    seed[..., row, col] = True

    if neighbor_mode:
        gates = {d: _edge_mask(img, d[0], d[1], thr_sq) for d in offsets}
    else:
        d = img - img[..., row:row + 1, col:col + 1, :]
        cand = ((d * d).sum(dim=-1) <= thr_sq) | seed
        gates = {d: cand for d in offsets}

    # run gates: entry INTO j from j-1 (forward) or j+1 (backward) -- the
    # (0,-1)/(0,1)/(-1,0)/(1,0) edge masks; columns on the transposed plane
    rows = _run_bounds(gates[(0, -1)], gates[(0, 1)])
    cols = _run_bounds(gates[(-1, 0)].transpose(-1, -2).contiguous(),
                       gates[(1, 0)].transpose(-1, -2).contiguous())
    hops = [(_windows(img.shape[-3], img.shape[-2], dr, dc, img.ndim - 3),
             gates[(dr, dc)]) for dr, dc in offsets]
    region = seed
    iterations = 0
    while True:
        new = region | _runs(region, *rows)
        new = new | _runs(new.transpose(-1, -2), *cols).transpose(-1, -2)
        for (dst, src), gate in hops:  # one hop at a time, as JAX's loop
            new[dst] |= new[src] & gate[dst]
        iterations += 1
        if not bool((new != region).any()):
            break
        region = new
    with COUNT_LOCK:
        ITERATIONS += iterations
    return region


def fill_region(img_u8: torch.Tensor, row, col, threshold: float = 0.0,
                connectivity: int = 4, mode=None) -> torch.Tensor:
    """The checked flood fill of ``Image.flood_fill`` and
    ``ImageBatch.flood_fill``: the region mask ``[..., H, W]`` of a fill
    from (row, col) of ``img_u8`` ``[..., H, W, C]``, ``mode`` a
    ThresholdMode (default SEED)."""
    from ..enums import ThresholdMode

    row, col = int(row), int(col)
    if not (0 <= row < img_u8.shape[-3] and 0 <= col < img_u8.shape[-2]):
        raise ValueError("seed coordinates out of bounds")
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    mode = ThresholdMode.SEED if mode is None else ThresholdMode(mode)
    return flood_region(img_u8, row, col, threshold_sq_int(float(threshold)),
                        connectivity=connectivity,
                        neighbor_mode=mode == ThresholdMode.NEIGHBOR)
