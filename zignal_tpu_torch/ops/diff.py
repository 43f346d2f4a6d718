"""Per-pixel image difference + stats (reference: src/image/diff.zig).

Copied from zignal_tpu/ops/diff.py: host numpy, the per-image oracle of
``Image.diff``; ``ImageBatch.diff`` computes the same visualisation on
the device.

Semantics mirror diff.zig:27 `compute`:
- per-channel absolute difference; `threshold` is a strict `>` test that
  drives `diff_count` and binary mode, but does NOT mask values in
  scale mode
- binary mode sets every channel of a differing pixel to 255
- `force_opaque` pins the alpha channel (4-channel images) to 255
- stats run over the OUTPUT channel values (RunningStats summary)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..stats import RunningStats

__all__ = ["DiffOptions", "DiffResult", "compute"]


@dataclasses.dataclass
class DiffOptions:
    """(reference: diff.zig:7 DiffOptions)"""

    threshold: float = 0.0
    scale: float = 1.0
    binary: bool = False
    force_opaque: bool = False


@dataclasses.dataclass
class DiffResult:
    """(reference: diff.zig:19 DiffResult)"""

    stats: RunningStats
    diff_count: int


def compute(a: np.ndarray, b: np.ndarray, opts: DiffOptions | None = None):
    """-> (uint8 difference visualization, DiffResult)."""
    opts = opts or DiffOptions()
    if a.shape != b.shape:
        raise ValueError("images must have the same dimensions")
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    pixel_differs = (d > opts.threshold).any(axis=-1)
    diff_count = int(pixel_differs.sum())

    if opts.binary:
        vis = np.where(pixel_differs[..., None], 255, 0).astype(np.uint8)
        vis = np.broadcast_to(vis, a.shape).copy()
    else:
        vis = np.clip(np.floor(d * np.float32(opts.scale) + 0.5),
                      0, 255).astype(np.uint8)
    if opts.force_opaque and a.shape[-1] == 4:
        vis[..., 3] = 255

    stats = RunningStats()
    stats.extend(vis.astype(np.float64).ravel())
    return vis, DiffResult(stats=stats, diff_count=diff_count)
