"""Shape-bucketing policy for dynamic image sizes.

A stream of arbitrary photo sizes gives every size its own launch
configuration, its own caching-allocator blocks and, for a captured CUDA
graph, its own graph: a graph replays fixed shapes only. Normalizing sizes
on the host first keeps a pipeline on a handful of shapes:

- `bucket_shape(h, w)` rounds a size UP to a small set of buckets so a
  stream of mixed sizes hits a handful of shapes;
- `pad_to_bucket(arr)` zero-pads to that bucket and reports the valid
  region (crop after computing, or carry a mask);
- `BatchLoader(shape=...)` (io_pipeline) letterboxes every image to one
  canonical shape — the simplest and fastest policy when aspect
  preservation via letterboxing is acceptable.

Copied from zignal_tpu/shapes.py (host numpy).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DEFAULT_BUCKETS", "bucket_shape", "pad_to_bucket"]

# Power-of-two-ish ladder; multiples of 128 keep rows 128-byte aligned.
DEFAULT_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def bucket_shape(rows: int, cols: int, buckets=DEFAULT_BUCKETS):
    """Smallest (bucket_rows, bucket_cols) covering (rows, cols).
    Sizes above the largest bucket round up to a multiple of it."""

    def up(n):
        for b in buckets:
            if n <= b:
                return b
        top = buckets[-1]
        return ((n + top - 1) // top) * top

    return up(rows), up(cols)


def pad_to_bucket(arr: np.ndarray, buckets=DEFAULT_BUCKETS):
    """Zero-pad [H, W, C] (or [B, H, W, C]) to its bucket.

    Returns (padded, (rows, cols)) where (rows, cols) is the valid
    region of the original data."""
    h, w = arr.shape[-3], arr.shape[-2]
    bh, bw = bucket_shape(h, w, buckets)
    if (bh, bw) == (h, w):
        return arr, (h, w)
    pad = [(0, 0)] * arr.ndim
    pad[-3] = (0, bh - h)
    pad[-2] = (0, bw - w)
    return np.pad(arr, pad), (h, w)
