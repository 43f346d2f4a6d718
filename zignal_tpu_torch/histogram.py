"""Per-channel 256-bin histograms with statistics
(reference: src/image/histogram.zig).

Copied from zignal_tpu/histogram.py. The bins are counted on the image's
device (``ops.binary.histogram256_batch``); the statistics are host math
on the counts. Incremental add/remove supports sliding windows.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Histogram"]


class Histogram:
    """256-bin histogram per channel; channel names follow the image
    dtype (y / r,g,b / r,g,b,a)."""

    def __init__(self, values: np.ndarray, channels):
        self.values = np.asarray(values, dtype=np.uint32)  # [C, 256]
        self.channels = tuple(channels)

    @classmethod
    def from_image(cls, image) -> "Histogram":
        from .ops.binary import histogram256_batch

        dev = image._device()
        c = dev.shape[-1]
        counts = histogram256_batch(dev[None])[0]
        names = {1: ("y",), 3: ("r", "g", "b"), 4: ("r", "g", "b", "a")}[c]
        return cls(counts.cpu().numpy(), names)

    def channel(self, name: str) -> np.ndarray:
        return self.values[self.channels.index(name)]

    def total_pixels(self) -> int:
        return int(self.values[0].sum())

    def _stat_per_channel(self, fn):
        out = tuple(fn(self.values[i]) for i in range(len(self.channels)))
        return out[0] if len(out) == 1 else out

    def mean(self):
        def f(bins):
            total = bins.sum()
            if total == 0:
                return 0.0
            return float((bins * np.arange(256)).sum() / total)

        return self._stat_per_channel(f)

    def percentile(self, p: float):
        """Value at fraction p in [0, 1] (histogram.zig percentile:586)."""

        def f(bins):
            total = int(bins.sum())
            if total == 0:
                return 0
            rank = min(max(int(np.floor(p * (total - 1) + 1e-12)), 0), total - 1)
            return int(np.searchsorted(np.cumsum(bins), rank + 1))

        return self._stat_per_channel(f)

    def median(self):
        return self.percentile(0.5)

    def mode(self):
        return self._stat_per_channel(lambda bins: int(np.argmax(bins)))

    def variance(self):
        def f(bins):
            total = bins.sum()
            if total == 0:
                return 0.0
            vals = np.arange(256, dtype=np.float64)
            mu = (bins * vals).sum() / total
            return float((bins * (vals - mu) ** 2).sum() / total)

        return self._stat_per_channel(f)

    # incremental updates for sliding windows (histogram.zig add/remove)
    def add_value(self, channel: int, value: int):
        self.values[channel, value] += 1

    def remove_value(self, channel: int, value: int):
        if self.values[channel, value] == 0:
            raise ValueError("removing a value with zero count")
        self.values[channel, value] -= 1

    def __repr__(self):
        return f"Histogram(channels={self.channels}, total={self.total_pixels()})"
