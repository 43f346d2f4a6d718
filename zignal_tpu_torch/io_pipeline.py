"""Files -> device batches: the counterpart of zignal_tpu/io_pipeline.py.

Decodes on a host thread pool (the codecs' native loops release the
interpreter lock), letterboxes every image to a common shape on the
target device (``Image.letterbox``: K1 on the card), stacks the batch into
a pinned host buffer and copies it to the card with ``non_blocking=True``
on a copy stream of its own, so the copy overlaps device work already
queued. The consumer's stream waits on the copy and the batch is recorded
on that stream before it is handed out. ``BatchLoader`` keeps one batch in
flight: the next batch decodes and copies while the caller works on the
current one. With ``device="cpu"`` nothing is pinned and no stream is
used (the caller's request, not a fallback).

Each batch gets its own pinned buffer: PyTorch's pinned-memory allocator
does not hand a buffer out again until the copies queued from it have
completed, so a buffer is never overwritten under a copy in flight.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

__all__ = ["BatchLoader", "load_image_batch"]

_COPY_STREAMS: dict = {}


def _decode_one(path, shape, interpolation, device):
    from .codecs import load_array
    from .color._classes import Rgb
    from .enums import Interpolation
    from .image import Image

    img = Image.from_numpy(load_array(path), device=device)
    if img._space != "rgb":
        img = img.convert(Rgb)
    if shape is not None and (img.rows, img.cols) != tuple(shape):
        img = img.letterbox(shape, interpolation or Interpolation.BILINEAR)
    return img.to_numpy()


def _copy_stream(device):
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _load(paths, shape, interpolation, workers, device):
    """(batch tensor on ``device``, the event that ends its copy or None):
    the copy is queued, not waited for."""
    device = torch.device(device)
    if shape is not None:
        shape = (int(shape[0]), int(shape[1]))
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        arrays = list(pool.map(
            lambda p: _decode_one(p, shape, interpolation, device), paths))
    if device.type != "cuda":
        return torch.from_numpy(np.stack(arrays)).to(device), None
    host = torch.empty((len(arrays), *arrays[0].shape), dtype=torch.uint8,
                       pin_memory=True)
    np.stack(arrays, out=host.numpy())
    stream = _copy_stream(device)
    with torch.cuda.stream(stream):
        batch = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return batch, done


def _handed_out(batch, done):
    """Make the current stream wait for the batch's copy and record the
    batch on it (its memory came from the copy stream's pool)."""
    if done is not None:
        current = torch.cuda.current_stream(batch.device)
        current.wait_event(done)
        batch.record_stream(current)
    return batch


def load_image_batch(paths, shape=None, interpolation=None, workers=8, *,
                     device):
    """Decode ``paths`` in parallel -> one [B, H, W, 3] u8 tensor on
    ``device``, ready for work queued on the current stream."""
    return _handed_out(*_load(paths, shape, interpolation, workers, device))


class BatchLoader:
    """Iterator of device batches with one batch in flight.

    >>> for batch in BatchLoader(paths, batch_size=16, shape=(512, 512),
    ...                          device="cuda"):
    ...     out = pipeline(batch)   # the next batch decodes and copies
    """

    def __init__(self, paths, batch_size=16, shape=None, interpolation=None,
                 workers=8, drop_remainder=False, *, device):
        self.paths = list(paths)
        self.batch_size = int(batch_size)
        self.shape = shape
        self.interpolation = interpolation
        self.workers = workers
        self.drop_remainder = drop_remainder
        self.device = torch.device(device)

    def __len__(self):
        n = len(self.paths) // self.batch_size
        if not self.drop_remainder and len(self.paths) % self.batch_size:
            n += 1
        return n

    def _batches(self):
        for i in range(0, len(self.paths), self.batch_size):
            chunk = self.paths[i:i + self.batch_size]
            if self.drop_remainder and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        def load(chunk):
            return _load(chunk, self.shape, self.interpolation, self.workers,
                         self.device)

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ahead:
            pending = None
            for chunk in self._batches():
                nxt = ahead.submit(load, chunk)
                if pending is not None:
                    yield _handed_out(*pending.result())
                pending = nxt
            if pending is not None:
                yield _handed_out(*pending.result())
