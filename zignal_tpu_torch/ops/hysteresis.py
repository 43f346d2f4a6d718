"""Canny's hysteresis on a card as one call of ``csrc/hysteresis.cu``: the
members of every 8-connected component of candidates that reaches ``low``
(or ``high``) and holds a pixel that reaches ``high``, found by union-find
in five launches whatever the frames hold, with no host wait. Equal bit for
bit to ``edges._hysteresis``, the plain growth to a fixpoint, which a CPU
plane takes.

``hysteresis_u8(candidate, magnitude, low, high)`` takes the bool NMS mask
and the f32 magnitude ``[..., H, W]`` on a card and returns the u8 0/255
edges; ``LAUNCHES`` counts its calls.
"""

from __future__ import annotations

import torch

from ._build import COUNT_LOCK, launch, sm_count

__all__ = ["hysteresis_u8"]

# calls since import, each five launches
LAUNCHES = 0

BLOCKS_PER_SM = 8  # the grid of each pass, in blocks of 256 threads


def _check(candidate, magnitude):
    if candidate.dtype != torch.bool or magnitude.dtype != torch.float32:
        raise ValueError("the kernel needs a bool candidate mask and an f32 "
                         "magnitude")
    if candidate.shape != magnitude.shape or candidate.ndim < 2:
        raise ValueError("the mask and the magnitude must be one [..., H, W]"
                         " shape")
    if candidate.device.type != "cuda" or magnitude.device != \
            candidate.device:
        raise ValueError(f"no kernel for device {candidate.device}")
    if candidate.numel() >= 2 ** 31:
        raise ValueError("too many pixels for the kernel's int32 labels")


def hysteresis_u8(candidate, magnitude, low: float, high: float):
    """u8 0/255 edges of ``candidate`` grown from ``magnitude >= high``
    through ``magnitude >= low``, 8-connected, within each ``[H, W]``
    plane."""
    global LAUNCHES
    _check(candidate, magnitude)
    candidate, magnitude = candidate.contiguous(), magnitude.contiguous()
    h, w = candidate.shape[-2:]
    n, dev = candidate.numel(), candidate.device
    out = torch.empty(candidate.shape, dtype=torch.uint8, device=dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    blocks = max(1, min(-(-n // 256), BLOCKS_PER_SM * sm_count(dev)))
    launch("zt_hysteresis", dev, candidate.data_ptr(), magnitude.data_ptr(),
           out.data_ptr(), labels.data_ptr(), flags.data_ptr(),
           n // (h * w) if n else 0, h, w, float(low), float(high), blocks)
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
