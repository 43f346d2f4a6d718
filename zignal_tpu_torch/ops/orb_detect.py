"""ORB's detect stage on a CUDA atlas of pyramid levels as one kernel
(``csrc/orb_detect.cu``): FAST, its non-maximum suppression and the
Harris response (or the FAST score) of every kept level, written in the
candidates' level order.

``candidates(plane, levels, n, harris)`` takes the u8 atlas ``[B, H, W]``
of ``features/orb._Atlas`` and its level table: for each kept level, in
level order, ``(row, col, h, w, threshold, start)``, its place in the
plane, its size, its FAST threshold and its first candidate. It returns
f32 ``[B, n]``: a pixel's response where the NMS keeps it, -inf elsewhere,
equal bit for bit to ``_Atlas.candidates_reference``, the plain version,
which a CPU plane takes. A CUDA plane launches the kernel or raises;
``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import COUNT_LOCK, Plan, cached, launch, pack

__all__ = ["candidates"]

# kernel launches since import
LAUNCHES = 0

TILE = (32, 64)  # the kernel's tile, rows and columns (its constants)
MAX_LEVELS = 32  # levels the parameter struct holds
_FIELDS = ("B", "H", "W", "N", "levels", "tile_rows", "tile_cols")


class _DetectPlan(Plan):
    """The kernel's plan for one atlas: its DetectParams, the level table
    after the fields (``buffer()``)."""

    __slots__ = ()
    FIELDS, LAYOUT = _FIELDS, "zt_orb_detect_params_bytes"

    def __init__(self, b, h, w, n, levels):
        _check_levels(b, h, w, n, levels)
        table = np.zeros((6, MAX_LEVELS), np.int32)
        table[:, :len(levels)] = np.array(levels, np.int64).T
        super().__init__(dict(B=b, H=h, W=w, N=n, levels=len(levels),
                              tile_rows=TILE[0], tile_cols=TILE[1]),
                         (table,))

    def pack(self):
        return pack(self.FIELDS, self.fields, self.tail)


def _check_levels(b, h, w, n, levels):
    """Raise unless the kernel can take the table: 1 to ``MAX_LEVELS``
    levels, each inside the plane and its candidates inside ``[0, n)``."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, not "
                         f"{len(levels)}")
    for r, c, lh, lw, _, start in levels:
        if min(r, c, start) < 0 or min(lh, lw) < 1 or r + lh > h or \
                c + lw > w or start + lh * lw > n:
            raise ValueError(f"level ({r}, {c}, {lh}, {lw}) at {start} "
                             f"lies outside the plane or the candidates")
    if n >= 2 ** 31 or b > 65535 or -(-h // TILE[0]) > 65535:
        raise ValueError("atlas too large for one launch grid")


def _check(plane):
    if not isinstance(plane, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if plane.dtype != torch.uint8 or plane.ndim != 3:
        raise ValueError("the kernel needs a uint8 [B, H, W] plane")
    if not plane.is_contiguous():
        raise ValueError("the kernel needs a contiguous plane")
    if plane.device.type != "cuda":
        raise ValueError(f"no kernel for device {plane.device}")


def candidates(plane, levels, n: int, harris: bool):
    """FAST, NMS and response of the atlas ``plane`` (u8 ``[B, H, W]`` on
    a card) in level order -> f32 ``[B, n]``; ``levels`` as the module
    says."""
    global LAUNCHES
    _check(plane)
    b, h, w = plane.shape
    plan = cached(_DetectPlan, b, h, w, n, levels)
    out = torch.empty((b, n), dtype=torch.float32, device=plane.device)
    launch("zt_orb_detect", plane.device, plane.data_ptr(), out.data_ptr(),
           int(bool(harris)), plan.buffer())
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
