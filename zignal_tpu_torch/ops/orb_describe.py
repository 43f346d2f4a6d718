"""ORB's describe stage on a CUDA atlas of pyramid levels as one kernel
(``csrc/orb_describe.cu``): each selected keypoint's intensity-centroid
angle, its rotated BRIEF descriptor and its row, a warp a keypoint from
its window staged once in shared memory.

``describe(plane, resp, idx, table)`` takes the u8 atlas ``[B, H, W]`` of
``features/orb._Atlas``, the selected responses f32 ``[B, K]`` and flat
indices on their levels int64 ``[B, K]``, and the atlas's ``RowTable``,
checked on the host when it was built: each level lies inside the plane,
so the kernel reads nothing outside it, whatever the indices. It
returns the keypoint rows f32 ``[B, K, 5]`` (response, x, y, angle,
level), the descriptors u8 ``[B, K, 32]`` and validity bool ``[B, K]``,
equal bit for bit to ``_Atlas.describe_reference``, the plain version,
which a CPU plane takes. A CUDA plane launches the kernel or raises (K = 0
launches nothing); ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features._orb_pattern import ORB_PATTERN
from ._build import COUNT_LOCK, Plan, cached, launch, pack
from .orb_detect import _check

__all__ = ["RowTable", "describe"]

# kernel launches since import
LAUNCHES = 0

WARPS = 8  # keypoints a block (the kernel's constant)
HALF = 15  # the orientation patch's radius (features/orb.py PATCH_SIZE // 2)
PAIRS = np.asarray(ORB_PATTERN, np.int8)  # BRIEF's (x1, y1, x2, y2)
# the staged window's radius: a rotated sample is at most its pair point's
# norm from the keypoint in each coordinate, so its rounding at most that
# norm rounded; the window covers the orientation patch too, and its side
# is over 32 (the kernel's staging loop wraps a lane at most once a step)
REACH = max(HALF, 16, int(np.floor(np.hypot(PAIRS[:, 0::2].astype(float),
                                            PAIRS[:, 1::2]).max() + 0.5)))
TABLE_COLS = 8
_FIELDS = ("B", "H", "W", "K", "radius", "half", "warps")


class _DescribePlan(Plan):
    """The kernel's plan for one atlas shape: its DescribeParams, BRIEF's
    pairs after the fields (``buffer()``)."""

    __slots__ = ()
    FIELDS, LAYOUT = _FIELDS, "zt_orb_describe_params_bytes"

    def __init__(self, b, h, w, k):
        super().__init__(dict(B=b, H=h, W=w, K=k, radius=REACH, half=HALF,
                              warps=WARPS), (PAIRS,))

    def pack(self):
        return pack(self.FIELDS, self.fields, self.tail)


class RowTable:
    """The kernel's row table for a plane of ``hw`` = (H, W): int32
    ``[K, 8]`` on one device (``tensor``), each row's level, its place in
    the plane (row, column), its size (h, w), and its margin as the first
    x and y a valid keypoint may take and the x and the y it must lie
    before. ``rows`` (integers on the host) are checked as they are
    built: each level lies inside the plane."""

    __slots__ = ("tensor", "hw")

    def __init__(self, rows, hw, device):
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != TABLE_COLS or \
                rows.dtype.kind not in "iu" or \
                np.abs(rows).max(initial=0) >= 2 ** 31:
            raise ValueError(f"the table needs int32 rows of {TABLE_COLS} "
                             f"values, not {rows.dtype} {list(rows.shape)}")
        h, w = hw
        r, c, lh, lw = rows[:, 1:5].astype(np.int64).T
        out = (np.minimum(r, c) < 0) | (np.minimum(lh, lw) < 1) | \
            (r + lh > h) | (c + lw > w)
        if out.any():
            raise ValueError(f"row {int(np.argmax(out))}'s level "
                             f"{rows[np.argmax(out), 1:5].tolist()} lies "
                             f"outside the {h} x {w} plane")
        self.hw = (int(h), int(w))
        self.tensor = torch.from_numpy(rows.astype(np.int32)).to(device)


def _check_rows(plane, resp, idx, table):
    if not isinstance(table, RowTable) or \
            table.hw != tuple(plane.shape[1:]) or \
            table.tensor.device != plane.device:
        raise ValueError(f"the kernel needs the RowTable of a "
                         f"{list(plane.shape[1:])} plane on {plane.device}")
    b, k = plane.shape[0], table.tensor.shape[0]
    for name, t, dtype in (("resp", resp, torch.float32),
                           ("idx", idx, torch.int64)):
        if t.dtype != dtype or tuple(t.shape) != (b, k) or \
                not t.is_contiguous() or t.device != plane.device:
            raise ValueError(f"the kernel needs {name} as a contiguous "
                             f"{dtype} {[b, k]} on {plane.device}")


def describe(plane, resp, idx, table):
    """Angles, BRIEF and rows of the keypoints ``idx`` of the atlas
    ``plane`` (u8 ``[B, H, W]`` on a card) -> (f32 ``[B, K, 5]``, u8
    ``[B, K, 32]``, bool ``[B, K]``); the arguments as the module says."""
    global LAUNCHES
    _check(plane)
    _check_rows(plane, resp, idx, table)
    b, h, w = plane.shape
    k = table.tensor.shape[0]
    dev = plane.device
    rows = torch.empty((b, k, 5), dtype=torch.float32, device=dev)
    desc = torch.empty((b, k, PAIRS.shape[0] // 8), dtype=torch.uint8,
                       device=dev)
    valid = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b == 0 or k == 0:
        return rows, desc, valid
    plan = cached(_DescribePlan, b, h, w, k)
    launch("zt_orb_describe", dev, plane.data_ptr(), resp.data_ptr(),
           idx.data_ptr(), table.tensor.data_ptr(), rows.data_ptr(),
           desc.data_ptr(), valid.data_ptr(), plan.buffer())
    with COUNT_LOCK:
        LAUNCHES += 1
    return rows, desc, valid
