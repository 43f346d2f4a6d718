"""The Hough transform of a batch on a card (``csrc/hough.cu``), with no
host wait: the votes of every frame's edges, read NEAREST through the
accumulator's row and column tables and counted in shared memory a block
of thetas at a time (``vote``), and each frame's lines, its peaks kept
greedily in ``find_lines``' order (``lines``). Equal bit for bit to the
plain route of ``ops/hough.py`` (``_vote`` after the NEAREST resize, and
``HoughTransform._kept``), which a CPU tensor takes.

``VOTE_LAUNCHES`` and ``LINES_LAUNCHES`` count the calls of each, each a
few launches.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np
import torch

from ._build import COUNT_LOCK, cached, check_layout, launch
from .tables import nearest_indices

__all__ = ["vote", "lines", "MAX_LINES"]

# calls of each since import
VOTE_LAUNCHES = 0
LINES_LAUNCHES = 0

MAX_LINES = 256  # the lines kernel's most lines a frame
MAX_THETAS = 16  # the most thetas a vote block counts
BIN_BYTES = 48 * 1024  # a vote block's shared bins, where they fit
_LAYOUT = "<8i5d"  # HoughParams: B H W S offset threshold max_lines
#                    thetas; angle_step half_even sqrt2 angle_thr
#                    radius_thr


def thetas(size: int) -> int:
    """The thetas a vote block counts: the most, a power of two, whose
    ``size`` bins each fit ``BIN_BYTES``, at least 1."""
    t = MAX_THETAS
    while t > 1 and size * t * 4 > BIN_BYTES:
        t //= 2
    return t


def _pack(b, h, w, size, offset, threshold, max_lines, thetas_, even,
          angle_thr, radius_thr):
    raw = struct.pack(_LAYOUT, b, h, w, size, offset, threshold, max_lines,
                      thetas_, 180.0 / even, even / 2.0, math.sqrt(2.0),
                      angle_thr, radius_thr)
    return check_layout("zt_hough_params_bytes",
                        ctypes.create_string_buffer(raw, len(raw)))


def _tables(h: int, w: int, size: int, device):
    """int32 NEAREST source rows and columns of the size x size plane."""
    return tuple(torch.from_numpy(nearest_indices(n, size).astype(np.int32))
                 .to(device) for n in (h, w))


def _check_planes(planes):
    if planes.dtype != torch.uint8 or planes.ndim != 3:
        raise ValueError("the vote kernel needs u8 [B, H, W] edge planes")
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")


def vote(planes, size: int, cos_t, sin_t, offset: int, even: int):
    """int32 ``[B, size, size]`` accumulators of the u8 edge planes ``[B,
    H, W]`` (> 0 is an edge) on a card, each read NEAREST at size x size;
    ``cos_t`` and ``sin_t`` are the int32 theta tables on the card."""
    global VOTE_LAUNCHES
    _check_planes(planes)
    b, h, w = planes.shape
    if b * size * size >= 2 ** 31:
        raise ValueError("too many bins for the kernel's int32 edge list")
    if b > 65535:
        raise ValueError("too many frames for one launch grid")
    dev = planes.device
    planes = planes.contiguous()
    rows, cols = cached(_tables, h, w, size, dev)
    acc = torch.empty((b, size, size), dtype=torch.int32, device=dev)
    edge_list = torch.empty(max(1, b * size * size), dtype=torch.int32,
                            device=dev)
    counts = torch.empty(max(1, b), dtype=torch.int32, device=dev)
    params = cached(_pack, b, h, w, size, offset, 0, 0, thetas(size), even,
                    0.0, 0.0)
    launch("zt_hough_vote", dev, planes.data_ptr(), rows.data_ptr(),
           cols.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
           edge_list.data_ptr(), counts.data_ptr(), acc.data_ptr(), params)
    with COUNT_LOCK:
        VOTE_LAUNCHES += 1
    return acc


def lines(acc, threshold, angle_thr: float, radius_thr: float,
          max_lines: int, even: int):
    """(int32 ``[B, max_lines, 3]`` rows, bool ``[B, max_lines]``
    validity) of the int32 accumulators ``[B, S, S]`` on a card, as
    ``HoughTransform.find_lines_tensors`` defines them."""
    global LINES_LAUNCHES
    if acc.dtype != torch.int32 or acc.ndim != 3 or acc.device.type != \
            "cuda":
        raise ValueError("the lines kernel needs int32 [B, S, S] "
                         "accumulators on a card")
    if not 0 <= max_lines <= MAX_LINES:
        raise ValueError(f"the lines kernel keeps 0 to {MAX_LINES} lines")
    b, size = acc.shape[0], acc.shape[1]
    dev = acc.device
    acc = acc.contiguous()
    rows = torch.empty((b, max_lines, 3), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_lines), dtype=torch.uint8, device=dev)
    if b and max_lines:
        # an integer score reaches the threshold where it reaches its
        # ceiling
        thr = float(threshold)
        thr = -(2 ** 31) if thr <= -(2 ** 31) else (
            2 ** 31 - 1 if thr >= 2 ** 31 - 1 else math.ceil(thr))
        cand = torch.empty(max(1, b * (size - 2) ** 2), dtype=torch.int64,
                           device=dev)
        counts = torch.empty(b, dtype=torch.int32, device=dev)
        params = cached(_pack, b, size, size, size, 0, thr, max_lines, 1,
                        even, float(angle_thr), float(radius_thr))
        launch("zt_hough_lines", dev, acc.data_ptr(), cand.data_ptr(),
               counts.data_ptr(), rows.data_ptr(), valid.data_ptr(), params)
        with COUNT_LOCK:
            LINES_LAUNCHES += 1
    return rows, valid.view(torch.bool)
