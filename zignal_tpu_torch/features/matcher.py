"""Brute-force Hamming matcher (reference: src/features/matcher.zig), the
counterpart of zignal_tpu/features/matcher.py.

The all-pairs Hamming distances of u8 descriptor rows run on the
descriptors' device in integers: xor, then each byte's popcount by
shifts and masks, summed over the 32 bytes in int32, chunked over the
query rows so that the xor stays under ``_CHUNK`` bytes.
``match_tensors`` matches batches of descriptor sets on the card: the
best train row of each query (the lowest index on ties, as ``np.argmin``
gives it), the cross-check and ``max_distance``, with nothing copied to
the host; ``BruteForceMatcher.match`` runs it on one pair. ``knn_match``
and ``radius_match`` copy the ``[N, M]`` matrix back and apply numpy's
stable sorts, as in the JAX package.

While a profiler session runs, ``match_tensors`` records the span
``match``; ``PAIRS`` counts the descriptor sets it matched on a CUDA
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops._build import COUNT_LOCK
from ..profiling import RECORDER, span_start
from .descriptor import stack_descriptors

__all__ = ["Match", "BruteForceMatcher", "MatchStats", "match_tensors"]

_CHUNK = 1 << 26  # xor bytes a chunk of query rows
PAIRS = 0  # descriptor sets matched on a CUDA device, under COUNT_LOCK


@dataclasses.dataclass
class Match:
    query_idx: int
    train_idx: int
    distance: float


@dataclasses.dataclass
class MatchStats:
    count: int
    min_distance: float
    max_distance: float
    mean_distance: float


def _popcount_u8(x):
    """Set bits of each byte of the u8 tensor ``x``, u8."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _distances(q, t):
    """int32 ``[P, N, M]`` Hamming distances of the u8 rows of ``q``
    ``[P, N, 32]`` and ``t`` ``[P, M, 32]``, on their device."""
    p, n, m = q.shape[0], q.shape[1], t.shape[1]
    out = torch.empty((p, n, m), dtype=torch.int32, device=q.device)
    step = max(1, _CHUNK // max(1, p * t[0].numel()))
    for i in range(0, n, step):
        xor = torch.bitwise_xor(q[:, i:i + step, None, :], t[:, None, :, :])
        out[:, i:i + step] = _popcount_u8(xor).sum(dim=-1, dtype=torch.int32)
    return out


def distance_matrix(a, b, device) -> np.ndarray:
    """int32 ``[N, M]`` Hamming distances of u8 ``[N, 32]`` and ``[M, 32]``
    descriptor matrices, computed on ``device``."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), dtype=np.int32)
    ta = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(device)
    return _distances(ta[None], tb[None])[0].to("cpu").numpy()


def match_tensors(q, q_valid, t, t_valid, *, cross_check: bool = True,
                  max_distance: int | None = None):
    """Match each of ``P`` query sets with its train set on their device:
    u8 descriptors ``q`` ``[P, N, 32]`` and ``t`` ``[P, M, 32]``, the rows
    that hold one marked by the bool ``q_valid`` ``[P, N]`` and
    ``t_valid`` ``[P, M]``. Returns (int64 ``[P, N]`` train rows, int32
    ``[P, N]`` distances): each valid query's nearest valid train row,
    the lowest on ties, and its distance; both -1 where the query is not
    valid, no train row is, the distance passes ``max_distance``, or the
    cross-check finds the train row's nearest valid query elsewhere.
    Nothing is copied to the host."""
    global PAIRS
    t0 = span_start()
    if q.dtype != torch.uint8 or t.dtype != torch.uint8 or q.ndim != 3 \
            or t.ndim != 3 or q.shape[0] != t.shape[0] \
            or q.shape[2] != t.shape[2]:
        raise ValueError("match_tensors needs u8 [P, N, D] and [P, M, D] "
                         "descriptors")
    if q_valid.shape != q.shape[:2] or t_valid.shape != t.shape[:2]:
        raise ValueError("a validity mask does not fit its descriptors")
    d0 = t0 and RECORDER.mark(q)
    p, n, m = q.shape[0], q.shape[1], t.shape[1]
    none = torch.full((p, n), -1, dtype=torch.int64, device=q.device)
    if n == 0 or m == 0:
        idx, dist = none, none.to(torch.int32)
    else:
        d = _distances(q, t)
        far = 8 * q.shape[2] + 1  # past any distance
        fwd = d.masked_fill(~t_valid[:, None, :], far)
        best = fwd.argmin(dim=2)
        dist = fwd.gather(2, best[..., None])[..., 0]
        keep = q_valid & (dist < far)
        if max_distance is not None:
            keep &= dist <= max_distance
        if cross_check:
            back = d.masked_fill(~q_valid[:, :, None], far).argmin(dim=1)
            rows = torch.arange(n, device=q.device)
            keep &= back.gather(1, best) == rows
        idx = torch.where(keep, best, none)
        dist = torch.where(keep, dist, -1)
    if q.device.type == "cuda":
        with COUNT_LOCK:
            PAIRS += p
    if t0:
        RECORDER.add("match", t0)
        d0 and RECORDER.add_device("match", d0, q)
    return idx, dist


class BruteForceMatcher:
    """match / knn_match / radius_match with optional cross-check
    (reference: matcher.zig:33-260) over lists of BinaryDescriptors;
    the distances are computed on ``device``."""

    def __init__(self, cross_check: bool = False,
                 max_distance: int | None = None, *, device):
        self.cross_check = cross_check
        self.max_distance = max_distance
        self.device = torch.device(device)

    def _dists(self, query, train):
        return distance_matrix(stack_descriptors(query),
                                stack_descriptors(train), self.device)

    def match(self, query, train) -> list:
        """The cross-checked (where set) nearest train descriptor of each
        query, by ``match_tensors`` on one pair."""
        if len(query) == 0 or len(train) == 0:
            return []
        q, t = (torch.from_numpy(stack_descriptors(d)).to(self.device)[None]
                for d in (query, train))
        idx, dist = match_tensors(
            q, torch.ones(q.shape[:2], dtype=torch.bool, device=q.device), t,
            torch.ones(t.shape[:2], dtype=torch.bool, device=t.device),
            cross_check=self.cross_check, max_distance=self.max_distance)
        idx, dist = idx[0].to("cpu").numpy(), dist[0].to("cpu").numpy()
        return [Match(qi, int(ti), float(dist[qi]))
                for qi, ti in enumerate(idx) if ti >= 0]

    def knn_match(self, query, train, k: int = 2) -> list:
        d = self._dists(query, train)
        out = []
        for qi in range(d.shape[0]):
            order = np.argsort(d[qi], kind="stable")[:k]
            out.append([Match(qi, int(ti), float(d[qi, ti])) for ti in order])
        return out

    def radius_match(self, query, train, max_distance: float) -> list:
        d = self._dists(query, train)
        out = []
        for qi in range(d.shape[0]):
            hits = np.nonzero(d[qi] <= max_distance)[0]
            order = hits[np.argsort(d[qi][hits], kind="stable")]
            out.append([Match(qi, int(ti), float(d[qi, ti])) for ti in order])
        return out

    @staticmethod
    def stats(matches) -> MatchStats:
        if not matches:
            return MatchStats(0, 0.0, 0.0, 0.0)
        ds = [m.distance for m in matches]
        return MatchStats(len(ds), min(ds), max(ds), sum(ds) / len(ds))
