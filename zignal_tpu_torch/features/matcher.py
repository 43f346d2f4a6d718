"""Brute-force Hamming matcher (reference: src/features/matcher.zig), the
counterpart of zignal_tpu/features/matcher.py.

The all-pairs Hamming distances of ``[N, 32]`` x ``[M, 32]`` u8
descriptor matrices run on the matcher's device: xor, then a 256-entry
popcount table, summed over the 32 bytes in int32 (chunked over the query
rows so the xor stays bounded). One device-to-host copy brings the
``[N, M]`` matrix back; the argmin, thresholds and the stable sorts of
the tie rules are numpy on it, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .descriptor import stack_descriptors

__all__ = ["Match", "BruteForceMatcher", "MatchStats"]

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int32)
_CHUNK = 1 << 22  # xor bytes a chunk of query rows


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


def distance_matrix(a, b, device) -> np.ndarray:
    """int32 ``[N, M]`` Hamming distances of u8 ``[N, 32]`` and ``[M, 32]``
    descriptor matrices, computed on ``device``."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), dtype=np.int32)
    ta = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(device)
    table = torch.from_numpy(_POPCOUNT).to(device)
    out = torch.empty((len(a), len(b)), dtype=torch.int32, device=device)
    step = max(1, _CHUNK // tb.numel())
    for i in range(0, len(a), step):
        xor = torch.bitwise_xor(ta[i:i + step, None, :], tb[None, :, :])
        out[i:i + step] = torch.take(table, xor.long()).sum(
            dim=-1, dtype=torch.int32)
    return out.to("cpu").numpy()


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
        d = self._dists(query, train)
        if d.size == 0:
            return []
        best = d.argmin(axis=1)
        matches = []
        rev_best = d.argmin(axis=0) if self.cross_check else None
        for qi, ti in enumerate(best):
            dist = int(d[qi, ti])
            if self.max_distance is not None and dist > self.max_distance:
                continue
            if self.cross_check and rev_best[ti] != qi:
                continue
            matches.append(Match(qi, int(ti), float(dist)))
        return matches

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
