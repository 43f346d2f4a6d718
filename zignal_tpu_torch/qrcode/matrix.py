"""QR module matrix: function patterns, data placement, masks, penalty
(reference: src/qrcode/matrix.zig).

Copied from zignal_tpu/qrcode/matrix.py.
"""

from __future__ import annotations

import numpy as np

from .tables import (
    FORMAT_INFO, VERSION_INFO, EcLevel, alignment_positions, dimension,
)

__all__ = ["function_mask", "build_matrix", "mask_matrix", "penalty",
           "data_module_coords", "place_format_info", "place_version_info"]

_MASK_FNS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def function_mask(version: int):
    """(function_mask, base_modules): which modules are function patterns
    and their fixed values (format/version areas included, zeroed)."""
    n = dimension(version)
    is_fn = np.zeros((n, n), bool)
    mod = np.zeros((n, n), bool)

    def finder(r0, c0):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                r, c = r0 + dr, c0 + dc
                if 0 <= r < n and 0 <= c < n:
                    is_fn[r, c] = True
                    if 0 <= dr <= 6 and 0 <= dc <= 6:
                        ring = max(abs(dr - 3), abs(dc - 3))
                        mod[r, c] = ring in (0, 1, 3)  # dark center + border
    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)

    # timing patterns
    for i in range(8, n - 8):
        is_fn[6, i] = True
        mod[6, i] = i % 2 == 0
        is_fn[i, 6] = True
        mod[i, 6] = i % 2 == 0

    # alignment patterns
    pos = alignment_positions(version)
    for r0 in pos:
        for c0 in pos:
            in_finder = ((r0 < 9 and c0 < 9) or (r0 < 9 and c0 > n - 10)
                         or (r0 > n - 10 and c0 < 9))
            if in_finder:
                continue  # the three corner positions overlap finders
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    is_fn[r0 + dr, c0 + dc] = True
                    ring = max(abs(dr), abs(dc))
                    mod[r0 + dr, c0 + dc] = ring != 1

    # format info areas (reserved)
    for i in range(9):
        is_fn[8, i] = True
        is_fn[i, 8] = True
    for i in range(8):
        is_fn[8, n - 1 - i] = True
        is_fn[n - 1 - i, 8] = True
    # dark module
    is_fn[n - 8, 8] = True
    mod[n - 8, 8] = True

    # version info areas
    if version >= 7:
        for i in range(6):
            for j in range(3):
                is_fn[n - 11 + j, i] = True
                is_fn[i, n - 11 + j] = True
    return is_fn, mod


def data_module_coords(version: int):
    """Zigzag traversal coordinates of all data modules
    (matrix.zig data placement)."""
    n = dimension(version)
    is_fn, _ = function_mask(version)
    coords = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1  # skip the vertical timing column
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for dc in (0, -1):
                c = col + dc
                if not is_fn[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


def place_format_info(mat: np.ndarray, level: EcLevel, mask: int):
    n = mat.shape[0]
    bits = FORMAT_INFO[(level.format_bits << 3) | mask]
    get = lambda i: (bits >> (14 - i)) & 1  # noqa: E731 - bit accessor

    # around top-left finder
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
                (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    # split between bottom-left and top-right
    coords_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
                (n - 6, 8), (n - 7, 8),
                (8, n - 8), (8, n - 7), (8, n - 6), (8, n - 5), (8, n - 4),
                (8, n - 3), (8, n - 2), (8, n - 1)]
    for i, (r, c) in enumerate(coords_a):
        mat[r, c] = get(i)
    for i, (r, c) in enumerate(coords_b):
        mat[r, c] = get(i)


def place_version_info(mat: np.ndarray, version: int):
    if version < 7:
        return
    n = mat.shape[0]
    bits = VERSION_INFO[version]
    for i in range(18):
        bit = (bits >> i) & 1
        r = i // 3
        c = n - 11 + i % 3
        mat[c, r] = bit  # bottom-left block
        mat[r, c] = bit  # top-right block


def mask_matrix(version: int, mask: int) -> np.ndarray:
    n = dimension(version)
    rr, cc = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    fn = _MASK_FNS[mask]
    return fn(rr, cc)


def build_matrix(version: int, level: EcLevel, codewords: bytes,
                 mask: int) -> np.ndarray:
    """Full module matrix (bool, True=dark) for the given mask."""
    is_fn, base = function_mask(version)
    mat = base.copy()
    coords = data_module_coords(version)
    bits = np.unpackbits(np.frombuffer(codewords, dtype=np.uint8))
    for i, (r, c) in enumerate(coords):
        bit = bits[i] if i < len(bits) else 0
        mat[r, c] = bool(bit)
    m = mask_matrix(version, mask)
    mat = np.where(is_fn, mat, mat ^ m)
    place_format_info(mat, level, mask)
    place_version_info(mat, version)
    return mat.astype(bool)


def penalty(mat: np.ndarray) -> int:
    """Mask evaluation score, ISO rules N1-N4 (matrix.zig:233-300)."""
    n = mat.shape[0]
    score = 0
    m = mat.astype(np.int8)

    # N1: runs of >= 5 same-colored modules, rows and columns
    for axis_mat in (m, m.T):
        for row in axis_mat:
            run = 1
            for i in range(1, n):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + (run - 5)
                    run = 1
            if run >= 5:
                score += 3 + (run - 5)

    # N2: 2x2 blocks of same color
    blocks = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    score += 3 * int(blocks.sum())

    # N3: finder-like patterns 1011101 with 4 light modules on either side
    pattern = np.array([1, 0, 1, 1, 1, 0, 1], dtype=np.int8)
    light4 = np.zeros(4, dtype=np.int8)
    p1 = np.concatenate([light4, pattern])
    p2 = np.concatenate([pattern, light4])
    for axis_mat in (m, m.T):
        for row in axis_mat:
            for start in range(n - 10):
                seg = row[start:start + 11]
                if np.array_equal(seg, p1) or np.array_equal(seg, p2):
                    score += 40

    # N4: dark module proportion
    dark = int(m.sum())
    percent = dark * 100 // (n * n)
    prev5 = abs(percent - percent % 5 - 50) // 5
    next5 = abs(percent + (5 - percent % 5) % 5 - 50) // 5
    score += 10 * min(prev5, next5)
    return score
