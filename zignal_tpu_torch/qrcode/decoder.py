"""QR decoder: binarize -> finder scan -> homography sample -> format
read -> RS correction -> segment parse (reference: src/qrcode/detector.zig,
decoder.zig). Handles rotation, mirroring, and moderate perspective.

Copied from zignal_tpu/qrcode/decoder.py but for the binarization, which
runs on the image's device through the port's adaptive mean threshold and
Otsu threshold; the finder scan, sampling and decoding stay host numpy on
the dark mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.binary import adaptive_mean_threshold, otsu_threshold
from .galois import RSError, rs_decode
from .matrix import data_module_coords, function_mask, mask_matrix
from .tables import FORMAT_INFO, EcLevel, dimension, ec_blocks

__all__ = ["QrDecodeResult", "decode_image", "decode_matrix", "QrDecodeError"]

_ALPHANUMERIC = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"


class QrDecodeError(ValueError):
    pass


@dataclasses.dataclass
class QrDecodeResult:
    text: str
    version: int
    ec_level: EcLevel
    mask: int
    corrected_errors: int = 0
    data: bytes = b""
    corners: list | None = None


# ---------------------------------------------------------------------------
# Bitstream decoding of a sampled module matrix
# ---------------------------------------------------------------------------


def _read_format(mat: np.ndarray):
    """Read + BCH-correct the format info; try both copies
    (reference: qrcode/matrix.zig:165)."""
    n = mat.shape[0]
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
                (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    coords_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
                (n - 6, 8), (n - 7, 8),
                (8, n - 8), (8, n - 7), (8, n - 6), (8, n - 5), (8, n - 4),
                (8, n - 3), (8, n - 2), (8, n - 1)]

    def bits_of(coords):
        v = 0
        for r, c in coords:
            v = (v << 1) | int(mat[r, c])
        return v

    best = None
    for raw in (bits_of(coords_a), bits_of(coords_b)):
        for idx, fmt in enumerate(FORMAT_INFO):
            dist = bin(raw ^ fmt).count("1")
            if best is None or dist < best[0]:
                best = (dist, idx)
    if best is None or best[0] > 3:
        raise QrDecodeError("unreadable format information")
    value = best[1]
    level = EcLevel.from_format_bits(value >> 3)
    mask = value & 7
    return level, mask


def decode_matrix(mat: np.ndarray) -> QrDecodeResult:
    """Decode a sampled boolean module matrix (True = dark)."""
    n = mat.shape[0]
    if (n - 17) % 4 != 0 or not 21 <= n <= 177:
        raise QrDecodeError(f"invalid matrix dimension {n}")
    version = (n - 17) // 4
    level, mask = _read_format(mat)

    is_fn, _ = function_mask(version)
    unmasked = np.where(is_fn, mat, mat ^ mask_matrix(version, mask))
    coords = data_module_coords(version)
    bits = np.array([unmasked[r, c] for r, c in coords], dtype=np.uint8)
    codewords = np.packbits(bits[: len(bits) // 8 * 8])

    blocks = ec_blocks(version, level)
    lengths = blocks.block_lengths()
    total_blocks = blocks.total_blocks

    # de-interleave (reference: tables.zig InterleaveIterator)
    data_parts = [bytearray() for _ in range(total_blocks)]
    ecc_parts = [bytearray() for _ in range(total_blocks)]
    pos = 0
    for i in range(max(lengths)):
        for b in range(total_blocks):
            if i < lengths[b]:
                data_parts[b].append(codewords[pos])
                pos += 1
    for i in range(blocks.ec_per_block):
        for b in range(total_blocks):
            ecc_parts[b].append(codewords[pos])
            pos += 1

    corrected = 0
    payload = bytearray()
    for b in range(total_blocks):
        blk = bytearray(bytes(data_parts[b]) + bytes(ecc_parts[b]))
        try:
            corrected += rs_decode(blk, blocks.ec_per_block)
        except RSError as e:
            raise QrDecodeError(f"block {b}: {e}") from e
        payload.extend(blk[: lengths[b]])

    raw = _read_segments(bytes(payload), version)
    text = raw.decode("utf-8", errors="replace")
    return QrDecodeResult(text, version, level, mask, corrected, data=raw)


def _read_segments(data: bytes, version: int) -> bytes:
    """Parse the data bitstream segments -> raw payload bytes
    (reference: segment.zig:173)."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    pos = 0
    out = []

    def take(n):
        nonlocal pos
        if pos + n > len(bits):
            raise QrDecodeError("truncated bitstream")
        v = 0
        for b in bits[pos:pos + n]:
            v = (v << 1) | int(b)
        pos += n
        return v

    def count_bits(mode):
        if version <= 9:
            return {1: 10, 2: 9, 4: 8}[mode]
        if version <= 26:
            return {1: 12, 2: 11, 4: 16}[mode]
        return {1: 14, 2: 13, 4: 16}[mode]

    while pos + 4 <= len(bits):
        mode = take(4)
        if mode == 0:  # terminator
            break
        if mode == 1:  # numeric
            count = take(count_bits(1))
            while count >= 3:
                out.append(f"{take(10):03d}".encode())
                count -= 3
            if count == 2:
                out.append(f"{take(7):02d}".encode())
            elif count == 1:
                out.append(str(take(4)).encode())
        elif mode == 2:  # alphanumeric
            count = take(count_bits(2))
            while count >= 2:
                v = take(11)
                out.append((_ALPHANUMERIC[v // 45] + _ALPHANUMERIC[v % 45]).encode())
                count -= 2
            if count:
                out.append(_ALPHANUMERIC[take(6)].encode())
        elif mode == 4:  # byte
            count = take(count_bits(4))
            out.append(bytes(take(8) for _ in range(count)))
        elif mode == 7:  # ECI — skip designator
            take(8)
        else:
            raise QrDecodeError(f"unsupported segment mode {mode}")
    return b"".join(out)


# ---------------------------------------------------------------------------
# Detection in an image
# ---------------------------------------------------------------------------


def _binarize(plane: torch.Tensor) -> np.ndarray:
    """Adaptive-mean binarization, Otsu fallback (detector.zig), of a u8
    [H, W] plane on its device; the dark mask comes back to the host."""
    radius = max(8, min(plane.shape) // 16)
    dark = adaptive_mean_threshold(plane, radius, 5.0) == 0  # dark modules
    frac = int(dark.sum()) / dark.numel()
    if frac < 0.05 or frac > 0.95:
        dark = plane <= otsu_threshold(plane)
    return dark.cpu().numpy()


def _finder_candidates(dark: np.ndarray):
    """Scan rows and columns for 1:1:3:1:1 run patterns; cluster centers
    (reference: detector.zig finder-pattern scan)."""
    h, w = dark.shape
    hits = []

    def scan_line(line, fixed, is_row):
        # run-length encode
        n = len(line)
        idx = np.flatnonzero(np.diff(line.astype(np.int8))) + 1
        bounds = np.concatenate([[0], idx, [n]])
        values = line[bounds[:-1]]
        lengths = np.diff(bounds)
        for i in range(len(lengths) - 4):
            if not values[i]:
                continue  # pattern starts dark
            a, b, c, d, e = lengths[i:i + 5]
            unit = (a + b + c + d + e) / 7.0
            if unit < 1:
                continue
            if (abs(a - unit) <= unit * 0.75 and abs(b - unit) <= unit * 0.75
                    and abs(c - 3 * unit) <= 1.5 * unit
                    and abs(d - unit) <= unit * 0.75
                    and abs(e - unit) <= unit * 0.75):
                center = bounds[i] + a + b + c / 2.0
                if is_row:
                    hits.append((fixed, center, unit, True))
                else:
                    hits.append((center, fixed, unit, False))

    for r in range(h):
        scan_line(dark[r], r, True)
    for c in range(w):
        scan_line(dark[:, c], c, False)

    # cluster nearby hits (tight radius; need both row and column support)
    clusters = []
    for (y, x, unit, is_row) in hits:
        for cl in clusters:
            if (abs(cl["y"] / cl["n"] - y) < 2 * unit
                    and abs(cl["x"] / cl["n"] - x) < 2 * unit):
                cl["y"] += y
                cl["x"] += x
                cl["u"] += unit
                cl["n"] += 1
                cl["rows" if is_row else "cols"] += 1
                break
        else:
            clusters.append({"y": y, "x": x, "u": unit, "n": 1,
                             "rows": 1 if is_row else 0,
                             "cols": 0 if is_row else 1})
    centers = []
    for cl in clusters:
        if cl["rows"] < 2 or cl["cols"] < 2:
            continue
        refined = _refine_center(dark, cl["y"] / cl["n"], cl["x"] / cl["n"])
        if refined is not None:
            centers.append((*refined, cl["n"]))
    # dedupe refined centers
    unique = []
    for c in centers:
        if not any(abs(c[0] - u[0]) < c[2] and abs(c[1] - u[1]) < c[2]
                   for u in unique):
            unique.append(c)
    unique.sort(key=lambda t: -t[3])
    return unique[:8]


def _run_pattern_at(line, pos):
    """Find the 1:1:3:1:1 pattern whose center run contains `pos`;
    returns (center, unit) or None."""
    n = len(line)
    idx = np.flatnonzero(np.diff(line.astype(np.int8))) + 1
    bounds = np.concatenate([[0], idx, [n]])
    values = line[bounds[:-1]]
    lengths = np.diff(bounds)
    seg = int(np.searchsorted(bounds, pos, side="right")) - 1
    for i in range(max(0, seg - 4), min(seg + 1, len(lengths) - 4)):
        if not values[i]:
            continue
        if not (bounds[i + 2] <= pos < bounds[i + 3]):
            continue  # pos must be inside the middle (3x) run
        a, b, c, d, e = lengths[i:i + 5]
        unit = (a + b + c + d + e) / 7.0
        if unit < 1:
            continue
        if (abs(a - unit) <= unit * 0.6 and abs(b - unit) <= unit * 0.6
                and abs(c - 3 * unit) <= 1.2 * unit
                and abs(d - unit) <= unit * 0.6
                and abs(e - unit) <= unit * 0.6):
            return bounds[i] + a + b + c / 2.0, unit
    return None


def _refine_center(dark, y, x):
    """Strict cross-check: the row and column through the center must both
    show the 1:1:3:1:1 pattern; recenter on them."""
    h, w = dark.shape
    r = min(max(int(round(y)), 0), h - 1)
    c = min(max(int(round(x)), 0), w - 1)
    row = _run_pattern_at(dark[r], c)
    if row is None:
        return None
    col = _run_pattern_at(dark[:, int(round(row[0]))], r)
    if col is None:
        return None
    return (col[0], row[0], (row[1] + col[1]) / 2.0)


def _best_finder_triple(centers):
    """Choose the 3 candidates most likely to be the real finders: data
    regions can produce spurious 1:1:3:1:1 hits, so score every triple by
    module-size consistency and right-angle/equal-arm geometry
    (reference detector.zig clusters by module size the same way)."""
    import itertools

    if len(centers) == 3:
        return list(centers)
    best = None
    best_score = None
    for tri in itertools.combinations(centers, 3):
        units = [c[2] for c in tri]
        u_mean = sum(units) / 3.0
        u_spread = (max(units) - min(units)) / u_mean
        pts = [(c[1], c[0]) for c in tri]
        d2 = sorted(
            (pts[i][0] - pts[j][0]) ** 2 + (pts[i][1] - pts[j][1]) ** 2
            for i, j in itertools.combinations(range(3), 2)
        )
        if d2[0] == 0:
            continue
        # right isosceles: equal short arms, hypotenuse^2 = sum of arm^2
        arm_ratio = d2[1] / d2[0]            # ~1 for equal arms
        hyp_ratio = d2[2] / (d2[0] + d2[1])  # ~1 for a right angle
        score = u_spread * 4 + abs(arm_ratio - 1.0) + abs(hyp_ratio - 1.0)
        if best_score is None or score < best_score:
            best_score = score
            best = list(tri)
    if best is None:
        raise QrDecodeError("no consistent finder triple")
    return best


def _order_finders(centers):
    """Pick 3 finder centers and label (top-left, top-right, bottom-left)."""
    if len(centers) < 3:
        raise QrDecodeError("fewer than three finder patterns found")
    chosen = _best_finder_triple(centers)
    pts = [(c[1], c[0]) for c in chosen]  # (x, y)

    # top-left = corner where the two edges are longest/perpendicular:
    # the point NOT on the longest pairwise segment
    import itertools

    d = {}
    for i, j in itertools.combinations(range(3), 2):
        d[(i, j)] = ((pts[i][0] - pts[j][0]) ** 2 + (pts[i][1] - pts[j][1]) ** 2)
    (i, j) = max(d, key=d.get)
    tl = 3 - i - j
    a, b = i, j
    # orient: cross product of (a-tl) x (b-tl) should be positive for
    # (top-right, bottom-left) ordering in image coords (y down)
    ax, ay = pts[a][0] - pts[tl][0], pts[a][1] - pts[tl][1]
    bx, by = pts[b][0] - pts[tl][0], pts[b][1] - pts[tl][1]
    if ax * by - ay * bx < 0:
        a, b = b, a
    unit = sum(c[2] for c in chosen) / 3.0
    return pts[tl], pts[a], pts[b], unit


def decode_image(image, *, device=None) -> list:
    """Detect + decode QR codes in an Image (its luminance, binarized on its
    device), a u8 tensor (on its device) or a numpy array (on ``device``,
    which must be named); raw arrays take channel 0. Returns a list of
    QrDecodeResult (empty when none found)."""
    from ..image import plane_of

    dark = _binarize(plane_of(image, device))
    try:
        centers = _finder_candidates(dark)
        tl, tr, bl, unit = _order_finders(centers)
    except QrDecodeError:
        return []

    # estimate version from finder spacing
    import math

    dist = math.hypot(tr[0] - tl[0], tr[1] - tl[1])
    modules = dist / unit + 7
    version = max(1, min(40, round((modules - 17) / 4)))

    for ver in {version, version - 1, version + 1} - {0, 41}:
        result = _try_sample(dark, tl, tr, bl, ver)
        if result is not None:
            return [result]
    return []


def _try_sample(dark, tl, tr, bl, version):
    from ..geometry.transforms import ProjectiveTransform

    n = dimension(version)
    # finder centers are at module coords (3.5, 3.5), (n-3.5, 3.5), (3.5, n-3.5)
    src = [(3.5, 3.5), (n - 3.5, 3.5), (3.5, n - 3.5)]
    dst = [tl, tr, bl]
    # 4th point: parallelogram estimate of bottom-right finder position
    br = (tr[0] + bl[0] - tl[0], tr[1] + bl[1] - tl[1])
    src.append((n - 3.5, n - 3.5))
    dst.append(br)
    try:
        t = ProjectiveTransform(src, dst)
    except ValueError:
        return None

    coords = np.array([t.project((c + 0.5, r + 0.5))
                       for r in range(n) for c in range(n)])
    xs = np.clip(np.round(coords[:, 0]).astype(int), 0, dark.shape[1] - 1)
    ys = np.clip(np.round(coords[:, 1]).astype(int), 0, dark.shape[0] - 1)
    mat = dark[ys, xs].reshape(n, n)
    corners = [tuple(float(v) for v in t.project(pt))
               for pt in ((0.0, 0.0), (n, 0.0), (n, n), (0.0, n))]
    for candidate in (mat, mat.T):  # handle mirrored codes
        try:
            result = decode_matrix(candidate)
            result.corners = corners
            return result
        except QrDecodeError:
            continue
    return None
