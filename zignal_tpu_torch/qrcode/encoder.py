"""QR encoder: segments -> RS ECC interleave -> masked module matrix
(reference: src/qrcode/encoder.zig, segment.zig).

Copied from zignal_tpu/qrcode/encoder.py (host numpy); ``encode_text``
returns the port's Image on the caller's ``device``.
"""

from __future__ import annotations

import numpy as np

from .galois import rs_encode
from .matrix import build_matrix, penalty
from .tables import EcLevel, dimension, ec_blocks

__all__ = ["encode_text", "encode_to_matrix", "QrEncodeError"]

_ALPHANUMERIC = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"
_ALPHA_IDX = {ch: i for i, ch in enumerate(_ALPHANUMERIC)}


class QrEncodeError(ValueError):
    pass


class _BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def __len__(self):
        return len(self.bits)


def _pick_mode(text) -> str:
    if isinstance(text, (bytes, bytearray)):
        return "byte"
    if text and all(c.isdigit() for c in text):
        return "numeric"
    if text and all(c in _ALPHA_IDX for c in text):
        return "alphanumeric"
    return "byte"


_MODE_INDICATOR = {"numeric": 1, "alphanumeric": 2, "byte": 4}


def _count_bits(mode: str, version: int) -> int:
    """Character-count field width (segment.zig)."""
    if version <= 9:
        return {"numeric": 10, "alphanumeric": 9, "byte": 8}[mode]
    if version <= 26:
        return {"numeric": 12, "alphanumeric": 11, "byte": 16}[mode]
    return {"numeric": 14, "alphanumeric": 13, "byte": 16}[mode]


def _segment_bits(text: str, mode: str, version: int) -> _BitWriter:
    bw = _BitWriter()
    bw.write(_MODE_INDICATOR[mode], 4)
    if mode == "byte":
        data = bytes(text) if isinstance(text, (bytes, bytearray)) else text.encode("utf-8")
        bw.write(len(data), _count_bits(mode, version))
        for b in data:
            bw.write(b, 8)
    elif mode == "numeric":
        bw.write(len(text), _count_bits(mode, version))
        for i in range(0, len(text), 3):
            chunk = text[i:i + 3]
            bw.write(int(chunk), {3: 10, 2: 7, 1: 4}[len(chunk)])
    else:  # alphanumeric
        bw.write(len(text), _count_bits(mode, version))
        for i in range(0, len(text), 2):
            chunk = text[i:i + 2]
            if len(chunk) == 2:
                bw.write(_ALPHA_IDX[chunk[0]] * 45 + _ALPHA_IDX[chunk[1]], 11)
            else:
                bw.write(_ALPHA_IDX[chunk[0]], 6)
    return bw


def _bits_needed(text, mode: str, version: int) -> int:
    if mode == "byte":
        n = len(text) if isinstance(text, (bytes, bytearray)) else len(text.encode("utf-8"))
    else:
        n = len(text)
    header = 4 + _count_bits(mode, version)
    if mode == "byte":
        return header + 8 * n
    if mode == "numeric":
        return header + 10 * (n // 3) + {0: 0, 1: 4, 2: 7}[n % 3]
    return header + 11 * (n // 2) + 6 * (n % 2)


def _choose_version(text: str, mode: str, level: EcLevel,
                    forced: int | None) -> int:
    for version in ([forced] if forced else range(1, 41)):
        capacity = ec_blocks(version, level).data_codewords * 8
        if _bits_needed(text, mode, version) <= capacity:
            return version
    raise QrEncodeError("text too long for any QR version at this EC level")


def encode_to_matrix(text: str, ec_level: EcLevel = EcLevel.MEDIUM,
                     version: int | None = None):
    """(module matrix bool [n,n], version, chosen mask)."""
    if version is not None and not 1 <= version <= 40:
        raise QrEncodeError("version must be 1-40")
    mode = _pick_mode(text)
    ver = _choose_version(text, mode, ec_level, version)
    blocks = ec_blocks(ver, ec_level)
    capacity_bits = blocks.data_codewords * 8

    bw = _segment_bits(text, mode, ver)
    # terminator + byte alignment + pad codewords (encoder.zig)
    bw.write(0, min(4, capacity_bits - len(bw)))
    if len(bw) % 8:
        bw.write(0, 8 - len(bw) % 8)
    pads = (capacity_bits - len(bw)) // 8
    for i in range(pads):
        bw.write(0xEC if i % 2 == 0 else 0x11, 8)

    data = np.packbits(np.array(bw.bits, dtype=np.uint8)).tobytes()
    assert len(data) == blocks.data_codewords

    # split into blocks, RS per block, interleave
    lengths = blocks.block_lengths()
    data_blocks = []
    pos = 0
    for ln in lengths:
        data_blocks.append(data[pos:pos + ln])
        pos += ln
    ecc_blocks = [rs_encode(b, blocks.ec_per_block) for b in data_blocks]

    interleaved = bytearray()
    for i in range(max(lengths)):
        for b in data_blocks:
            if i < len(b):
                interleaved.append(b[i])
    for i in range(blocks.ec_per_block):
        for e in ecc_blocks:
            interleaved.append(e[i])

    # choose mask with minimum penalty
    best_mask, best_score, best_mat = 0, None, None
    for mask in range(8):
        mat = build_matrix(ver, ec_level, bytes(interleaved), mask)
        score = penalty(mat)
        if best_score is None or score < best_score:
            best_mask, best_score, best_mat = mask, score, mat
    return best_mat, ver, best_mask


def encode_text(text, ec_level: EcLevel = EcLevel.MEDIUM,
                version: int | None = None, module_size: int = 8,
                quiet_zone: int = 4, *, device):
    """Encode str/bytes -> grayscale Image (0=dark, 255=light) whose
    device ops run on ``device``
    (reference: bindings qrcode.zig:287 qrcode_encode; cli/qr.zig render)."""
    from ..image import Image

    if not isinstance(text, (str, bytes, bytearray)):
        raise TypeError("data must be str or bytes")
    if module_size < 1:
        raise ValueError("module_size must be >= 1")
    if quiet_zone < 0:
        raise ValueError("quiet_zone must be >= 0")
    ec_level = EcLevel(ec_level)

    mat, ver, _ = encode_to_matrix(text, ec_level, version)
    n = dimension(ver)
    total = (n + 2 * quiet_zone) * module_size
    arr = np.full((total, total), 255, dtype=np.uint8)
    scaled = np.kron(mat, np.ones((module_size, module_size), dtype=bool))
    off = quiet_zone * module_size
    arr[off:off + n * module_size, off:off + n * module_size][scaled] = 0
    return Image._from_host(arr[..., None], "gray", device)
