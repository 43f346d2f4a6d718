"""JPEG codec (host side).

Decode runs in the native C++ core (zignal_tpu_torch/csrc/host/jpeg_core.cpp):
baseline + progressive, Huffman, restart markers, arbitrary sampling
factors (reference scope: src/codecs/jpeg.zig); sequential
full-interleave scans use the band-streaming path (entropy+IDCT+color
fused per MCU row). The baseline encoder runs natively too
(zt_jpeg_encode_scan: forward AAN DCT + inline Huffman) with the
numpy sgemm path as toolchain-free fallback, 4:4:4/4:2:2/4:2:0 and a
quality knob (reference: jpeg.zig:307 encode).

Copied from zignal_tpu/codecs/jpeg.py; its native hot loops come
from the port's own library (zignal_tpu_torch/native.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from ..native import get_lib

__all__ = ["DecodeLimits", "JpegInfo", "get_info", "decode", "load", "load_from_bytes",
           "encode", "save", "SIGNATURE"]

SIGNATURE = b"\xff\xd8\xff"


class JpegError(ValueError):
    pass


@dataclasses.dataclass
class DecodeLimits:
    """Anti-bomb resource limits (reference: jpeg.zig:19-39)."""

    max_width: int = 1 << 16
    max_height: int = 1 << 16
    max_pixels: int = 1 << 30


@dataclasses.dataclass
class JpegInfo:
    width: int
    height: int
    components: int


def _lib():
    lib = get_lib()
    if lib is None:
        raise JpegError("native codec core unavailable (g++ missing?)")
    if not hasattr(lib, "_jpeg_ready"):
        lib.zt_jpeg_info.restype = ctypes.c_int
        lib.zt_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.zt_jpeg_decode.restype = ctypes.c_int
        lib.zt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ]
        lib._jpeg_ready = True
    return lib


def get_info(data: bytes) -> JpegInfo:
    if not data.startswith(SIGNATURE[:2]):
        raise JpegError("not a JPEG file")
    lib = _lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    n = ctypes.c_int()
    rc = lib.zt_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(n))
    if rc != 0:
        raise JpegError(f"invalid JPEG header (code {rc})")
    return JpegInfo(w.value, h.value, n.value)


def decode(data: bytes, limits: DecodeLimits | None = None):
    """Decode JPEG bytes -> (uint8 [H,W,C] array with C in 1/3, JpegInfo)."""
    limits = limits or DecodeLimits()
    info = get_info(data)
    if info.width <= 0 or info.height <= 0:
        raise JpegError("invalid JPEG dimensions")
    if (info.width > limits.max_width or info.height > limits.max_height
            or info.width * info.height > limits.max_pixels):
        raise JpegError("image exceeds decode limits")
    out_ncomp = 1 if info.components == 1 else 3
    out = np.empty((info.height, info.width, out_ncomp), dtype=np.uint8)
    lib = _lib()
    rc = lib.zt_jpeg_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_char_p), out_ncomp
    )
    if rc != 0:
        raise JpegError(f"JPEG decode failed (code {rc})")
    return out, info


def load_from_bytes(data: bytes):
    return decode(data)[0]


def load(path: str):
    with open(path, "rb") as f:
        return load_from_bytes(f.read())


# ---------------------------------------------------------------------------
# Baseline encoder (numpy)
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.float64).reshape(8, 8)

_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.float64).reshape(8, 8)

# standard JFIF Huffman tables (Annex K)
_DC_LUMA_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUMA_VALS = list(range(12))
_DC_CHROMA_BITS = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHROMA_VALS = list(range(12))
_AC_LUMA_BITS = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_CHROMA_BITS = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _huff_codes(bits, vals):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_DCT_BASIS = None


def _dct_basis():
    global _DCT_BASIS
    if _DCT_BASIS is None:
        u = np.arange(8)
        x = np.arange(8)
        c = np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
        _DCT_BASIS = (c[:, None] * np.cos(
            (2 * x[None, :] + 1) * u[:, None] * np.pi / 16)).astype(np.float32)
    return _DCT_BASIS


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)


def _encode_plane_blocks(plane, q):
    """DCT + quantize all 8x8 blocks of a [H,W] float plane (H,W mult of 8).
    Returns int32 [n_blocks_y, n_blocks_x, 64] in zigzag order.

    The separable DCT runs as two [8B, 8] x [8, 8] f32 sgemms (one per
    axis) instead of an einsum — BLAS-shaped and single precision,
    ~5x faster at identical visual quality (the reference encoder is
    an integer LLM FDCT anyway, jpeg.zig:631, so there is no bit parity
    to preserve on the encode side)."""
    h, w = plane.shape
    basis = _dct_basis()
    blocks = (plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
              .reshape(-1, 8, 8).astype(np.float32, copy=False))
    # the transpose+reshape above always yields a fresh buffer, so the
    # in-place subtract never aliases the caller's plane
    blocks -= np.float32(128.0)
    nb = blocks.shape[0]
    bt = np.ascontiguousarray(basis.T)
    # pass 1 over x: t[(b,z), u] = sum_x blocks[b,x,z] basis[u,x]
    t = blocks.transpose(0, 2, 1).reshape(nb * 8, 8) @ bt
    # pass 2 over z: c[(b,u), v] = sum_z t[b,z,u] basis[v,z]
    t = t.reshape(nb, 8, 8).transpose(0, 2, 1).reshape(nb * 8, 8) @ bt
    coef = t.reshape(nb, 8, 8)
    # int16 keeps every downstream pass (zigzag gather, MCU interleave)
    # at half the traffic; quantized baseline coefficients are < 2^11
    quant = np.round(coef / q.astype(np.float32)).astype(np.int16)
    return quant.reshape(h // 8, w // 8, 64)[..., _ZIGZAG]


def _magnitude(v):
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _encode_scan(writer, comps, dc_codes, ac_codes):
    """Interleaved MCU entropy coding. comps: list of (blocks[by,bx,64], h, v, which)."""
    mcux = comps[0][0].shape[1] // comps[0][1]
    mcuy = comps[0][0].shape[0] // comps[0][2]

    native = _entropy_encode_native(comps, dc_codes, ac_codes, mcuy, mcux)
    if native is not None:
        writer.out += native
        return

    dc_pred = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (blocks, ch, cv, which) in enumerate(comps):
                dct, act = dc_codes[which], ac_codes[which]
                for v in range(cv):
                    for hh in range(ch):
                        blk = blocks[my * cv + v, mx * ch + hh]
                        diff = int(blk[0]) - dc_pred[ci]
                        dc_pred[ci] = int(blk[0])
                        s = _magnitude(diff)
                        code, ln = dct[s]
                        writer.write(code, ln)
                        if s:
                            writer.write(diff if diff > 0 else diff + (1 << s) - 1, s)
                        run = 0
                        nz = np.nonzero(blk[1:])[0]
                        last = nz[-1] + 1 if len(nz) else 0
                        k = 1
                        while k <= last:
                            val = int(blk[k])
                            if val == 0:
                                run += 1
                                k += 1
                                continue
                            while run >= 16:
                                code, ln = act[0xF0]
                                writer.write(code, ln)
                                run -= 16
                            s = _magnitude(val)
                            code, ln = act[(run << 4) | s]
                            writer.write(code, ln)
                            writer.write(val if val > 0 else val + (1 << s) - 1, s)
                            run = 0
                            k += 1
                        if last < 63:
                            code, ln = act[0x00]
                            writer.write(code, ln)
    writer.flush()


def _entropy_encode_native(comps, dc_codes, ac_codes, mcuy, mcux):
    """Order the MCU-interleaved blocks and entropy-code them in the
    native core (pure-Python bit IO is ~1000x slower). Returns stuffed
    scan bytes or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_mcus = mcuy * mcux
    n_slots = sum(c[1] * c[2] for c in comps)
    total = n_mcus * n_slots
    blocks = np.empty((n_mcus, n_slots, 64), dtype=np.int16)
    slot_class = np.empty(n_slots, dtype=np.uint8)
    slot_group = np.empty(n_slots, dtype=np.uint8)
    off = 0
    for ci, (blk, ch, cv, which) in enumerate(comps):
        # blk rows are my*cv + v, cols mx*ch + hh -> MCU-major slot order
        ordered = blk.reshape(mcuy, cv, mcux, ch, 64).transpose(
            0, 2, 1, 3, 4).reshape(n_mcus, cv * ch, 64)
        blocks[:, off:off + cv * ch] = ordered
        slot_class[off:off + cv * ch] = which
        slot_group[off:off + cv * ch] = ci
        off += cv * ch
    blocks = blocks.reshape(total, 64)
    tbl_class = np.tile(slot_class, n_mcus)
    pred_group = np.tile(slot_group, n_mcus)

    dc_c, dc_l = _pack_codes(dc_codes, 12)
    ac_c, ac_l = _pack_codes(ac_codes, 256)
    cap = total * 128 + 1024
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.zt_jpeg_entropy_encode(
        np.ascontiguousarray(blocks).ctypes.data_as(ctypes.c_char_p), total,
        tbl_class.ctypes.data_as(ctypes.c_char_p),
        pred_group.ctypes.data_as(ctypes.c_char_p),
        dc_c.ctypes.data_as(ctypes.c_char_p), dc_l.ctypes.data_as(ctypes.c_char_p),
        ac_c.ctypes.data_as(ctypes.c_char_p), ac_l.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p), cap,
    )
    if rc < 0:
        return None
    return out[:rc].tobytes()


def _pack_codes(tables, size):
    codes = np.zeros((2, size), dtype=np.uint32)
    lens = np.zeros((2, size), dtype=np.uint8)
    for cls in (0, 1):
        for sym, (code, ln) in tables[cls].items():
            codes[cls, sym] = code
            lens[cls, sym] = ln
    return np.ascontiguousarray(codes), np.ascontiguousarray(lens)


def _encode_scan_full_native(arr, gray, sh, sv, ql, qc, dc_codes, ac_codes):
    """Whole scan in one native call (deinterleave + BT.601 + subsample
    + forward AAN DCT + quantize + entropy; jpeg_core.cpp
    zt_jpeg_encode_scan). Returns stuffed scan bytes, or None when the
    native library is unavailable (the numpy path below is the
    fallback — a different but equally conformant float encoder, so
    streams are validated by decoded-image closeness, not bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w, ch = arr.shape
    ncomp = 1 if gray else 3
    ql16 = np.ascontiguousarray(ql.reshape(64).astype(np.uint16))
    qc16 = np.ascontiguousarray(qc.reshape(64).astype(np.uint16))
    dc_c, dc_l = _pack_codes(dc_codes, 12)
    ac_c, ac_l = _pack_codes(ac_codes, 256)
    mcux = -(-w // (8 * sh))
    mcuy = -(-h // (8 * sv))
    nblocks = mcux * mcuy * (sh * sv + (0 if gray else 2))
    # 300 B/block covers everything realistic; the absolute worst case
    # (all 64 coefficients at max magnitude, every byte stuffed) is
    # ~420 B/block, so retry once with that before giving up
    for per_block in (300, 424):
        cap = nblocks * per_block + 4096
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.zt_jpeg_encode_scan(
            arr.ctypes.data_as(ctypes.c_char_p), h, w, ch, ncomp, sh, sv,
            ql16.ctypes.data_as(ctypes.c_char_p),
            qc16.ctypes.data_as(ctypes.c_char_p),
            dc_c.ctypes.data_as(ctypes.c_char_p),
            dc_l.ctypes.data_as(ctypes.c_char_p),
            ac_c.ctypes.data_as(ctypes.c_char_p),
            ac_l.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p), cap,
        )
        if rc >= 0:
            return out[:rc].tobytes()
    return None


def encode(arr: np.ndarray, quality: int = 90, subsampling: str = "444") -> bytes:
    """Baseline JFIF encode of a uint8 [H,W,{1,3,4}] array."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError("encode expects a uint8 [H, W, {1,3,4}] array")
    if not 1 <= quality <= 100:
        raise ValueError("quality must be in 1-100")
    if subsampling not in ("444", "422", "420"):
        raise ValueError("subsampling must be one of '444', '422', '420'")
    h, w, ch = arr.shape
    gray = ch == 1

    scale = 5000 / quality if quality < 50 else 200 - quality * 2
    ql = np.clip(np.floor((_Q_LUMA * scale + 50) / 100), 1, 255)
    qc = np.clip(np.floor((_Q_CHROMA * scale + 50) / 100), 1, 255)

    sh = 1 if gray else (2 if subsampling in ("422", "420") else 1)
    sv = 1 if gray else (2 if subsampling == "420" else 1)
    dc_codes = [_huff_codes(_DC_LUMA_BITS, _DC_LUMA_VALS),
                _huff_codes(_DC_CHROMA_BITS, _DC_CHROMA_VALS)]
    ac_codes = [_huff_codes(_AC_LUMA_BITS, _AC_LUMA_VALS),
                _huff_codes(_AC_CHROMA_BITS, _AC_CHROMA_VALS)]

    scan = _encode_scan_full_native(arr, gray, sh, sv, ql, qc,
                                    dc_codes, ac_codes)
    if scan is None:
        scan = _encode_scan_numpy(arr, gray, sh, sv, ql, qc,
                                  dc_codes, ac_codes)

    out = bytearray()
    out += b"\xff\xd8"  # SOI
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"

    def dqt(tid, q):
        zz = q.reshape(64)[_ZIGZAG].astype(np.uint8)
        return b"\xff\xdb" + struct.pack(">H", 67) + bytes([tid]) + zz.tobytes()

    out += dqt(0, ql)
    if not gray:
        out += dqt(1, qc)

    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, h, w, ncomp)
    if gray:
        sof += bytes([1, 0x11, 0])
    else:
        sof += bytes([1, (sh << 4) | sv, 0, 2, 0x11, 1, 3, 0x11, 1])
    out += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof

    def dht(cls, tid, bits, vals):
        payload = bytes([(cls << 4) | tid]) + bytes(bits[1:]) + bytes(vals)
        return b"\xff\xc4" + struct.pack(">H", len(payload) + 2) + payload

    out += dht(0, 0, _DC_LUMA_BITS, _DC_LUMA_VALS)
    out += dht(1, 0, _AC_LUMA_BITS, _AC_LUMA_VALS)
    if not gray:
        out += dht(0, 1, _DC_CHROMA_BITS, _DC_CHROMA_VALS)
        out += dht(1, 1, _AC_CHROMA_BITS, _AC_CHROMA_VALS)

    sos = bytes([ncomp])
    if gray:
        sos += bytes([1, 0x00])
    else:
        sos += bytes([1, 0x00, 2, 0x11, 3, 0x11])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += scan
    out += b"\xff\xd9"
    return bytes(out)


def _encode_scan_numpy(arr, gray, sh, sv, ql, qc, dc_codes, ac_codes):
    """The original numpy scan pipeline (sgemm DCT): fallback when the
    native toolchain is unavailable."""
    h, w, ch = arr.shape
    if gray:
        y = arr[..., 0].astype(np.float32)
        planes = [(y, ql, 1, 1, 0)]
    else:
        rgb = arr[..., :3].astype(np.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        f = np.float32
        y = f(0.299) * r + f(0.587) * g + f(0.114) * b
        cb = (b - y) / f(1.772) + f(128.0)
        cr = (r - y) / f(1.402) + f(128.0)
        if sh > 1 or sv > 1:
            ph = -(-h // sv)
            pw = -(-w // sh)
            pad = np.pad(cb, ((0, ph * sv - h), (0, pw * sh - w)), mode="edge")
            cb = pad.reshape(ph, sv, pw, sh).mean(axis=(1, 3))
            pad = np.pad(cr, ((0, ph * sv - h), (0, pw * sh - w)), mode="edge")
            cr = pad.reshape(ph, sv, pw, sh).mean(axis=(1, 3))
        planes = [(y, ql, sh, sv, 0), (cb, qc, 1, 1, 1), (cr, qc, 1, 1, 1)]

    # pad planes to MCU multiples and DCT
    mcu_w = 8 * sh
    mcu_h = 8 * sv
    comps = []
    for plane, q, chh, cvv, which in planes:
        bw = -(-w // mcu_w) * chh * 8 if not gray else -(-w // 8) * 8
        bh = -(-h // mcu_h) * cvv * 8 if not gray else -(-h // 8) * 8
        ph, pw = plane.shape
        padded = np.pad(plane, ((0, bh - ph), (0, bw - pw)), mode="edge")
        comps.append((_encode_plane_blocks(padded, q.reshape(8, 8)), chh, cvv, which))

    writer = _BitWriter()
    _encode_scan(writer, comps, dc_codes, ac_codes)
    return bytes(writer.out)


def save(path: str, arr: np.ndarray, **options) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr, **options))
