"""PNG codec (host side).

Full-spec decoder and encoder matching the reference's coverage
(reference: src/codecs/png.zig — all color types, 1-16 bit depths, Adam7
interlace, palette + tRNS, CRC verification, decode resource limits
png.zig:23-60). Chunk walking, bit expansion, and the filter heuristic are
vectorized numpy; the sequential scanline unfilter runs in the native C++
core (zignal_tpu_torch/csrc/host/codec_core.cpp) with a Python fallback; DEFLATE is
stdlib zlib.

Copied from zignal_tpu/codecs/png.py; its native hot loops come
from the port's own library (zignal_tpu_torch/native.py).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from ..native import get_lib

__all__ = ["DecodeLimits", "PngInfo", "get_info", "decode", "load",
           "load_from_bytes", "encode", "save", "SIGNATURE"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"

_COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

# Adam7 pass layout: (x_start, y_start, x_step, y_step)
_ADAM7 = (
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
)


class PngError(ValueError):
    pass


@dataclasses.dataclass
class DecodeLimits:
    """Anti-bomb resource limits (reference: png.zig:23-60)."""

    max_width: int = 1 << 24
    max_height: int = 1 << 24
    max_pixels: int = 1 << 30
    max_idat_bytes: int = 1 << 31
    max_decompressed_bytes: int = 1 << 32


@dataclasses.dataclass
class PngInfo:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int

    @property
    def channels(self) -> int:
        return _COLOR_CHANNELS[self.color_type]


def _chunks(data: bytes, verify_crc: bool = True):
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG file (bad signature)")
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > n:
            raise PngError("truncated PNG chunk")
        payload = data[pos + 8:end]
        if verify_crc:
            (crc,) = struct.unpack(">I", data[end:end + 4])
            if zlib.crc32(ctype + payload) & 0xFFFFFFFF != crc:
                raise PngError(f"bad CRC in {ctype!r} chunk")
        yield ctype, payload
        pos = end + 4
        if ctype == b"IEND":
            return
    raise PngError("missing IEND chunk")


def get_info(data: bytes) -> PngInfo:
    for ctype, payload in _chunks(data, verify_crc=False):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise PngError("bad IHDR length")
            w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", payload)
            if comp != 0 or filt != 0 or inter not in (0, 1):
                raise PngError("unsupported IHDR fields")
            if color not in _COLOR_CHANNELS:
                raise PngError(f"unsupported color type {color}")
            valid_depths = {
                0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                4: (8, 16), 6: (8, 16),
            }[color]
            if depth not in valid_depths:
                raise PngError(f"invalid bit depth {depth} for color type {color}")
            return PngInfo(w, h, depth, color, inter)
        break
    raise PngError("IHDR chunk must come first")


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering. raw: rows*(stride+1) bytes."""
    lib = get_lib()
    out = np.empty(rows * stride, dtype=np.uint8)
    if rows == 0 or stride == 0:
        return out
    if lib is not None:
        src = np.ascontiguousarray(raw)
        rc = lib.zt_png_unfilter(
            src.ctypes.data_as(__import__("ctypes").c_char_p),
            out.ctypes.data_as(__import__("ctypes").c_char_p),
            rows, stride, bpp,
        )
        if rc != 0:
            raise PngError("invalid scanline filter byte")
        return out
    # Python fallback
    src = raw.reshape(rows, stride + 1)
    prev = np.zeros(stride, dtype=np.int64)
    for r in range(rows):
        f = src[r, 0]
        line = src[r, 1:].astype(np.int64)
        if f == 0:
            recon = line
        elif f == 1:
            recon = line.copy()
            for i in range(bpp, stride):
                recon[i] = (recon[i] + recon[i - bpp]) & 0xFF
        elif f == 2:
            recon = (line + prev) & 0xFF
        elif f == 3:
            recon = line.copy()
            for i in range(stride):
                a = recon[i - bpp] if i >= bpp else 0
                recon[i] = (recon[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif f == 4:
            recon = line.copy()
            for i in range(stride):
                a = recon[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                recon[i] = (recon[i] + pred) & 0xFF
        else:
            raise PngError("invalid scanline filter byte")
        out[r * stride:(r + 1) * stride] = recon.astype(np.uint8)
        prev = recon
    return out


def _expand_bits(row_bytes: np.ndarray, rows: int, width: int, depth: int) -> np.ndarray:
    """[rows, stride] packed samples -> [rows, width] integer samples."""
    if depth == 8:
        return row_bytes[:, :width]
    if depth == 16:
        return row_bytes.reshape(rows, -1)[:, : width * 2].reshape(rows, width, 2)
    bits = np.unpackbits(row_bytes, axis=1)
    if depth == 1:
        return bits[:, :width]
    spb = 8 // depth
    vals = bits.reshape(rows, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
    samples = (vals * weights).sum(axis=2)
    return samples[:, :width]


def _scale_to_u8(samples: np.ndarray, depth: int) -> np.ndarray:
    """Sample scaling to 8 bits (reference: png.zig toNativeImage)."""
    if depth == 8:
        return samples.astype(np.uint8)
    if depth == 16:
        # take the high byte
        return samples[..., 0].astype(np.uint8)
    factor = 255 // ((1 << depth) - 1)
    return (samples * factor).astype(np.uint8)


def _decode_subimage(raw: np.ndarray, rows: int, width: int, info: PngInfo):
    """Unfilter + de-pack one (sub)image; returns [rows, width, channels]
    samples (u8, or u16-pair for depth 16)."""
    ch = info.channels
    depth = info.bit_depth
    bits_per_pixel = depth * ch
    stride = (width * bits_per_pixel + 7) // 8
    bpp = max(1, bits_per_pixel // 8)
    recon = _unfilter(raw, rows, stride, bpp).reshape(rows, stride)
    if depth == 16:
        s = recon[:, : width * ch * 2].reshape(rows, width, ch, 2)
        return s
    if depth == 8:
        return recon[:, : width * ch].reshape(rows, width, ch)
    samples = _expand_bits(recon, rows, width * ch, depth)
    return samples.reshape(rows, width, ch)


def decode(data: bytes, limits: DecodeLimits | None = None):
    """Decode PNG bytes -> (array [H,W,C] uint8 with C in 1/3/4, PngInfo)."""
    limits = limits or DecodeLimits()
    info = get_info(data)
    if info.width > limits.max_width or info.height > limits.max_height:
        raise PngError("image dimensions exceed decode limits")
    if info.width * info.height > limits.max_pixels:
        raise PngError("pixel count exceeds decode limits")
    if info.width == 0 or info.height == 0:
        raise PngError("zero-sized image")

    palette = None
    trns = None
    idat = bytearray()
    for ctype, payload in _chunks(data):
        if ctype == b"PLTE":
            if len(payload) % 3 != 0:
                raise PngError("bad PLTE length")
            palette = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.extend(payload)
            if len(idat) > limits.max_idat_bytes:
                raise PngError("IDAT exceeds decode limits")

    ch = info.channels
    depth = info.bit_depth
    bits_per_pixel = depth * ch

    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error as e:
        raise PngError(f"corrupt IDAT stream: {e}") from e
    if len(raw) > limits.max_decompressed_bytes:
        raise PngError("decompressed data exceeds decode limits")
    raw = np.frombuffer(raw, dtype=np.uint8)

    if info.interlace == 1:
        if depth == 16:
            samples = np.zeros((info.height, info.width, ch, 2), dtype=np.uint8)
        else:
            samples = np.zeros((info.height, info.width, ch), dtype=np.uint16)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (info.width - x0 + dx - 1) // dx
            ph = (info.height - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            stride = (pw * bits_per_pixel + 7) // 8
            nbytes = ph * (stride + 1)
            sub = _decode_subimage(raw[pos:pos + nbytes], ph, pw, info)
            pos += nbytes
            samples[y0::dy, x0::dx] = sub
    else:
        stride = (info.width * bits_per_pixel + 7) // 8
        expected = info.height * (stride + 1)
        if len(raw) < expected:
            raise PngError("truncated image data")
        samples = _decode_subimage(raw[:expected], info.height, info.width, info)

    # -> native u8 gray/rgb/rgba (reference: png.zig toNativeImage:801)
    if info.color_type == 3:
        if palette is None:
            raise PngError("palette image missing PLTE chunk")
        idx = samples[..., 0].astype(np.int64)
        if idx.max() >= len(palette):
            raise PngError("palette index out of range")
        rgb = palette[idx]
        if trns is not None:
            alpha_tab = np.full(len(palette), 255, dtype=np.uint8)
            t = np.frombuffer(trns, dtype=np.uint8)
            alpha_tab[: len(t)] = t
            a = alpha_tab[idx]
            return np.concatenate([rgb, a[..., None]], axis=-1), info
        return rgb, info

    out = _scale_to_u8(samples, depth)
    if info.color_type == 0:  # grayscale (+ optional tRNS)
        if trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            if depth == 16:
                key8 = key >> 8
            elif depth == 8:
                key8 = key & 0xFF
            else:
                key8 = (key & ((1 << depth) - 1)) * (255 // ((1 << depth) - 1))
            gray = out[..., 0]
            a = np.where(gray == key8, 0, 255).astype(np.uint8)
            rgb = np.repeat(out, 3, axis=-1)
            return np.concatenate([rgb, a[..., None]], axis=-1), info
        return out, info
    if info.color_type == 2:  # rgb
        return out, info
    if info.color_type == 4:  # gray + alpha -> rgba
        g = out[..., 0:1]
        a = out[..., 1:2]
        return np.concatenate([g, g, g, a], axis=-1), info
    return out, info  # rgba


def load_from_bytes(data: bytes, limits: DecodeLimits | None = None):
    arr, _ = decode(data, limits)
    return arr


def load(path: str, limits: DecodeLimits | None = None):
    with open(path, "rb") as f:
        return load_from_bytes(f.read(), limits)


# ---------------------------------------------------------------------------
# Encoder (reference: png.zig:1400 encode — per-scanline filter heuristic)
# ---------------------------------------------------------------------------


def encode(arr: np.ndarray, compression_level: int = 6) -> bytes:
    """Encode a [H, W, C] uint8 array (C in 1/3/4) as PNG bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError("encode expects a uint8 [H, W, {1,3,4}] array")
    h, w, ch = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[ch]
    flat = arr.reshape(h, w * ch)  # uint8; subtraction wraps mod 256

    # native per-row MSD filtering (single C++ pass; the numpy fallback
    # below picks one global filter from sampled rows)
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        out = np.empty(h * (w * ch + 1), dtype=np.uint8)
        src = np.ascontiguousarray(flat)
        rc = lib.zt_png_filter_msd(
            src.ctypes.data_as(ctypes.c_char_p), h, w * ch, ch,
            out.ctypes.data_as(ctypes.c_char_p),
        )
        if rc == 0:
            # hand the numpy buffer straight through (zlib and the
            # native encoder both take the buffer protocol / a pointer;
            # a .tobytes() here copied the full filtered payload)
            return _assemble_png(w, h, color_type, out,
                                 compression_level)

    def filtered(rows_u8, prev_u8, which: int):
        left = np.zeros_like(rows_u8)
        left[:, ch:] = rows_u8[:, :-ch]
        if which == 0:
            return rows_u8
        if which == 1:
            return rows_u8 - left
        if which == 2:
            return rows_u8 - prev_u8
        if which == 3:
            avg = ((left.astype(np.uint16) + prev_u8) >> 1).astype(np.uint8)
            return rows_u8 - avg
        upleft = np.zeros_like(prev_u8)
        upleft[:, ch:] = prev_u8[:, :-ch]
        li, pi, ui = (left.astype(np.int16), prev_u8.astype(np.int16),
                      upleft.astype(np.int16))
        pp = li + pi - ui
        pa, pb, pc = np.abs(pp - li), np.abs(pp - pi), np.abs(pp - ui)
        pred = np.where((pa <= pb) & (pa <= pc), li,
                        np.where(pb <= pc, pi, ui)).astype(np.uint8)
        return rows_u8 - pred

    # pick ONE filter from the minimum-sum-of-absolutes heuristic on a
    # row subsample (full per-row MSD costs 5 full passes — too slow for
    # a single-core host), then apply it in one full-size pass
    sample_idx = np.arange(0, h, max(1, h // 32))
    samp = flat[sample_idx]
    samp_prev = flat[np.maximum(sample_idx - 1, 0)]
    samp_prev = np.where((sample_idx == 0)[:, None], 0, samp_prev)
    best, best_cost = 0, None
    for which in range(5):
        cand = filtered(samp, samp_prev, which).astype(np.int8)
        cost = int(np.abs(cand.astype(np.int16)).sum())
        if best_cost is None or cost < best_cost:
            best, best_cost = which, cost
    prev = np.vstack([np.zeros((1, w * ch), dtype=np.uint8), flat[:-1]])
    rows = filtered(flat, prev, best)
    scanlines = np.concatenate(
        [np.full((h, 1), best, np.uint8), rows], axis=1
    ).tobytes()

    return _assemble_png(w, h, color_type, scanlines, compression_level)


def _assemble_png(w, h, color_type, scanlines: bytes,
                  compression_level: int) -> bytes:
    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    idat = _deflate(scanlines, compression_level)
    return SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat) + chunk(b"IEND", b"")


def _deflate(scanlines, level: int) -> bytes:
    """Adaptive DEFLATE strategy: Z_RLE is 3-4x faster than the default
    Lempel-Ziv search on photographic (high-entropy MSD-filtered) rows
    and within ~5% of its size — but up to 16x LARGER on smooth
    synthetic content, so the strategy is picked per image by trying
    both on a 64 KB sample (deterministic; sample cost is a few %).

    ``scanlines``: bytes or a 1-D uint8 numpy array (buffer protocol —
    the native filter pass hands its numpy output straight through so
    the full payload is never copied into a bytes object)."""

    def _c(strategy, data):
        co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
        return co.compress(data) + co.flush()

    n = len(scanlines)
    if level == 0 or n < 4096:
        return zlib.compress(scanlines, level)
    if n <= (1 << 16):
        a = _c(zlib.Z_DEFAULT_STRATEGY, scanlines)
        b = _c(zlib.Z_RLE, scanlines)
        return b if len(b) <= 1.05 * len(a) else a
    # 8 x 1.5 KB chunks spread over the image (a prefix sample is not
    # representative — e.g. a smooth sky at the top of a photo). The
    # decision only needs RELATIVE sizes, so the sample compresses at
    # level 2 regardless of the requested level (the Z_DEFAULT side of a
    # 32 KB sample alone cost ~0.6 ms/image — ~15% of a 0.25 MPix encode)
    step = max(1536, n // 8)
    mv = memoryview(scanlines).cast("B") if not isinstance(scanlines, bytes) \
        else scanlines
    sample = b"".join(bytes(mv[o:o + 1536]) for o in range(0, n, step))

    def _c2(strategy, data):
        co = zlib.compressobj(2, zlib.DEFLATED, 15, 8, strategy)
        return co.compress(data) + co.flush()

    a = _c2(zlib.Z_DEFAULT_STRATEGY, sample)
    # RLE side of the sample via the native one-shot encoder when present
    # (~20x faster than zlib on the sample; sizes track Z_RLE closely
    # enough for a 5%-margin relative decision)
    b = _native_rle_deflate(sample)
    if b is None:
        b = _c2(zlib.Z_RLE, sample)
    use_rle = len(b) <= 1.05 * len(a)
    if use_rle:
        out = _native_rle_deflate(scanlines)
        if out is not None:
            return out
    return _c(zlib.Z_RLE if use_rle else zlib.Z_DEFAULT_STRATEGY, scanlines)


def _native_rle_deflate(scanlines) -> bytes | None:
    """One-shot native encoder for the RLE strategy (~3x zlib's speed
    at near-identical size); None -> caller falls back to zlib.
    Accepts bytes or a 1-D uint8 numpy array."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    n = len(scanlines)
    if isinstance(scanlines, np.ndarray):
        src = scanlines.ctypes.data_as(ctypes.c_char_p)
    else:
        src = scanlines
    # the native BitWriter memcpy's 8-byte windows: cap must leave >= 8
    # bytes of headroom past the final stream byte (documented at
    # zt_zlib_rle_compress); 2*n + 4096 is far above both that and any
    # incompressible-stream worst case. np.empty, NOT
    # ctypes.create_string_buffer: the latter zero-fills ~2x the payload
    # on every call (~0.3 ms/MPix measured).
    cap = 2 * n + 4096
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.zt_zlib_rle_compress(src, n,
                                  out.ctypes.data_as(ctypes.c_char_p), cap)
    if rc <= 0:
        return None
    return out[:rc].tobytes()


def save(path: str, arr: np.ndarray, **options) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr, **options))
