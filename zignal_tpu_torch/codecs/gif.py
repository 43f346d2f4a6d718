"""GIF codec (host side).

Decoder: GIF87a/89a, global/local color tables, interlace, transparency,
all four disposal methods, NETSCAPE loop extension; frames are composed
into RGBA (reference: src/codecs/gif.zig). LZW runs in the native C++
core (csrc/host/codec_core.cpp).

Encoder: single-frame and animated — median-cut palette + dithering +
LZW (reference: gif.zig encoder).

Copied from zignal_tpu/codecs/gif.py; its native hot loops come from the
port's own library (zignal_tpu_torch/native.py), and the pure-Python LZW
coders (``_lzw_decode_py``, ``_lzw_encode_py``) stand in when it cannot
be built.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from ..native import get_lib
from ..ops.dither import DitherMode, apply_dither
from ..ops.quantize import ColorLookupTable, median_cut

__all__ = ["DecodeLimits", "GifInfo", "AnimatedImage", "get_info", "decode", "decode_animated",
           "load", "load_from_bytes", "load_animated", "encode",
           "encode_animated", "save", "SIGNATURES"]

SIGNATURES = (b"GIF87a", b"GIF89a")


class GifError(ValueError):
    pass


@dataclasses.dataclass
class DecodeLimits:
    """Anti-bomb resource limits (reference: gif.zig:48)."""

    max_width: int = 1 << 16
    max_height: int = 1 << 16
    max_frames: int = 4096


@dataclasses.dataclass
class GifInfo:
    width: int
    height: int
    frame_count: int
    loop_count: int


@dataclasses.dataclass
class AnimatedImage:
    """Composed frames + per-frame delays (centiseconds) + loop count
    (reference: src/image/animated.zig)."""

    frames: list
    delays: list
    loop_count: int = 0

    @property
    def frame_count(self) -> int:
        return len(self.frames)


def _lzw_decode_py(data: bytes, min_code_size: int,
                   expected: int) -> np.ndarray:
    """Pure-Python GIF LZW decode, semantics mirroring the native
    zt_gif_lzw_decode (truncated streams accepted; KwKwK handled)."""
    clear_code = 1 << min_code_size
    end_code = clear_code + 1
    prefix = [-1] * 4096
    suffix = [0] * 4096
    for i in range(clear_code):
        suffix[i] = i
    code_size = min_code_size + 1
    next_code = end_code + 1
    prev_code = -1
    bitbuf = 0
    bitcnt = 0
    si = 0
    n = len(data)
    out = bytearray()

    def finish():
        res = np.zeros(expected, dtype=np.uint8)
        res[:len(out)] = np.frombuffer(bytes(out), dtype=np.uint8)
        return res

    while True:
        while bitcnt < code_size:
            if si >= n:
                return finish()  # truncated stream: accept what we have
            bitbuf |= data[si] << bitcnt
            si += 1
            bitcnt += 8
        code = bitbuf & ((1 << code_size) - 1)
        bitbuf >>= code_size
        bitcnt -= code_size
        if code == clear_code:
            code_size = min_code_size + 1
            next_code = end_code + 1
            prev_code = -1
            continue
        if code == end_code:
            return finish()
        cur = code
        kwkwk = cur >= next_code
        if kwkwk:
            if prev_code < 0 or cur > next_code:
                raise GifError("corrupt LZW stream")
            cur = prev_code
        chunk = []
        while cur >= 0:
            chunk.append(suffix[cur])
            cur = prefix[cur]
        chunk.reverse()
        first = chunk[0]
        if kwkwk:
            chunk.append(first)
        if len(out) + len(chunk) > expected:
            return finish()
        out += bytes(chunk)
        if prev_code >= 0 and next_code < 4096:
            prefix[next_code] = prev_code
            suffix[next_code] = first
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
        prev_code = code


def _lzw_encode_py(flat: np.ndarray, min_code_size: int) -> bytes:
    """Pure-Python GIF LZW encode mirroring zt_gif_lzw_encode (leading
    clear code, table reset at 4096 codes, LSB-first bit packing)."""
    clear_code = 1 << min_code_size
    end_code = clear_code + 1
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    code_size = min_code_size + 1

    def emit(code):
        nonlocal bitbuf, bitcnt
        bitbuf |= code << bitcnt
        bitcnt += code_size
        while bitcnt >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            bitcnt -= 8

    emit(clear_code)
    data = flat.tolist()
    if not data:
        emit(end_code)
        if bitcnt:
            out.append(bitbuf & 0xFF)
        return bytes(out)
    table = {}
    next_code = end_code + 1
    prev = data[0]
    for byte in data[1:]:
        key = prev * 256 + byte
        nxt = table.get(key)
        if nxt is not None:
            prev = nxt
            continue
        emit(prev)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << code_size) and code_size < 12:
                code_size += 1
        else:
            emit(clear_code)
            table.clear()
            code_size = min_code_size + 1
            next_code = end_code + 1
        prev = byte
    emit(prev)
    emit(end_code)
    if bitcnt:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, min_code_size: int, expected: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _lzw_decode_py(data, min_code_size, expected)
    out = np.zeros(expected, dtype=np.uint8)
    n = lib.zt_gif_lzw_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_char_p), expected,
        min_code_size,
    )
    if n < 0:
        raise GifError("corrupt LZW stream")
    return out


def _deinterlace(idx: np.ndarray) -> np.ndarray:
    h = idx.shape[0]
    out = np.empty_like(idx)
    rows = (list(range(0, h, 8)) + list(range(4, h, 8))
            + list(range(2, h, 4)) + list(range(1, h, 2)))
    out[rows] = idx
    return out


class _Parser:
    def __init__(self, data: bytes):
        if data[:6] not in SIGNATURES:
            raise GifError("not a GIF file")
        self.data = data
        self.pos = 6
        (self.width, self.height, flags, self.bg_index, _ar) = struct.unpack(
            "<HHBBB", data[6:13]
        )
        self.pos = 13
        self.gct = None
        if flags & 0x80:
            n = 2 << (flags & 7)
            self.gct = np.frombuffer(
                data[self.pos:self.pos + n * 3], dtype=np.uint8
            ).reshape(-1, 3)
            self.pos += n * 3
        self.loop_count = 1

    def _sub_blocks(self) -> bytes:
        chunks = []
        while True:
            if self.pos >= len(self.data):
                raise GifError("truncated GIF")
            n = self.data[self.pos]
            self.pos += 1
            if n == 0:
                break
            chunks.append(self.data[self.pos:self.pos + n])
            self.pos += n
        return b"".join(chunks)

    def frames(self):
        """Yield (indices [h,w], local_palette, l, t, delay_cs,
        transparent_index, disposal)."""
        delay = 0
        transparent = None
        disposal = 0
        data = self.data
        while self.pos < len(data):
            block = data[self.pos]
            self.pos += 1
            if block == 0x3B:  # trailer
                return
            if block == 0x21:  # extension
                label = data[self.pos]
                self.pos += 1
                if label == 0xF9:  # graphic control
                    payload = self._sub_blocks()
                    if len(payload) >= 4:
                        flags, delay, tidx = struct.unpack("<BHB", payload[:4])
                        disposal = (flags >> 2) & 7
                        transparent = tidx if flags & 1 else None
                elif label == 0xFF:  # application
                    payload = self._sub_blocks()
                    if payload[:11] == b"NETSCAPE2.0" and len(payload) >= 14:
                        self.loop_count = struct.unpack("<H", payload[12:14])[0]
                else:
                    self._sub_blocks()
            elif block == 0x2C:  # image descriptor
                l, t, w, h, flags = struct.unpack(
                    "<HHHHB", data[self.pos:self.pos + 9]
                )
                self.pos += 9
                palette = self.gct
                if flags & 0x80:
                    n = 2 << (flags & 7)
                    palette = np.frombuffer(
                        data[self.pos:self.pos + n * 3], dtype=np.uint8
                    ).reshape(-1, 3)
                    self.pos += n * 3
                if palette is None:
                    raise GifError("frame has no color table")
                min_code = data[self.pos]
                self.pos += 1
                lzw = self._sub_blocks()
                idx = _lzw_decode(lzw, min_code, w * h)
                idx = idx[: w * h].reshape(h, w)
                if flags & 0x40:
                    idx = _deinterlace(idx)
                yield idx, palette, l, t, delay, transparent, disposal
                delay = 0
                transparent = None
                disposal = 0
            else:
                raise GifError(f"unknown GIF block 0x{block:02x}")


def get_info(data: bytes) -> GifInfo:
    p = _Parser(data)
    count = sum(1 for _ in p.frames())
    return GifInfo(p.width, p.height, count, p.loop_count)


def decode_animated(data: bytes, limits: DecodeLimits | None = None) -> AnimatedImage:
    """Decode + compose all frames -> RGBA arrays
    (reference: gif.zig loadAnimated/compose)."""
    limits = limits or DecodeLimits()
    p = _Parser(data)
    if p.width > limits.max_width or p.height > limits.max_height:
        raise GifError("image exceeds decode limits")
    canvas = np.zeros((p.height, p.width, 4), dtype=np.uint8)
    frames = []
    delays = []
    for idx, palette, l, t, delay, transparent, disposal in p.frames():
        h, w = idx.shape
        prev = canvas.copy() if disposal == 3 else None
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        alpha = np.full((h, w), 255, dtype=np.uint8)
        if transparent is not None:
            alpha[idx == transparent] = 0
        region = canvas[t:t + h, l:l + w]
        mask = alpha > 0
        region[mask] = np.concatenate([rgb, alpha[..., None]], axis=-1)[mask]
        frames.append(canvas.copy())
        delays.append(delay)
        if len(frames) > limits.max_frames:
            raise GifError("frame count exceeds decode limits")
        if disposal == 2:  # restore to background (transparent)
            canvas[t:t + h, l:l + w] = 0
        elif disposal == 3 and prev is not None:  # restore to previous
            canvas = prev
    if not frames:
        raise GifError("GIF contains no image frames")
    return AnimatedImage(frames, delays, p.loop_count)


def decode(data: bytes):
    anim = decode_animated(data)
    return anim.frames[0], GifInfo(
        anim.frames[0].shape[1], anim.frames[0].shape[0],
        anim.frame_count, anim.loop_count,
    )


def load_from_bytes(data: bytes):
    return decode(data)[0]


def load(path: str):
    with open(path, "rb") as f:
        return load_from_bytes(f.read())


def load_animated(path: str) -> AnimatedImage:
    with open(path, "rb") as f:
        return decode_animated(f.read())


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    lib = get_lib()
    flat = np.ascontiguousarray(indices.reshape(-1))
    if lib is None:
        return _lzw_encode_py(flat, min_code_size)
    cap = flat.size * 2 + 1024
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.zt_gif_lzw_encode(
        flat.ctypes.data_as(ctypes.c_char_p), flat.size,
        out.ctypes.data_as(ctypes.c_char_p), cap, min_code_size,
    )
    if n < 0:
        raise GifError("LZW encode overflow")
    return out[:n].tobytes()


def _quantize_frame(arr: np.ndarray, max_colors: int, dither: str):
    rgb = np.ascontiguousarray(arr[..., :3]).copy()
    palette = median_cut(rgb, max_colors)
    lut = ColorLookupTable(palette)
    indices = apply_dither(rgb, palette, lut, dither)
    return palette, indices.astype(np.uint8)


def _palette_block(palette: np.ndarray):
    n = len(palette)
    bits = max(1, (n - 1).bit_length())
    size = 1 << bits
    padded = np.zeros((size, 3), dtype=np.uint8)
    padded[:n] = palette
    return padded.tobytes(), bits


def _frame_blocks(indices: np.ndarray, palette: np.ndarray,
                  delay_cs: int | None, transparent: int | None) -> bytes:
    h, w = indices.shape
    pal_bytes, bits = _palette_block(palette)
    out = bytearray()
    if delay_cs is not None or transparent is not None:
        flags = (1 if transparent is not None else 0)
        out += b"\x21\xf9\x04" + struct.pack(
            "<BHB", flags, delay_cs or 0, transparent or 0
        ) + b"\x00"
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1))
    out += pal_bytes
    min_code = max(2, bits)
    out.append(min_code)
    lzw = _lzw_encode(indices, min_code)
    for i in range(0, len(lzw), 255):
        chunk = lzw[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode(arr: np.ndarray, max_colors: int = 256,
           dither: str = DitherMode.AUTO) -> bytes:
    """Encode a uint8 [H,W,C] array as a single-frame GIF89a."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError("encode expects a uint8 [H, W, {1,3,4}] array")
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    h, w = arr.shape[:2]
    palette, indices = _quantize_frame(arr, max_colors, dither)
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0, 0, 0)  # no GCT; per-frame LCT
    out += _frame_blocks(indices, palette, None, None)
    out += b"\x3b"
    return bytes(out)


def encode_animated(frames, delays_cs, loop_count: int = 0,
                    max_colors: int = 256,
                    dither: str = DitherMode.AUTO) -> bytes:
    """Encode an animated GIF from a list of uint8 [H,W,C] frames."""
    if not frames:
        raise ValueError("need at least one frame")
    h, w = frames[0].shape[:2]
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0, 0, 0)
    out += (b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
            + struct.pack("<H", loop_count) + b"\x00")
    for frame, delay in zip(frames, delays_cs):
        arr = np.ascontiguousarray(frame)
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        palette, indices = _quantize_frame(arr, max_colors, dither)
        out += _frame_blocks(indices, palette, int(delay), None)
    out += b"\x3b"
    return bytes(out)


def save(path: str, arr: np.ndarray, **options) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr, **options))
