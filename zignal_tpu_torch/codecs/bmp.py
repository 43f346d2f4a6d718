"""BMP codec (host side).

Decoder covering the reference's scope (reference: src/codecs/bmp.zig:
core/info/V4/V5 headers, 1/4/8/16/24/32 bpp, RLE4/RLE8, BI_BITFIELDS,
top-down and bottom-up row orders, palettes) and the narrow encoder
(24bpp RGB, 32bpp RGBA, 8bpp gray).

Copied from zignal_tpu/codecs/bmp.py (pure numpy; the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = ["DecodeLimits", "BmpInfo", "get_info", "decode", "load", "load_from_bytes",
           "encode", "save", "SIGNATURE"]

SIGNATURE = b"BM"


class BmpError(ValueError):
    pass


@dataclasses.dataclass
class DecodeLimits:
    """Anti-bomb resource limits (reference: bmp.zig:37)."""

    max_width: int = 1 << 16
    max_height: int = 1 << 16


@dataclasses.dataclass
class BmpInfo:
    width: int
    height: int
    bit_count: int
    compression: int
    top_down: bool


def _parse_header(data: bytes):
    if len(data) < 26 or data[:2] != SIGNATURE:
        raise BmpError("not a BMP file")
    data_offset = struct.unpack("<I", data[10:14])[0]
    header_size = struct.unpack("<I", data[14:18])[0]
    if header_size == 12:  # BITMAPCOREHEADER
        w, h, planes, bpp = struct.unpack("<HHHH", data[18:26])
        compression = 0
        palette_off = 14 + 12
        palette_entry = 3
        clr_used = 0
        masks = None
    elif header_size in (40, 52, 56, 64, 108, 124):
        w, h, planes, bpp, compression, _size, _xp, _yp, clr_used, _ci = struct.unpack(
            "<iiHHIIiiII", data[18:54]
        )
        palette_off = 14 + header_size
        palette_entry = 4
        masks = None
        if compression == 3:  # BI_BITFIELDS
            if header_size >= 52 or len(data) >= 66:
                if header_size == 40:
                    masks = struct.unpack("<III", data[54:66])
                    palette_off = 66
                else:
                    masks = struct.unpack("<III", data[54:66])
            if header_size >= 108:
                masks = struct.unpack("<IIII", data[54:70])[:3] + (
                    struct.unpack("<I", data[66:70])[0],
                )
                masks = struct.unpack("<IIII", data[54:70])
    else:
        raise BmpError(f"unsupported BMP header size {header_size}")
    top_down = h < 0
    return (
        BmpInfo(w, abs(h), bpp, compression, top_down),
        data_offset, palette_off, palette_entry, clr_used, masks,
    )


def get_info(data: bytes) -> BmpInfo:
    return _parse_header(data)[0]


def _decode_rle(data: bytes, w: int, h: int, bpp4: bool) -> np.ndarray:
    out = np.zeros((h, w), dtype=np.uint8)
    x = y = 0
    i = 0
    n = len(data)
    while i + 1 < n:
        count, value = data[i], data[i + 1]
        i += 2
        if count > 0:
            if bpp4:
                hi, lo = value >> 4, value & 0xF
                for k in range(count):
                    if x < w and y < h:
                        out[y, x] = hi if k % 2 == 0 else lo
                    x += 1
            else:
                end = min(x + count, w)
                if y < h:
                    out[y, x:end] = value
                x += count
        else:
            if value == 0:  # end of line
                x, y = 0, y + 1
            elif value == 1:  # end of bitmap
                break
            elif value == 2:  # delta
                if i + 1 < n:
                    x += data[i]
                    y += data[i + 1]
                    i += 2
            else:  # absolute run
                cnt = value
                if bpp4:
                    nbytes = (cnt + 1) // 2
                    chunk = data[i:i + nbytes]
                    i += nbytes + (nbytes & 1)
                    for k in range(cnt):
                        v = chunk[k // 2]
                        px = v >> 4 if k % 2 == 0 else v & 0xF
                        if x < w and y < h:
                            out[y, x] = px
                        x += 1
                else:
                    chunk = data[i:i + cnt]
                    i += cnt + (cnt & 1)
                    end = min(x + cnt, w)
                    if y < h:
                        out[y, x:end] = np.frombuffer(
                            chunk[: end - x], dtype=np.uint8
                        )
                    x += cnt
        if y >= h:
            break
    return out


def _mask_shift(mask: int):
    if mask == 0:
        return 0, 0, 1
    shift = (mask & -mask).bit_length() - 1
    width = (mask >> shift).bit_length()
    maxval = (mask >> shift)
    return shift, width, max(1, maxval)


def decode(data: bytes, limits: DecodeLimits | None = None):
    """Decode BMP bytes -> (uint8 [H,W,C] array with C in 1/3/4, BmpInfo)."""
    limits = limits or DecodeLimits()
    info, data_offset, pal_off, pal_entry, clr_used, masks = _parse_header(data)
    w, h, bpp = info.width, info.height, info.bit_count
    if w <= 0 or h == 0:
        raise BmpError("invalid BMP dimensions")
    if w > limits.max_width or abs(h) > limits.max_height:
        raise BmpError("image exceeds decode limits")
    comp = info.compression

    palette = None
    if bpp <= 8:
        n_colors = clr_used or (1 << bpp)
        raw = data[pal_off:pal_off + n_colors * pal_entry]
        pal = np.frombuffer(raw, dtype=np.uint8).reshape(-1, pal_entry)
        palette = pal[:, [2, 1, 0]]  # BGR(A) -> RGB

    pixels = data[data_offset:]

    if comp in (1, 2):  # RLE8 / RLE4
        idx = _decode_rle(pixels, w, h, bpp4=(comp == 2))
        if not info.top_down:
            idx = idx[::-1]
        out = palette[np.minimum(idx, len(palette) - 1)]
    elif bpp == 1 or bpp == 4 or bpp == 8:
        stride = ((w * bpp + 31) // 32) * 4
        rows = np.frombuffer(pixels[: stride * h], dtype=np.uint8).reshape(h, stride)
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)
            if bpp == 1:
                idx = bits[:, :w]
            else:
                v = bits.reshape(h, -1, 4)
                weights = np.array([8, 4, 2, 1], dtype=np.uint8)
                idx = (v * weights).sum(axis=2)[:, :w]
        if not info.top_down:
            idx = idx[::-1]
        out = palette[np.minimum(idx.astype(np.int64), len(palette) - 1)]
    elif bpp == 16:
        stride = ((w * 2 + 3) // 4) * 4
        rows = np.frombuffer(pixels[: stride * h], dtype=np.uint8).reshape(h, stride)
        vals = rows[:, : w * 2].reshape(h, w, 2).astype(np.uint32)
        v16 = vals[..., 0] | (vals[..., 1] << 8)
        if comp == 3 and masks:
            rm, gm, bm = masks[0], masks[1], masks[2]
            am = masks[3] if len(masks) > 3 else 0
        else:
            rm, gm, bm, am = 0x7C00, 0x03E0, 0x001F, 0
        chans = []
        for m in (rm, gm, bm):
            sh, _, mx = _mask_shift(m)
            chans.append((((v16 & m) >> sh) * 255 // mx).astype(np.uint8))
        out = np.stack(chans, axis=-1)
        if am:
            sh, _, mx = _mask_shift(am)
            a = (((v16 & am) >> sh) * 255 // mx).astype(np.uint8)
            out = np.concatenate([out, a[..., None]], axis=-1)
        if not info.top_down:
            out = out[::-1]
    elif bpp == 24:
        stride = ((w * 3 + 3) // 4) * 4
        rows = np.frombuffer(pixels[: stride * h], dtype=np.uint8).reshape(h, stride)
        out = rows[:, : w * 3].reshape(h, w, 3)[..., ::-1]  # BGR -> RGB
        if not info.top_down:
            out = out[::-1]
    elif bpp == 32:
        stride = w * 4
        rows = np.frombuffer(pixels[: stride * h], dtype=np.uint8).reshape(h, stride)
        px = rows.reshape(h, w, 4)
        if comp == 3 and masks:
            v32 = px.astype(np.uint32)
            v = v32[..., 0] | (v32[..., 1] << 8) | (v32[..., 2] << 16) | (v32[..., 3] << 24)
            chans = []
            use = list(masks[:3]) + ([masks[3]] if len(masks) > 3 and masks[3] else [])
            for m in use:
                sh, _, mx = _mask_shift(m)
                chans.append((((v & m) >> sh) * 255 // mx).astype(np.uint8))
            out = np.stack(chans, axis=-1)
        else:
            out = px[..., [2, 1, 0, 3]]  # BGRA -> RGBA
        if not info.top_down:
            out = out[::-1]
    else:
        raise BmpError(f"unsupported bit count {bpp}")

    return np.ascontiguousarray(out), info


def load_from_bytes(data: bytes):
    return decode(data)[0]


def load(path: str):
    with open(path, "rb") as f:
        return load_from_bytes(f.read())


def encode(arr: np.ndarray) -> bytes:
    """Encode uint8 [H,W,C] as BMP: 8bpp gray (palette), 24bpp RGB, 32bpp RGBA
    (reference: bmp.zig narrow encoder)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError("encode expects a uint8 [H, W, {1,3,4}] array")
    h, w, ch = arr.shape
    if ch == 1:
        stride = (w + 3) & ~3
        rows = np.zeros((h, stride), dtype=np.uint8)
        rows[:, :w] = arr[::-1, :, 0]
        palette = bytes(
            b for i in range(256) for b in (i, i, i, 0)
        )
        pix = rows.tobytes()
        off = 14 + 40 + 1024
        header = struct.pack("<2sIHHI", b"BM", off + len(pix), 0, 0, off)
        dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(pix), 2835, 2835, 256, 0)
        return header + dib + palette + pix
    if ch == 3:
        stride = ((w * 3 + 3) // 4) * 4
        rows = np.zeros((h, stride), dtype=np.uint8)
        rows[:, : w * 3] = arr[::-1, :, ::-1].reshape(h, w * 3)
        pix = rows.tobytes()
        off = 14 + 40
        header = struct.pack("<2sIHHI", b"BM", off + len(pix), 0, 0, off)
        dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix), 2835, 2835, 0, 0)
        return header + dib + pix
    # RGBA: V4 header with alpha bitfields
    px = arr[::-1][..., [2, 1, 0, 3]].reshape(h, w * 4)
    pix = px.tobytes()
    off = 14 + 108
    header = struct.pack("<2sIHHI", b"BM", off + len(pix), 0, 0, off)
    dib = struct.pack(
        "<IiiHHIIiiII", 108, w, h, 1, 32, 3, len(pix), 2835, 2835, 0, 0
    ) + struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
    dib += b"\x00" * (108 - 40 - 16)
    return header + dib + pix


def save(path: str, arr: np.ndarray, **_options) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr))
