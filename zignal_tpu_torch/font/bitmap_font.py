"""BitmapFont: glyph bitmaps + metrics, BDF/PCF load, BDF save
(reference: src/font/BitmapFont.zig, bdf.zig, pcf.zig).

Glyphs are stored as boolean numpy arrays; text rendering composites
them as masks (the device path gets a glyph-atlas texture in Canvas).

Copied from zignal_tpu/font/bitmap_font.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ._font8x8_data import FONT8X8_BASIC
from .unicode import codepoint_in, normalize_filter

__all__ = ["BitmapFont"]


class BitmapFont:
    """Monospace-or-proportional bitmap font."""

    def __init__(self, name="font", glyphs=None, advances=None,
                 ascent=8, descent=0):
        self.name = name
        self.glyphs = glyphs or {}        # codepoint -> bool [h, w]
        self.advances = advances or {}    # codepoint -> int
        self.ascent = ascent
        self.descent = descent

    @property
    def line_height(self) -> int:
        return self.ascent + self.descent

    # -- constructors -------------------------------------------------------

    _font8x8_cache = None

    @classmethod
    def font8x8(cls) -> "BitmapFont":
        """The built-in public-domain 8x8 font (reference: font8x8.zig)."""
        if cls._font8x8_cache is None:
            glyphs = {}
            advances = {}
            for cp, rows in enumerate(FONT8X8_BASIC):
                g = np.zeros((8, 8), dtype=bool)
                for r, byte in enumerate(rows):
                    for c in range(8):
                        g[r, c] = bool((byte >> c) & 1)  # LSB = left
                glyphs[cp] = g
                advances[cp] = 8
            cls._font8x8_cache = cls("font8x8", glyphs, advances, 8, 0)
        return cls._font8x8_cache

    @classmethod
    def load(cls, path: str, filter=None) -> "BitmapFont":
        """Load a BDF or PCF font, optionally gzip-compressed.

        `filter` restricts which codepoints are kept: None (all), a
        `unicode.Range` / (start, end) tuple, or a list of them
        (reference: bdf.zig:65 / pcf.zig:189 LoadFilter).
        """
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            data = f.read()
        return cls.load_from_bytes(data, filter)

    @classmethod
    def load_from_bytes(cls, data: bytes, filter=None) -> "BitmapFont":
        filt = normalize_filter(filter)
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        if data[:9] == b"STARTFONT":
            return cls._parse_bdf(data.decode("latin-1"), filt)
        if data[:4] == b"\x01fcp":
            return cls._parse_pcf(data, filt)
        raise ValueError("unrecognized font format (expected BDF or PCF)")

    # -- metrics ------------------------------------------------------------

    def glyph(self, char: str):
        return self.glyphs.get(ord(char))

    def advance(self, char: str) -> int:
        return self.advances.get(ord(char), 0)

    def text_bounds(self, text: str, scale: float = 1.0):
        """(width, height) of rendered text."""
        width = 0
        max_width = 0
        lines = 1
        for ch in text:
            if ch == "\n":
                lines += 1
                max_width = max(max_width, width)
                width = 0
            else:
                width += self.advances.get(ord(ch), 0)
        max_width = max(max_width, width)
        return (int(max_width * scale), int(lines * self.line_height * scale))

    def render_mask(self, text: str, scale: int = 1) -> np.ndarray:
        """Boolean mask of the rendered text (integer scales)."""
        w, h = self.text_bounds(text, scale)
        mask = np.zeros((max(h, 1), max(w, 1)), dtype=bool)
        x = 0
        y = 0
        for ch in text:
            if ch == "\n":
                x = 0
                y += self.line_height * scale
                continue
            g = self.glyphs.get(ord(ch))
            adv = self.advances.get(ord(ch), 0)
            if g is not None:
                gs = np.kron(g, np.ones((scale, scale), dtype=bool))
                gh, gw = gs.shape
                mask[y:y + gh, x:x + gw] |= gs[: mask.shape[0] - y,
                                               : mask.shape[1] - x]
            x += adv * scale
        return mask

    # -- BDF ----------------------------------------------------------------

    @classmethod
    def _parse_bdf(cls, text: str, filt=None) -> "BitmapFont":
        font = cls("bdf")
        lines = iter(text.splitlines())
        cp = None
        bbx = None
        dwidth = 8
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "FONT" and len(parts) > 1:
                font.name = parts[1]
            elif key == "FONT_ASCENT":
                font.ascent = int(parts[1])
            elif key == "FONT_DESCENT":
                font.descent = int(parts[1])
            elif key == "ENCODING":
                cp = int(parts[1])
            elif key == "DWIDTH":
                dwidth = int(parts[1])
            elif key == "BBX":
                bbx = tuple(int(v) for v in parts[1:5])
            elif key == "BITMAP":
                rows = []
                for bl in lines:
                    if bl.strip() == "ENDCHAR":
                        break
                    rows.append(bl.strip())
                if cp is not None and cp >= 0 and bbx is not None \
                        and codepoint_in(cp, filt):
                    w, h = bbx[0], bbx[1]
                    g = np.zeros((h, w), dtype=bool)
                    for r, hexrow in enumerate(rows[:h]):
                        bits = int(hexrow or "0", 16)
                        nbits = len(hexrow) * 4
                        for c in range(w):
                            g[r, c] = bool((bits >> (nbits - 1 - c)) & 1)
                    font.glyphs[cp] = g
                    font.advances[cp] = dwidth
                cp = None
                bbx = None
        if not font.glyphs:
            raise ValueError("BDF file contains no glyphs")
        return font

    def save(self, path: str) -> None:
        """Write the font; format picked by extension: .pcf[.gz] -> PCF,
        otherwise BDF (reference: bdf.zig:828, pcf.zig:1329)."""
        base = path[:-3] if path.endswith(".gz") else path
        if base.endswith(".pcf"):
            self.save_pcf(path)
        else:
            self.save_bdf(path)

    def save_bdf(self, path: str) -> None:
        """Write the font as BDF (reference: BitmapFont.zig:310)."""
        out = []
        out.append("STARTFONT 2.1")
        out.append(f"FONT {self.name}")
        out.append(f"SIZE {self.line_height} 75 75")
        out.append(f"FONTBOUNDINGBOX 8 {self.line_height} 0 {-self.descent}")
        out.append("STARTPROPERTIES 2")
        out.append(f"FONT_ASCENT {self.ascent}")
        out.append(f"FONT_DESCENT {self.descent}")
        out.append("ENDPROPERTIES")
        out.append(f"CHARS {len(self.glyphs)}")
        for cp in sorted(self.glyphs):
            g = self.glyphs[cp]
            h, w = g.shape
            out.append(f"STARTCHAR U+{cp:04X}")
            out.append(f"ENCODING {cp}")
            out.append(f"SWIDTH {self.advances.get(cp, w) * 100} 0")
            out.append(f"DWIDTH {self.advances.get(cp, w)} 0")
            out.append(f"BBX {w} {h} 0 {-self.descent}")
            out.append("BITMAP")
            nbytes = (w + 7) // 8
            for r in range(h):
                bits = 0
                for c in range(w):
                    if g[r, c]:
                        bits |= 1 << (nbytes * 8 - 1 - c)
                out.append(f"{bits:0{nbytes * 2}X}")
            out.append("ENDCHAR")
        out.append("ENDFONT")
        data = "\n".join(out).encode("latin-1")
        if path.endswith(".gz"):
            data = gzip.compress(data)
        with open(path, "wb") as f:
            f.write(data)

    # -- PCF ----------------------------------------------------------------

    _PCF_PROPERTIES = 1 << 0
    _PCF_METRICS = 1 << 2
    _PCF_BITMAPS = 1 << 3
    _PCF_ENCODINGS = 1 << 5
    _PCF_ACCELERATORS = 1 << 1

    @classmethod
    def _parse_pcf(cls, data: bytes, filt=None) -> "BitmapFont":
        """Minimal PCF reader: metrics + bitmaps + encodings
        (reference: src/font/pcf.zig)."""
        (count,) = struct.unpack_from("<I", data, 4)
        tables = {}
        for i in range(count):
            ttype, fmt, size, offset = struct.unpack_from("<IIII", data, 8 + i * 16)
            tables[ttype] = (fmt, size, offset)

        def read_u(fmt, data, off, size):
            big = bool(fmt & 4)
            return int.from_bytes(data[off:off + size], "big" if big else "little")

        if cls._PCF_METRICS not in tables or cls._PCF_BITMAPS not in tables \
                or cls._PCF_ENCODINGS not in tables:
            raise ValueError("PCF file missing required tables")

        # metrics
        _, _, off = tables[cls._PCF_METRICS]
        (tfmt,) = struct.unpack_from("<I", data, off)
        endian = ">" if tfmt & (1 << 2) else "<"
        pos = off + 4
        compressed = bool(tfmt & 0x100)
        metrics = []
        if compressed:
            (n,) = struct.unpack_from(endian + "H", data, pos)
            pos += 2
            for _ in range(n):
                lsb, rsb, width, asc, desc = struct.unpack_from("5B", data, pos)
                pos += 5
                metrics.append((lsb - 128, rsb - 128, width - 128,
                                asc - 128, desc - 128))
        else:
            (n,) = struct.unpack_from(endian + "I", data, pos)
            pos += 4
            for _ in range(n):
                vals = struct.unpack_from(endian + "5h", data, pos)
                pos += 12  # 5 i16 + attributes u16
                metrics.append(tuple(vals))

        # bitmaps
        off = tables[cls._PCF_BITMAPS][2]
        (bfmt,) = struct.unpack_from("<I", data, off)
        endian = ">" if bfmt & (1 << 2) else "<"
        pos = off + 4
        (nbitmaps,) = struct.unpack_from(endian + "I", data, pos)
        pos += 4
        offsets = struct.unpack_from(endian + f"{nbitmaps}I", data, pos)
        pos += 4 * nbitmaps
        bitmap_sizes = struct.unpack_from(endian + "4I", data, pos)
        pos += 16
        glyph_pad = bfmt & 3
        pad_bytes = (1, 2, 4, 8)[glyph_pad]
        bitmap_data = data[pos:pos + bitmap_sizes[glyph_pad]]
        msb_bits = bool(bfmt & 8)

        # encodings
        off = tables[cls._PCF_ENCODINGS][2]
        (efmt,) = struct.unpack_from("<I", data, off)
        endian = ">" if efmt & (1 << 2) else "<"
        min_c2, max_c2, min_c1, max_c1, default = struct.unpack_from(
            endian + "5H", data, off + 4
        )
        pos = off + 14
        ncols = max_c2 - min_c2 + 1
        nrows = max_c1 - min_c1 + 1
        glyph_indices = struct.unpack_from(endian + f"{ncols * nrows}H",
                                           data, pos)

        font = cls("pcf")
        asc_max = max((m[3] for m in metrics), default=8)
        desc_max = max((m[4] for m in metrics), default=0)
        font.ascent = asc_max
        font.descent = desc_max
        for row in range(nrows):
            for col in range(ncols):
                cp = ((min_c1 + row) << 8 | (min_c2 + col)) if max_c1 else (min_c2 + col)
                gi = glyph_indices[row * ncols + col]
                if gi == 0xFFFF or gi >= len(metrics):
                    continue
                if not codepoint_in(cp, filt):
                    continue
                lsb, rsb, width, asc, desc = metrics[gi][:5]
                gh = asc + desc
                gw = max(rsb - lsb, width, 1)
                start = offsets[gi]
                rowlen = ((gw + 7) // 8 + pad_bytes - 1) // pad_bytes * pad_bytes
                g = np.zeros((max(gh, 1), gw), dtype=bool)
                for r in range(gh):
                    base = start + r * rowlen
                    for c in range(gw):
                        byte = bitmap_data[base + c // 8] if base + c // 8 < len(bitmap_data) else 0
                        bit = (byte >> (7 - c % 8)) & 1 if msb_bits else (byte >> (c % 8)) & 1
                        g[r, c] = bool(bit)
                font.glyphs[cp] = g
                font.advances[cp] = width
        if not font.glyphs:
            raise ValueError("PCF file contains no glyphs")
        return font

    def save_pcf(self, path: str) -> None:
        """Write the font as PCF (reference: pcf.zig:1329 save).

        Tables: properties, accelerators, metrics (uncompressed),
        bitmaps, BDF encodings, swidths. Big-endian data, MSB-first
        bits, 1-byte glyph row padding (format dword 0x0C).
        """
        FMT = 0x0C  # byte order=big (bit 2), bit order=MSB (bit 3), pad=1
        cps = sorted(cp for cp in self.glyphs if 0 <= cp <= 0xFFFF)
        if not cps:
            raise ValueError("font has no glyphs to save")

        metrics = []     # (lsb, rsb, width, ascent, descent)
        offsets = []
        bitmap = bytearray()
        for cp in cps:
            g = self.glyphs[cp]
            h, w = g.shape
            adv = self.advances.get(cp, w)
            metrics.append((0, w, adv, h - self.descent, self.descent))
            offsets.append(len(bitmap))
            gw = max(w, adv, 1)  # row length mirrors the reader's glyph width
            if gw > w:
                g = np.pad(g, ((0, 0), (0, gw - w)))
            packed = np.packbits(g, axis=1)  # MSB-first, rows padded to bytes
            bitmap += packed.tobytes()

        def metric_bytes(m):
            lsb, rsb, width, asc, desc = m
            return struct.pack(">5hH", lsb, rsb, width, asc, desc, 0)

        # metrics table (uncompressed)
        t_metrics = struct.pack("<I", FMT) + struct.pack(">I", len(metrics))
        t_metrics += b"".join(metric_bytes(m) for m in metrics)

        # bitmaps table
        t_bitmaps = struct.pack("<I", FMT) + struct.pack(">I", len(cps))
        t_bitmaps += struct.pack(f">{len(cps)}I", *offsets)
        n = len(bitmap)
        t_bitmaps += struct.pack(">4I", n, n, n, n)  # sizes for pad 1/2/4/8
        t_bitmaps += bytes(bitmap)

        # BDF encodings table
        if cps[-1] > 0xFF:
            min_c1, max_c1 = min(cp >> 8 for cp in cps), max(cp >> 8 for cp in cps)
            min_c2, max_c2 = min(cp & 0xFF for cp in cps), max(cp & 0xFF for cp in cps)
        else:
            min_c1 = max_c1 = 0
            min_c2, max_c2 = cps[0], cps[-1]
        ncols = max_c2 - min_c2 + 1
        nrows = max_c1 - min_c1 + 1
        table = [0xFFFF] * (ncols * nrows)
        for gi, cp in enumerate(cps):
            c1, c2 = cp >> 8, cp & 0xFF
            table[(c1 - min_c1) * ncols + (c2 - min_c2)] = gi
        t_enc = struct.pack("<I", FMT) + struct.pack(
            ">5H", min_c2, max_c2, min_c1, max_c1, 0
        ) + struct.pack(f">{len(table)}H", *table)

        # accelerators table
        widths = {m[2] for m in metrics}
        minb = tuple(min(m[i] for m in metrics) for i in range(5))
        maxb = tuple(max(m[i] for m in metrics) for i in range(5))
        t_accel = struct.pack("<I", FMT)
        t_accel += struct.pack(
            "8B", 0, int(len(widths) == 1 and len({g.shape for g in self.glyphs.values()}) == 1),
            0, int(len(widths) == 1), 1, 0, 0, 0
        )
        t_accel += struct.pack(">3i", self.ascent, self.descent, 0)
        t_accel += metric_bytes(minb) + metric_bytes(maxb)

        # properties table (empty) + swidths
        t_props = struct.pack("<I", FMT) + struct.pack(">3I", 0, 0, 0)
        t_swidths = struct.pack("<I", FMT) + struct.pack(">I", len(cps))
        t_swidths += struct.pack(f">{len(cps)}i", *(m[2] * 1000 // max(self.line_height, 1)
                                                    for m in metrics))

        entries = [
            (self._PCF_PROPERTIES, t_props),
            (self._PCF_ACCELERATORS, t_accel),
            (self._PCF_METRICS, t_metrics),
            (self._PCF_BITMAPS, t_bitmaps),
            (self._PCF_ENCODINGS, t_enc),
            (1 << 6, t_swidths),  # PCF_SWIDTHS
        ]
        header = bytearray(b"\x01fcp" + struct.pack("<I", len(entries)))
        offset = 8 + 16 * len(entries)
        body = bytearray()
        for ttype, blob in entries:
            if offset % 4:  # tables are 32-bit aligned
                pad = 4 - offset % 4
                body += b"\x00" * pad
                offset += pad
            header += struct.pack("<IIII", ttype, FMT, len(blob), offset)
            body += blob
            offset += len(blob)
        data = bytes(header + body)
        if path.endswith(".gz"):
            data = gzip.compress(data)
        with open(path, "wb") as f:
            f.write(data)

    def __repr__(self):
        return (f"BitmapFont(name={self.name!r}, glyphs={len(self.glyphs)}, "
                f"ascent={self.ascent}, descent={self.descent})")
