"""Display formatting: auto degradation kitty -> iterm2 -> sixel -> sgr,
plus SGR half-blocks and 2x4 braille (reference: src/image/display.zig).

Copied from zignal_tpu/terminal/display.py.
"""

from __future__ import annotations

import numpy as np

from .detect import detect_terminal_support
from .iterm2 import iterm2_from_image
from .kitty import kitty_from_image
from .sixel import sixel_from_image

__all__ = ["DisplayFormat", "format_image", "sgr_from_image",
           "braille_from_image"]


class DisplayFormat:
    AUTO = "auto"
    KITTY = "kitty"
    ITERM2 = "iterm2"
    SIXEL = "sixel"
    SGR = "sgr"
    BRAILLE = "braille"


def sgr_from_image(image) -> str:
    """Unicode half-block rendering: U+2580 with fg=top row, bg=bottom row
    (display.zig sgr path)."""
    from ..image import _convert_array_u8

    arr = _convert_array_u8(image._host(), image._space, "rgb")
    h, w = arr.shape[:2]
    if h % 2:
        arr = np.vstack([arr, np.zeros((1, w, 3), dtype=np.uint8)])
        h += 1
    out = []
    for r in range(0, h, 2):
        line = []
        for c in range(w):
            tr, tg, tb = (int(v) for v in arr[r, c])
            br, bg, bb = (int(v) for v in arr[r + 1, c])
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        line.append("\x1b[0m")
        out.append("".join(line))
    return "\n".join(out)


# braille dot bit layout: dots 1-8 -> (row, col) within the 2x4 cell
_BRAILLE_BITS = [
    (0, 0, 0x01), (1, 0, 0x02), (2, 0, 0x04), (3, 0, 0x40),
    (0, 1, 0x08), (1, 1, 0x10), (2, 1, 0x20), (3, 1, 0x80),
]


def braille_from_image(image, threshold: float = 0.5, color: bool = True,
                       palette=None) -> str:
    """2x4 braille-cell rendering with optional per-cell tint
    (display.zig braille path)."""
    from ..image import _convert_array_u8

    arr = _convert_array_u8(image._host(), image._space, "rgb")
    h, w = arr.shape[:2]
    ph = (h + 3) // 4 * 4
    pw = (w + 1) // 2 * 2
    padded = np.zeros((ph, pw, 3), dtype=np.uint8)
    padded[:h, :w] = arr
    luma = (0.2126 * padded[..., 0] + 0.7152 * padded[..., 1]
            + 0.0722 * padded[..., 2]) / 255.0
    on = luma >= threshold

    pal = None
    if color and palette is not None:
        from ..ops.quantize import ColorLookupTable, build_palette

        pal_arr = build_palette(arr, palette, 32)
        pal = (pal_arr, ColorLookupTable(pal_arr))

    out = []
    for r in range(0, ph, 4):
        line = []
        for c in range(0, pw, 2):
            code = 0
            lit = []
            for dr, dc, bit in _BRAILLE_BITS:
                if on[r + dr, c + dc]:
                    code |= bit
                    lit.append(padded[r + dr, c + dc])
            ch = chr(0x2800 + code)
            if color and lit:
                avg = np.mean(lit, axis=0).astype(np.uint8)
                if pal is not None:
                    avg = pal[0][pal[1].lookup(avg)]
                line.append(f"\x1b[38;2;{avg[0]};{avg[1]};{avg[2]}m{ch}")
            else:
                line.append(ch)
        line.append("\x1b[0m")
        out.append("".join(line))
    return "\n".join(out)


def format_image(image, spec: str = "auto") -> str:
    """Render for the current terminal; `spec` selects the protocol
    (reference: DisplayFormatter, display.zig:84+)."""
    spec = (spec or "auto").lower()
    if spec == DisplayFormat.AUTO:
        sup = detect_terminal_support()
        if sup.kitty:
            spec = DisplayFormat.KITTY
        elif sup.iterm2:
            spec = DisplayFormat.ITERM2
        elif sup.sixel:
            spec = DisplayFormat.SIXEL
        else:
            spec = DisplayFormat.SGR
    if spec == DisplayFormat.KITTY:
        return kitty_from_image(image)
    if spec == DisplayFormat.ITERM2:
        return iterm2_from_image(image)
    if spec == DisplayFormat.SIXEL:
        return sixel_from_image(image)
    if spec == DisplayFormat.SGR:
        return sgr_from_image(image)
    if spec == DisplayFormat.BRAILLE:
        return braille_from_image(image)
    raise ValueError(f"unknown display format {spec!r}")
