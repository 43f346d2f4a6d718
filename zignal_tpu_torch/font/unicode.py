"""Unicode ranges for selective font loading (reference: src/font/unicode.zig).

The constants are standard Unicode block boundaries. A load "filter" is
``None`` (load everything), a single ``Range``/``(start, end)`` tuple, or
a list of them.

Copied from zignal_tpu/font/unicode.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Range", "ranges", "normalize_filter", "codepoint_in"]


@dataclasses.dataclass(frozen=True)
class Range:
    start: int
    end: int

    def __contains__(self, cp: int) -> bool:
        return self.start <= cp <= self.end


class ranges:
    """Common Unicode blocks (reference: unicode.zig `ranges`)."""

    ascii = Range(0x0000, 0x007F)
    latin1_supplement = Range(0x0080, 0x00FF)
    latin1 = Range(0x0000, 0x00FF)
    greek = Range(0x0370, 0x03FF)
    cyrillic = Range(0x0400, 0x04FF)
    arabic = Range(0x0600, 0x06FF)
    hebrew = Range(0x0590, 0x05FF)
    hiragana = Range(0x3040, 0x309F)
    katakana = Range(0x30A0, 0x30FF)
    cjk_unified = Range(0x4E00, 0x9FFF)
    hangul = Range(0xAC00, 0xD7AF)
    emoji = Range(0x1F300, 0x1F9FF)
    math = Range(0x2200, 0x22FF)
    box_drawing = Range(0x2500, 0x257F)
    block_elements = Range(0x2580, 0x259F)
    cjk_punctuation = Range(0x3000, 0x303F)
    western_european = (latin1, Range(0x0100, 0x017F))
    east_asian = (hiragana, katakana, cjk_unified, hangul)
    chinese = (cjk_unified, cjk_punctuation)
    japanese = (hiragana, katakana, cjk_unified, cjk_punctuation)
    korean = (hangul, cjk_punctuation)


def normalize_filter(filt):
    """-> None (all) or tuple[Range, ...]."""
    if filt is None:
        return None
    if isinstance(filt, Range):
        return (filt,)
    if isinstance(filt, (tuple, list)):
        if len(filt) == 2 and all(isinstance(v, int) for v in filt):
            return (Range(filt[0], filt[1]),)
        out = []
        for r in filt:
            out.extend(normalize_filter(r))
        return tuple(out)
    raise TypeError(f"invalid unicode filter: {filt!r}")


def codepoint_in(cp: int, filt) -> bool:
    """filt must already be normalized (None or tuple of Range)."""
    return filt is None or any(cp in r for r in filt)
