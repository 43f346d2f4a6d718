"""Bitmap fonts: built-in 8x8 font, BDF/PCF load + save, unicode-range
load filters, format detection (reference: src/font/).

Copied from zignal_tpu/font/__init__.py (the port imports nothing of the JAX
package).
"""

from .bitmap_font import BitmapFont
from .format import FontFormat, detect_from_bytes, detect_from_path
from .unicode import Range, ranges

__all__ = ["BitmapFont", "FontFormat", "detect_from_bytes",
           "detect_from_path", "Range", "ranges"]
