"""iTerm2 inline image protocol (reference: src/terminal/iterm2.zig):
OSC 1337 File=inline=1 with base64 PNG payload.

Copied from zignal_tpu/terminal/iterm2.py.
"""

from __future__ import annotations

from .kitty import _scaled_png_base64


def iterm2_from_image(image, width=None, height=None, interpolation=None) -> str:
    b64, png_len = _scaled_png_base64(image, width, height, interpolation)
    return f"\x1b]1337;File=inline=1;size={png_len}:{b64}\x07"
