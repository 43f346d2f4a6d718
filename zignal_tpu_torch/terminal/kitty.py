"""Kitty graphics protocol encoder (reference: src/terminal/kitty.zig,
payload.zig): scale -> PNG -> base64 -> chunked APC escape sequences.

Copied from zignal_tpu/terminal/kitty.py. The scaling is the port's
``Image.resize`` on the image's device: a bilinear u8 resize on the card
is one launch of the fused resize kernel (K1).
"""

from __future__ import annotations

import base64

import numpy as np

_MAX_CHUNK = 4096


def _scaled_png_base64(image, width=None, height=None, interpolation=None):
    """(base64 str, png byte count) (reference: payload.zig:22)."""
    from ..codecs import png
    from ..enums import Interpolation

    img = image
    if width is not None or height is not None:
        w = width or image.cols
        h = height or round(image.rows * (w / image.cols))
        if width is None:
            h = height
            w = round(image.cols * (h / image.rows))
        img = image.resize((int(h), int(w)),
                           interpolation or Interpolation.BILINEAR)
    data = png.encode(np.ascontiguousarray(img._host()))
    return base64.b64encode(data).decode("ascii"), len(data)


def kitty_from_image(image, width=None, height=None, interpolation=None,
                     quiet=1, image_id=None, placement_id=None,
                     delete_after=False, enable_chunking=False) -> str:
    """APC G escape sequence transmitting the image as PNG (f=100)."""
    b64, _ = _scaled_png_base64(image, width, height, interpolation)
    ctrl = f"a=T,f=100,q={quiet}"
    if image_id is not None:
        ctrl += f",i={image_id}"
    if placement_id is not None:
        ctrl += f",p={placement_id}"
    if delete_after:
        ctrl += ",d=1"
    if not enable_chunking or len(b64) <= _MAX_CHUNK:
        return f"\x1b_G{ctrl};{b64}\x1b\\"
    out = []
    pos = 0
    first = True
    while pos < len(b64):
        chunk = b64[pos:pos + _MAX_CHUNK]
        pos += _MAX_CHUNK
        more = 1 if pos < len(b64) else 0
        if first:
            out.append(f"\x1b_G{ctrl},m={more};{chunk}\x1b\\")
            first = False
        else:
            out.append(f"\x1b_Gm={more};{chunk}\x1b\\")
    return "".join(out)
