"""Host-side codecs: PNG, JPEG, BMP and GIF with a uniform surface
(reference: src/codecs/ and src/image/format.zig magic-byte sniffing).

Copied from zignal_tpu/codecs/__init__.py.
"""

from __future__ import annotations

import enum
import os

import numpy as np

from . import bmp, gif, jpeg, png

__all__ = ["ImageFormat", "detect_format", "detect_from_path",
           "load_array", "load_array_from_bytes", "save_array", "png",
           "jpeg", "bmp", "gif"]


class ImageFormat(enum.Enum):
    PNG = "png"
    JPEG = "jpeg"
    BMP = "bmp"
    GIF = "gif"


_EXTENSIONS = {
    ".png": ImageFormat.PNG,
    ".jpg": ImageFormat.JPEG,
    ".jpeg": ImageFormat.JPEG,
    ".jfif": ImageFormat.JPEG,
    ".bmp": ImageFormat.BMP,
    ".dib": ImageFormat.BMP,
    ".gif": ImageFormat.GIF,
}


def detect_format(data: bytes):
    """Magic-byte sniffing (reference: src/image/format.zig:14-52)."""
    if data.startswith(png.SIGNATURE):
        return ImageFormat.PNG
    if data.startswith(b"\xff\xd8"):
        return ImageFormat.JPEG
    if data.startswith(b"BM"):
        return ImageFormat.BMP
    if data.startswith(b"GIF87a") or data.startswith(b"GIF89a"):
        return ImageFormat.GIF
    return None


def detect_from_path(path: str):
    return _EXTENSIONS.get(os.path.splitext(path)[1].lower())


def load_array(path: str):
    """Load any supported format -> uint8 [H,W,C] array (C in 1/3/4)."""
    with open(path, "rb") as f:
        data = f.read()
    return load_array_from_bytes(data)


def load_array_from_bytes(data: bytes):
    fmt = detect_format(data)
    if fmt is ImageFormat.PNG:
        return png.load_from_bytes(data)
    if fmt is ImageFormat.JPEG:
        return jpeg.load_from_bytes(data)
    if fmt is ImageFormat.BMP:
        return bmp.load_from_bytes(data)
    if fmt is ImageFormat.GIF:
        return gif.load_from_bytes(data)
    raise ValueError("unsupported or unrecognized image format")


def save_array(path: str, arr, **options) -> None:
    """Save a uint8 [H,W,C] array; format chosen by file extension."""
    fmt = detect_from_path(path)
    if fmt is None:
        raise ValueError(f"cannot infer image format from path {path!r}")
    if fmt is ImageFormat.PNG:
        png.save(path, arr, **options)
    elif fmt is ImageFormat.JPEG:
        if arr.shape[2] == 4:
            arr = np.ascontiguousarray(arr[..., :3])
        jpeg.save(path, arr, **options)
    elif fmt is ImageFormat.BMP:
        bmp.save(path, arr, **options)
    else:
        gif.save(path, arr, **options)
