"""Font format detection (reference: src/font/format.zig).

Copied from zignal_tpu/font/format.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import enum

__all__ = ["FontFormat", "detect_from_bytes", "detect_from_path"]


class FontFormat(enum.Enum):
    BDF = "bdf"
    PCF = "pcf"


def detect_from_bytes(data: bytes):
    """-> FontFormat or None (reference: format.zig:19 detectFromBytes)."""
    if data.startswith(b"STARTFONT"):
        return FontFormat.BDF
    if data[:4] == b"\x01fcp":
        return FontFormat.PCF
    return None


def detect_from_path(path: str):
    """-> FontFormat or None; .pcf.gz/.bdf.gz by extension, else by magic
    (reference: format.zig:36 detectFromPath)."""
    if path.endswith(".pcf.gz"):
        return FontFormat.PCF
    if path.endswith(".bdf.gz"):
        return FontFormat.BDF
    with open(path, "rb") as f:
        return detect_from_bytes(f.read(16))
