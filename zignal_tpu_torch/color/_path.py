"""The colour-conversion graph (reference: the per-type ``to()`` dispatch of
src/color.zig:355-612,925-950), copied from the routing tables of
zignal_tpu/color/_scalar.py:475-548. Only the graph: two hubs, sRGB and
CIE XYZ, and a fallback hop from every space toward them; the per-edge
math lives in ``_array.py``."""

from __future__ import annotations

__all__ = ["SPACES", "conversion_path"]

SPACES = (
    "gray", "hsl", "hsv", "lab", "lch", "lms", "oklab",
    "oklch", "rgb", "rgba", "xyb", "xyz", "ycbcr",
)

# the keys of _scalar._DIRECT: the edges that have a conversion of their own
_DIRECT = frozenset({
    ("gray", "rgb"), ("rgb", "gray"), ("rgb", "hsl"), ("rgb", "hsv"),
    ("rgb", "rgba"), ("rgb", "xyb"), ("rgb", "xyz"), ("rgb", "ycbcr"),
    ("rgba", "rgb"), ("hsv", "hsl"), ("hsv", "rgb"), ("hsl", "hsv"),
    ("hsl", "rgb"), ("xyz", "lab"), ("xyz", "lms"), ("xyz", "oklab"),
    ("xyz", "rgb"), ("xyz", "xyb"), ("lab", "lch"), ("lab", "xyz"),
    ("lch", "lab"), ("lms", "xyz"), ("oklab", "oklch"), ("oklab", "xyz"),
    ("oklch", "oklab"), ("xyb", "rgb"), ("xyb", "xyz"), ("ycbcr", "rgb"),
})

_FALLBACK = {
    "gray": "rgb",
    "rgb": "xyz",
    "rgba": "rgb",
    "hsv": "rgb",
    "hsl": "rgb",
    "xyz": "rgb",
    "lab": "xyz",
    "lch": "lab",
    "lms": "xyz",
    "oklab": "xyz",
    "oklch": "oklab",
    "xyb": "xyz",
    "ycbcr": "rgb",
}

# xyz routes to the cylindrical spaces through their cartesian parents
_SPECIAL = {("xyz", "lch"): "lab", ("xyz", "oklch"): "oklab"}


def conversion_path(src: str, dst: str) -> list:
    """The ordered list of (src, hop) edges from src to dst."""
    for s in (src, dst):
        if s not in _FALLBACK:
            raise ValueError(f"unknown colour space {s!r}")
    path = []
    cur = src
    while cur != dst:
        if (cur, dst) in _DIRECT:
            hop = dst
        elif (cur, dst) in _SPECIAL:
            hop = _SPECIAL[(cur, dst)]
        else:
            hop = _FALLBACK[cur]
        path.append((cur, hop))
        cur = hop
    return path
