"""Scalar color-space conversion math (pure Python, f64).

Reimplements the hub-and-spoke conversion graph of the reference
(reference: src/color.zig:192-209 for the graph, 987-1533 for per-edge
functions). Two hubs: sRGB (display) and CIE XYZ (scientific); cross
conversions route through the bridge (e.g. Hsl -> Rgb -> Xyz -> Lab).

These scalar functions are the ground-truth oracle for the batched
ops in ``_array.py`` and back the user-facing color classes.

All functions here operate on plain tuples of Python floats (f64), which
matches the reference's f64 component type used by the Python bindings
(reference: bindings/python/src/color_registry.zig:8-20).

Copied from zignal_tpu/color/_scalar.py (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# Constants (reference: src/color.zig:63-89)
# ---------------------------------------------------------------------------

LUMA_R = 0.2126  # Rec.709
LUMA_G = 0.7152
LUMA_B = 0.0722

XYB_BIAS = 0.00379307325527544933
XYB_CBRT_BIAS_ENCODE = 0.15595420054924863
XYB_CBRT_BIAS_DECODE = 0.15594113236791331

D65_X = 95.047
D65_Y = 100.000
D65_Z = 108.883

LAB_EPSILON = 0.008856
LAB_KAPPA_DIV_116 = 7.787
LAB_DELTA = 16.0 / 116.0

SRGB_LINEAR_THRESHOLD = 0.0031308
SRGB_GAMMA_THRESHOLD = 0.04045
SRGB_GAMMA_OFFSET = 0.055
SRGB_GAMMA_SCALE = 1.055
SRGB_LINEAR_SLOPE = 12.92
SRGB_GAMMA_EXPONENT = 2.4

# Fixed-point BT.601 coefficients (reference: src/color.zig:987-1007)
_YCBCR_FWD = (
    (19595, 38470, 7471),
    (-11059, -21710, 32768),
    (32768, -27439, -5329),
)
# BT.709 luma in 16-bit fixed point (reference: src/color.zig:1031-1043)
_GRAY_FWD = (
    round(LUMA_R * 65536),
    round(LUMA_G * 65536),
    round(LUMA_B * 65536),
)


def clamp(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def round_away(x: float) -> float:
    """Round half away from zero (Zig's @round)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def f64_to_u8(v: float) -> int:
    """Float [0,1] component -> u8 (reference: color.zig as() methods)."""
    return int(round_away(255.0 * clamp(v, 0.0, 1.0)))


def lerp(a, b, t):
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# Float per-edge conversions. Component layouts (float backing):
#   gray:(y) rgb:(r,g,b) rgba:(r,g,b,a) in [0,1]
#   hsv:(h 0-360, s 0-100, v 0-100)  hsl:(h, s, l)
#   xyz:(x,y,z ~0-100)  lab:(l 0-100, a, b)  lch:(l,c,h)
#   lms:(l,m,s)  oklab:(l,a,b)  oklch:(l,c,h)  xyb:(x,y,b)
#   ycbcr:(y in [0,1], cb, cr in [-0.5, 0.5])
# ---------------------------------------------------------------------------


def gray_to_rgb(t):
    (y,) = t
    return (y, y, y)


def rgb_to_gray(t):
    r, g, b = t
    return (clamp(LUMA_R * r + LUMA_G * g + LUMA_B * b, 0.0, 1.0),)


def rgb_to_rgba(t):
    r, g, b = t
    return (r, g, b, 1.0)


def rgba_to_rgb(t):
    return t[:3]


def rgb_to_hsv(t):
    r, g, b = t
    mx = max(r, g, b)
    mn = min(r, g, b)
    delta = mx - mn
    if delta == 0:
        h = 0.0
    elif mx == r:
        h = (g - b) / delta * 60.0
    elif mx == g:
        h = 120.0 + (b - r) / delta * 60.0
    else:
        h = 240.0 + (r - g) / delta * 60.0
    return (h % 360.0, 0.0 if mx == 0 else (delta / mx) * 100.0, mx * 100.0)


def hsv_to_rgb(t):
    h, s, v = t
    hue = clamp(h / 360.0, 0.0, 1.0)
    sat = clamp(s / 100.0, 0.0, 1.0)
    val = clamp(v / 100.0, 0.0, 1.0)
    if sat == 0.0:
        return (val, val, val)
    sector = hue * 6.0
    index = int(sector)
    fractional = sector - index
    p = val * (1.0 - sat)
    q = val * (1.0 - sat * fractional)
    tt = val * (1.0 - sat * (1.0 - fractional))
    table = (
        (val, tt, p),
        (q, val, p),
        (p, val, tt),
        (p, q, val),
        (tt, p, val),
        (val, p, q),
    )
    return table[index % 6]


def rgb_to_hsl(t):
    r, g, b = t
    mx = max(r, g, b)
    mn = min(r, g, b)
    delta = mx - mn
    if delta == 0:
        hue = 0.0
    elif mx == r:
        hue = (g - b) / delta
    elif mx == g:
        hue = 2.0 + (b - r) / delta
    else:
        hue = 4.0 + (r - g) / delta
    l = (mx + mn) / 2.0
    if delta == 0:
        s = 0.0
    elif l < 0.5:
        s = delta / (2.0 * l)
    else:
        s = delta / (2.0 - 2.0 * l)
    return ((hue * 60.0) % 360.0, clamp(s, 0.0, 1.0) * 100.0, clamp(l, 0.0, 1.0) * 100.0)


def hsl_to_rgb(t):
    h, s, l = t
    h = h % 360.0
    s = clamp(s / 100.0, 0.0, 1.0)
    l = clamp(l / 100.0, 0.0, 1.0)
    hue_sector = h / 60.0
    sector = int(hue_sector)
    fractional = hue_sector - sector
    factors = (
        (1.0, fractional, 0.0),
        (1.0 - fractional, 1.0, 0.0),
        (0.0, 1.0, fractional),
        (0.0, 1.0 - fractional, 1.0),
        (fractional, 0.0, 1.0),
        (1.0, 0.0, 1.0 - fractional),
    )
    fr, fg, fb = factors[sector % 6]
    r = lerp(1.0, 2.0 * fr, s)
    g = lerp(1.0, 2.0 * fg, s)
    b = lerp(1.0, 2.0 * fb, s)
    if l < 0.5:
        return (r * l, g * l, b * l)
    return (lerp(r, 2.0, l) - 1.0, lerp(g, 2.0, l) - 1.0, lerp(b, 2.0, l) - 1.0)


def hsv_to_hsl(t):
    h, s, v = t
    s_v = s / 100.0
    v = v / 100.0
    l = v * (1.0 - s_v / 2.0)
    s_l = 0.0 if (l == 0 or l == 1) else (v - l) / min(l, 1.0 - l)
    return (h, s_l * 100.0, l * 100.0)


def hsl_to_hsv(t):
    h, s, l = t
    s_l = s / 100.0
    l = l / 100.0
    v = l + s_l * min(l, 1.0 - l)
    s_v = 0.0 if v == 0 else 2.0 * (1.0 - l / v)
    return (h, s_v * 100.0, v * 100.0)


def rgb_to_ycbcr(t):
    r, g, b = t
    y = clamp(0.299 * r + 0.587 * g + 0.114 * b, 0.0, 1.0)
    return (y, clamp((b - y) / 1.772, -0.5, 0.5), clamp((r - y) / 1.402, -0.5, 0.5))


def ycbcr_to_rgb(t):
    y, cb, cr = t
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return (clamp(r, 0.0, 1.0), clamp(g, 0.0, 1.0), clamp(b, 0.0, 1.0))


def linear_to_gamma(c):
    if c > SRGB_LINEAR_THRESHOLD:
        return SRGB_GAMMA_SCALE * (c ** (1.0 / SRGB_GAMMA_EXPONENT)) - SRGB_GAMMA_OFFSET
    return c * SRGB_LINEAR_SLOPE


def gamma_to_linear(c):
    if c > SRGB_GAMMA_THRESHOLD:
        return ((c + SRGB_GAMMA_OFFSET) / SRGB_GAMMA_SCALE) ** SRGB_GAMMA_EXPONENT
    return c / SRGB_LINEAR_SLOPE


def rgb_to_xyz(t):
    r = gamma_to_linear(t[0])
    g = gamma_to_linear(t[1])
    b = gamma_to_linear(t[2])
    return (
        (r * 0.4124 + g * 0.3576 + b * 0.1805) * 100.0,
        (r * 0.2126 + g * 0.7152 + b * 0.0722) * 100.0,
        (r * 0.0193 + g * 0.1192 + b * 0.9505) * 100.0,
    )


def xyz_to_rgb(t):
    x, y, z = t
    r = (x * 3.2406 + y * -1.5372 + z * -0.4986) / 100.0
    g = (x * -0.9689 + y * 1.8758 + z * 0.0415) / 100.0
    b = (x * 0.0557 + y * -0.2040 + z * 1.0570) / 100.0
    return (
        clamp(linear_to_gamma(r), 0.0, 1.0),
        clamp(linear_to_gamma(g), 0.0, 1.0),
        clamp(linear_to_gamma(b), 0.0, 1.0),
    )


def _lab_forward(t):
    return t ** (1.0 / 3.0) if t > LAB_EPSILON else LAB_KAPPA_DIV_116 * t + LAB_DELTA


def xyz_to_lab(t):
    fx = _lab_forward(t[0] / D65_X)
    fy = _lab_forward(t[1] / D65_Y)
    fz = _lab_forward(t[2] / D65_Z)
    return (max(0.0, 116.0 * fy - 16.0), 500.0 * (fx - fy), 200.0 * (fy - fz))


def lab_to_xyz(t):
    l, a, b = t
    fy = (l + 16.0) / 116.0
    fx = (a / 500.0) + fy
    fz = fy - (b / 200.0)
    y3, x3, z3 = fy**3, fx**3, fz**3
    y = y3 if y3 > LAB_EPSILON else (fy - LAB_DELTA) / LAB_KAPPA_DIV_116
    x = x3 if x3 > LAB_EPSILON else (fx - LAB_DELTA) / LAB_KAPPA_DIV_116
    z = z3 if z3 > LAB_EPSILON else (fz - LAB_DELTA) / LAB_KAPPA_DIV_116
    return (x * D65_X, y * D65_Y, z * D65_Z)


def _cart_to_cyl(a, b):
    return (math.sqrt(a * a + b * b), math.degrees(math.atan2(b, a)) % 360.0)


def _cyl_to_cart(c, h):
    h_rad = math.radians(h)
    return (c * math.cos(h_rad), c * math.sin(h_rad))


def lab_to_lch(t):
    c, h = _cart_to_cyl(t[1], t[2])
    return (t[0], c, h)


def lch_to_lab(t):
    a, b = _cyl_to_cart(t[1], t[2])
    return (t[0], a, b)


def xyz_to_lms(t):
    x, y, z = t
    return (
        (0.8951 * x + 0.2664 * y - 0.1614 * z) / 100.0,
        (-0.7502 * x + 1.7135 * y + 0.0367 * z) / 100.0,
        (0.0389 * x - 0.0685 * y + 1.0296 * z) / 100.0,
    )


def lms_to_xyz(t):
    l, m, s = t
    return (
        100.0 * (0.9869929 * l - 0.1470543 * m + 0.1599627 * s),
        100.0 * (0.4323053 * l + 0.5183603 * m + 0.0492912 * s),
        100.0 * (-0.0085287 * l + 0.0400428 * m + 0.9684867 * s),
    )


def xyz_to_oklab(t):
    x, y, z = t[0] / 100.0, t[1] / 100.0, t[2] / 100.0
    l = 0.8189330101 * x + 0.3618667424 * y - 0.1288597137 * z
    m = 0.0329845436 * x + 0.9293118715 * y + 0.0361456387 * z
    s = 0.0482003018 * x + 0.2643662691 * y + 0.6338517070 * z
    ld, md, sd = math.cbrt(l), math.cbrt(m), math.cbrt(s)
    return (
        0.2104542553 * ld + 0.7936177850 * md - 0.0040720468 * sd,
        1.9779984951 * ld - 2.4285922050 * md + 0.4505937099 * sd,
        0.0259040371 * ld + 0.7827717662 * md - 0.8086757660 * sd,
    )


def oklab_to_xyz(t):
    l, a, b = t
    ld = l + 0.3963377774 * a + 0.2158037573 * b
    md = l - 0.1055613458 * a - 0.0638541728 * b
    sd = l - 0.0894841775 * a - 1.2914855480 * b
    ll, mm, ss = ld**3, md**3, sd**3
    return (
        100.0 * (1.2270138511 * ll - 0.5577999807 * mm + 0.2812561490 * ss),
        100.0 * (-0.0405801784 * ll + 1.1122568696 * mm - 0.0716766787 * ss),
        100.0 * (-0.0763812845 * ll - 0.4214819784 * mm + 1.5861632204 * ss),
    )


def oklab_to_oklch(t):
    c, h = _cart_to_cyl(t[1], t[2])
    return (t[0], c, h)


def oklch_to_oklab(t):
    a, b = _cyl_to_cart(t[1], t[2])
    return (t[0], a, b)


def _xyb_from_linear_rgb(r, g, b):
    l = max(0.0, 0.30 * r + 0.622 * g + 0.078 * b + XYB_BIAS)
    m = max(0.0, 0.23 * r + 0.692 * g + 0.078 * b + XYB_BIAS)
    s = max(
        0.0,
        0.24342268924547819 * r
        + 0.20476744424496821 * g
        + 0.5518098665095536 * b
        + XYB_BIAS,
    )
    ld = math.cbrt(l) - XYB_CBRT_BIAS_ENCODE
    md = math.cbrt(m) - XYB_CBRT_BIAS_ENCODE
    sd = math.cbrt(s) - XYB_CBRT_BIAS_ENCODE
    return (0.5 * (ld - md), 0.5 * (ld + md), sd)


def _xyb_to_linear_rgb(t):
    x, y, b = t
    lc = (y + x) + XYB_CBRT_BIAS_DECODE
    mc = (y - x) + XYB_CBRT_BIAS_DECODE
    sc = b + XYB_CBRT_BIAS_DECODE
    l = lc**3 - XYB_BIAS
    m = mc**3 - XYB_BIAS
    s = sc**3 - XYB_BIAS
    return (
        11.031566901960783 * l - 9.866943921568629 * m - 0.16462299647058826 * s,
        -3.254147380392157 * l + 4.418770392156863 * m - 0.16462299647058826 * s,
        -3.6588512862745097 * l + 2.7129230470588235 * m + 1.9459282392156863 * s,
    )


def xyz_to_xyb(t):
    x, y, z = t
    r = (x * 3.2406 + y * -1.5372 + z * -0.4986) / 100.0
    g = (x * -0.9689 + y * 1.8758 + z * 0.0415) / 100.0
    b = (x * 0.0557 + y * -0.2040 + z * 1.0570) / 100.0
    return _xyb_from_linear_rgb(r, g, b)


def xyb_to_xyz(t):
    r, g, b = _xyb_to_linear_rgb(t)
    return (
        (r * 0.4124 + g * 0.3576 + b * 0.1805) * 100.0,
        (r * 0.2126 + g * 0.7152 + b * 0.0722) * 100.0,
        (r * 0.0193 + g * 0.1192 + b * 0.9505) * 100.0,
    )


def rgb_to_xyb(t):
    return _xyb_from_linear_rgb(
        gamma_to_linear(t[0]), gamma_to_linear(t[1]), gamma_to_linear(t[2])
    )


def xyb_to_rgb(t):
    r, g, b = _xyb_to_linear_rgb(t)
    return (
        clamp(linear_to_gamma(r), 0.0, 1.0),
        clamp(linear_to_gamma(g), 0.0, 1.0),
        clamp(linear_to_gamma(b), 0.0, 1.0),
    )


# ---------------------------------------------------------------------------
# Integer (u8) fixed-point edges — bit-exact with the reference
# (reference: src/color.zig:987-1007, 1031-1043, 1057-1078).
# ---------------------------------------------------------------------------


def rgb_to_gray_u8(t):
    r, g, b = t
    yr, yg, yb = _GRAY_FWD
    return (int(clamp((yr * r + yg * g + yb * b + 32768) >> 16, 0, 255)),)


def gray_to_rgb_u8(t):
    (y,) = t
    return (y, y, y)


def rgb_to_ycbcr_u8(t):
    r, g, b = t
    (yr, yg, yb), (cbr, cbg, cbb), (crr, crg, crb) = _YCBCR_FWD
    return (
        int(clamp((yr * r + yg * g + yb * b + 32768) >> 16, 0, 255)),
        int(clamp(((cbr * r + cbg * g + cbb * b + 32768) >> 16) + 128, 0, 255)),
        int(clamp(((crr * r + crg * g + crb * b + 32768) >> 16) + 128, 0, 255)),
    )


def ycbcr_to_rgb_u8(t):
    y, cb, cr = t[0], t[1] - 128, t[2] - 128
    return (
        int(clamp((65536 * y + 91881 * cr + 32768) >> 16, 0, 255)),
        int(clamp((65536 * y - 22554 * cb - 46802 * cr + 32768) >> 16, 0, 255)),
        int(clamp((65536 * y + 116130 * cb + 32768) >> 16, 0, 255)),
    )


def rgb_to_rgba_u8(t):
    return (t[0], t[1], t[2], 255)


def rgba_to_rgb_u8(t):
    return t[:3]


# ---------------------------------------------------------------------------
# Routing (reference: per-type to() dispatch, src/color.zig:355-612,925-950)
# ---------------------------------------------------------------------------

SPACES = (
    "gray", "hsl", "hsv", "lab", "lch", "lms", "oklab",
    "oklch", "rgb", "rgba", "xyb", "xyz", "ycbcr",
)

_DIRECT = {
    ("gray", "rgb"): gray_to_rgb,
    ("rgb", "gray"): rgb_to_gray,
    ("rgb", "hsl"): rgb_to_hsl,
    ("rgb", "hsv"): rgb_to_hsv,
    ("rgb", "rgba"): rgb_to_rgba,
    ("rgb", "xyb"): rgb_to_xyb,
    ("rgb", "xyz"): rgb_to_xyz,
    ("rgb", "ycbcr"): rgb_to_ycbcr,
    ("rgba", "rgb"): rgba_to_rgb,
    ("hsv", "hsl"): hsv_to_hsl,
    ("hsv", "rgb"): hsv_to_rgb,
    ("hsl", "hsv"): hsl_to_hsv,
    ("hsl", "rgb"): hsl_to_rgb,
    ("xyz", "lab"): xyz_to_lab,
    ("xyz", "lms"): xyz_to_lms,
    ("xyz", "oklab"): xyz_to_oklab,
    ("xyz", "rgb"): xyz_to_rgb,
    ("xyz", "xyb"): xyz_to_xyb,
    ("lab", "lch"): lab_to_lch,
    ("lab", "xyz"): lab_to_xyz,
    ("lch", "lab"): lch_to_lab,
    ("lms", "xyz"): lms_to_xyz,
    ("oklab", "oklch"): oklab_to_oklch,
    ("oklab", "xyz"): oklab_to_xyz,
    ("oklch", "oklab"): oklch_to_oklab,
    ("xyb", "rgb"): xyb_to_rgb,
    ("xyb", "xyz"): xyb_to_xyz,
    ("ycbcr", "rgb"): ycbcr_to_rgb,
}

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

_U8_DIRECT = {
    ("gray", "rgb"): gray_to_rgb_u8,
    ("rgb", "gray"): rgb_to_gray_u8,
    ("rgb", "ycbcr"): rgb_to_ycbcr_u8,
    ("rgb", "rgba"): rgb_to_rgba_u8,
    ("rgba", "rgb"): rgba_to_rgb_u8,
    ("ycbcr", "rgb"): ycbcr_to_rgb_u8,
}


def conversion_path(src: str, dst: str) -> list:
    """The ordered list of (src, hop) edges from src to dst."""
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


def convert_float(src: str, dst: str, values):
    """Convert a float tuple between color spaces along the routed path."""
    for edge in conversion_path(src, dst):
        values = _DIRECT[edge](values)
    return values


def convert_u8(src: str, dst: str, values):
    """Convert a u8 int tuple between the integer-backed spaces
    (gray/rgb/rgba/ycbcr) using the exact fixed-point paths."""
    for edge in conversion_path(src, dst):
        values = _U8_DIRECT[edge](values)
    return values
