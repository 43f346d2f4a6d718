"""User-facing color classes, mirroring zignal's Python bindings.

The 13 classes (reference: bindings/python/src/color_registry.zig:8-20) are
generated from a small spec table. Rgb/Rgba/Gray/Ycbcr are u8-backed
(integer components 0-255); all other spaces are f64-backed. Validation
ranges and error messages mirror
bindings/python/src/color_registry.zig:40-170.

Copied from zignal_tpu/color/_classes.py (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import math

from . import _scalar as _s

__all__ = [
    "Gray", "Rgb", "Rgba", "Hsl", "Hsv", "Lab", "Lch", "Lms",
    "Oklab", "Oklch", "Xyb", "Xyz", "Ycbcr", "CLASS_BY_SPACE",
]


class _Color:
    """Base for all color classes."""

    __slots__ = ("_v",)
    _space: str = ""
    _fields: tuple = ()
    _int_backed: bool = False
    _ranges: tuple = ()
    _err: str = ""

    def __init__(self, *args, **kwargs):
        n = len(self._fields)
        vals = list(args)
        if len(vals) > n:
            raise TypeError(
                f"{type(self).__name__}() takes {n} arguments ({len(vals)} given)"
            )
        for name in self._fields[len(vals):]:
            if name not in kwargs:
                raise TypeError(f"{type(self).__name__}() missing argument {name!r}")
            vals.append(kwargs.pop(name))
        if kwargs:
            raise TypeError(
                f"{type(self).__name__}() got unexpected arguments {sorted(kwargs)}"
            )
        self._v = [self._check(i, v) for i, v in enumerate(vals)]

    @classmethod
    def _new_unchecked(cls, vals):
        obj = cls.__new__(cls)
        obj._v = list(vals)
        return obj

    def _check(self, i, value):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(
                f"{type(self).__name__}.{self._fields[i]} must be a number"
            )
        if self._int_backed:
            if isinstance(value, float):
                if not value.is_integer():
                    raise TypeError(
                        f"{type(self).__name__}.{self._fields[i]} must be an integer"
                    )
                value = int(value)
        else:
            value = float(value)
        lo, hi = self._ranges[i]
        if not (lo <= value <= hi):
            raise ValueError(self._err)
        return value

    # -- field access is generated per class (see _make_property) --

    def _values(self):
        return tuple(self._v)

    def _as_float(self):
        """Component values in the float backing (reference as(f64))."""
        if not self._int_backed:
            return self._values()
        if self._space == "ycbcr":
            y, cb, cr = self._v
            return (y / 255.0, (cb - 128) / 255.0, (cr - 128) / 255.0)
        return tuple(v / 255.0 for v in self._v)

    def to(self, target):
        """Convert to another color class (hub-and-spoke routing,
        reference: src/color.zig:108-150 convertColor)."""
        if not (isinstance(target, type) and issubclass(target, _Color)):
            raise TypeError("to() expects a color class such as zignal.Rgb")
        if target is type(self):
            return target._new_unchecked(self._v)
        if target._int_backed:
            if self._int_backed:
                vals = _s.convert_u8(self._space, target._space, self._values())
            else:
                f = _s.convert_float(self._space, target._space, self._values())
                vals = _quantize_u8(target._space, f)
        else:
            f = _s.convert_float(self._space, target._space, self._as_float())
            vals = f
        return target._new_unchecked(list(vals))

    def __repr__(self):
        inner = ", ".join(
            f"{name}={v}" if self._int_backed else f"{name}={v:g}"
            for name, v in zip(self._fields, self._v)
        )
        return f"{type(self).__name__}({inner})"

    def __format__(self, spec):
        if spec in ("", "none"):
            return repr(self)
        # ANSI-colored output like the reference formatColor
        # (src/color.zig:153-190)
        rgb = self.to(Rgb)
        okl = rgb.to(Oklab)._v[0]
        fg = 255 if okl < 0.5 else 0
        inner = ", ".join(
            f".{name} = {v}" if self._int_backed else f".{name} = {v:.2f}"
            for name, v in zip(self._fields, self._v)
        )
        return (
            f"\x1b[1m\x1b[38;2;{fg};{fg};{fg}m"
            f"\x1b[48;2;{rgb._v[0]};{rgb._v[1]};{rgb._v[2]}m"
            f"{type(self).__name__}{{ {inner} }}\x1b[0m"
        )

    def __eq__(self, other):
        if isinstance(other, _Color):
            return (
                self._space == other._space
                and self._int_backed == other._int_backed
                and self._v == other._v
            )
        return NotImplemented

    def __hash__(self):
        return hash((self._space, tuple(self._v)))


def _quantize_u8(space, f):
    """Float components -> u8 components (reference as(u8) per type)."""
    if space == "ycbcr":
        y, cb, cr = f
        return (
            _s.f64_to_u8(y),
            _s.f64_to_u8(cb + 0.5),
            _s.f64_to_u8(cr + 0.5),
        )
    return tuple(_s.f64_to_u8(v) for v in f)


def _make_property(index, name):
    def fget(self):
        return self._v[index]

    def fset(self, value):
        self._v[index] = self._check(index, value)

    return property(fget, fset, doc=f"{name} component")


_U8 = (0, 255)

_SPECS = {
    # name: (space, fields, int_backed, ranges, error message)
    "Gray": ("gray", ("y",), True, (_U8,), "Gray values must be in range 0-255"),
    "Rgb": ("rgb", ("r", "g", "b"), True, (_U8,) * 3,
            "RGB values must be in range 0-255"),
    "Rgba": ("rgba", ("r", "g", "b", "a"), True, (_U8,) * 4,
             "RGB values must be in range 0-255"),
    "Hsl": ("hsl", ("h", "s", "l"), False,
            ((0.0, 360.0), (0.0, 100.0), (0.0, 100.0)),
            "HSL values must be in valid ranges (h: 0-360, s: 0-100, l: 0-100)"),
    "Hsv": ("hsv", ("h", "s", "v"), False,
            ((0.0, 360.0), (0.0, 100.0), (0.0, 100.0)),
            "HSV values must be in valid ranges (h: 0-360, s: 0-100, v: 0-100)"),
    "Lab": ("lab", ("l", "a", "b"), False,
            ((0.0, 100.0), (-128.0, 127.0), (-128.0, 127.0)),
            "Lab values must be in valid ranges (l: 0-100, a: -128-127, b: -128-127)"),
    "Lch": ("lch", ("l", "c", "h"), False,
            ((0.0, 100.0), (0.0, math.inf), (0.0, 360.0)),
            "Lch values must be in valid ranges (l: 0-100, c: >=0, h: 0-360)"),
    "Lms": ("lms", ("l", "m", "s"), False, ((0.0, 1000.0),) * 3,
            "Lms values must be non-negative cone responses"),
    "Oklab": ("oklab", ("l", "a", "b"), False,
              ((0.0, 1.0), (-0.5, 0.5), (-0.5, 0.5)),
              "Oklab values must be in valid ranges (l: 0-1, a: -0.5-0.5, b: -0.5-0.5)"),
    "Oklch": ("oklch", ("l", "c", "h"), False,
              ((0.0, 1.0), (0.0, 0.5), (0.0, 360.0)),
              "Oklch values must be in valid ranges (l: 0-1, c: 0-0.5, h: 0-360)"),
    "Xyb": ("xyb", ("x", "y", "b"), False, ((-1000.0, 1000.0),) * 3,
            "Xyb values must be in valid ranges"),
    "Xyz": ("xyz", ("x", "y", "z"), False, ((0.0, 150.0),) * 3,
            "XYZ values must be in range 0-150"),
    "Ycbcr": ("ycbcr", ("y", "cb", "cr"), True, (_U8,) * 3,
              "YCbCr values must be in range 0-255"),
}


def _build(name):
    space, fields, int_backed, ranges, err = _SPECS[name]
    ns = {
        "__slots__": (),
        "_space": space,
        "_fields": fields,
        "_int_backed": int_backed,
        "_ranges": ranges,
        "_err": err,
        "__doc__": f"{name} color ({space} space).",
    }
    for i, f in enumerate(fields):
        ns[f] = _make_property(i, f)
    return type(name, (_Color,), ns)


Gray = _build("Gray")
Rgb = _build("Rgb")
Rgba = _build("Rgba")
Hsl = _build("Hsl")
Hsv = _build("Hsv")
Lab = _build("Lab")
Lch = _build("Lch")
Lms = _build("Lms")
Oklab = _build("Oklab")
Oklch = _build("Oklch")
Xyb = _build("Xyb")
Xyz = _build("Xyz")
Ycbcr = _build("Ycbcr")

CLASS_BY_SPACE = {
    cls._space: cls
    for cls in (Gray, Rgb, Rgba, Hsl, Hsv, Lab, Lch, Lms, Oklab, Oklch, Xyb, Xyz, Ycbcr)
}


# ---------------------------------------------------------------------------
# Extra methods on the RGB family (reference: src/color.zig:298-345,414-470,561)
# ---------------------------------------------------------------------------


def _rgb_from_hex(cls, hex_code):
    if not isinstance(hex_code, int) or hex_code < 0 or hex_code > 0xFFFFFF:
        raise ValueError("hex code must be a 24-bit integer 0xRRGGBB")
    return cls((hex_code >> 16) & 0xFF, (hex_code >> 8) & 0xFF, hex_code & 0xFF)


def _rgba_from_hex(cls, hex_code):
    if not isinstance(hex_code, int) or hex_code < 0 or hex_code > 0xFFFFFFFF:
        raise ValueError("hex code must be a 32-bit integer 0xRRGGBBAA")
    return cls(
        (hex_code >> 24) & 0xFF,
        (hex_code >> 16) & 0xFF,
        (hex_code >> 8) & 0xFF,
        hex_code & 0xFF,
    )


def _luma(self):
    r, g, b = self._v[0] / 255.0, self._v[1] / 255.0, self._v[2] / 255.0
    return _s.LUMA_R * r + _s.LUMA_G * g + _s.LUMA_B * b


def _blend_method(self, overlay, mode=None):
    from ..blending import Blending, blend_colors

    if mode is None:
        mode = Blending.NORMAL
    overlay = _coerce_rgba(overlay)
    base = self.to(Rgba)
    out = blend_colors(base, overlay, mode)
    if isinstance(self, Rgba):
        return out
    return Rgb._new_unchecked(out._v[:3])


def _coerce_rgba(value):
    if isinstance(value, Rgba):
        return value
    if isinstance(value, _Color):
        return value.to(Rgba)
    if isinstance(value, (tuple, list)):
        if len(value) == 3:
            return Rgba(value[0], value[1], value[2], 255)
        if len(value) == 4:
            return Rgba(*value)
    raise TypeError("expected a color or a 3/4-tuple")


Rgb.from_hex = classmethod(_rgb_from_hex)
Rgb.hex = lambda self: (self._v[0] << 16) | (self._v[1] << 8) | self._v[2]
Rgb.with_alpha = lambda self, alpha: Rgba(self._v[0], self._v[1], self._v[2], alpha)
Rgb.invert = lambda self: Rgb._new_unchecked(
    [255 - self._v[0], 255 - self._v[1], 255 - self._v[2]]
)
Rgb.luma = _luma
Rgb.blend = _blend_method

Rgba.from_hex = classmethod(_rgba_from_hex)
Rgba.hex = lambda self: (
    (self._v[0] << 24) | (self._v[1] << 16) | (self._v[2] << 8) | self._v[3]
)
Rgba.invert = lambda self: Rgba._new_unchecked(
    [255 - self._v[0], 255 - self._v[1], 255 - self._v[2], self._v[3]]
)
Rgba.luma = _luma
Rgba.blend = _blend_method

Gray.invert = lambda self: Gray._new_unchecked([255 - self._v[0]])

# Named constants (reference: src/color.zig:292-296,414-420)
for _name, _hex in (("black", 0x000000), ("white", 0xFFFFFF), ("red", 0xFF0000),
                    ("green", 0x00FF00), ("blue", 0x0000FF)):
    setattr(Rgb, _name, Rgb.from_hex(_hex))
for _name, _hex in (("transparent", 0x00000000), ("black", 0x000000FF),
                    ("white", 0xFFFFFFFF)):
    setattr(Rgba, _name, Rgba.from_hex(_hex))
del _name, _hex
