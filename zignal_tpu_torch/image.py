"""The Image container: one 2-D u8 image ``[H, W, C]`` with a dtype tag
(Gray, Rgb or Rgba), the counterpart of zignal_tpu/image.py.

Design (as the JAX package's): the pixel data lives in one of two homes.

- **host** (``_np``): a numpy array that backs the mutation API:
  ``to_numpy`` zero-copy views, pixel proxies, slice assignment, views
  sharing memory with their parent. While a host array exists it is
  authoritative (users may write through views), so every device op
  uploads it anew; no device copy is ever cached beside it.
- **device** (``_dev``): a torch tensor that a device op produced, on the
  image's ``device``. The host array is made from it only when the
  mutation or introspection API needs it.

Every constructor takes an explicit ``device=``: the device ops run there
(on the card, u8 bilinear ``resize`` and ``letterbox`` are K1 and
``gaussian_blur`` / ``convolve_separable`` K4), through the same batched
ops as ``ImageBatch`` on a batch of one (``insert`` too, written back into
the host array). ``resize`` always runs on the device: the JAX package's
host placement is not ported. The host ops (``fill``, ``set_border``,
``invert``, the flips, ``blend``, the host ``convert``, ``psnr``,
``mean_pixel_error``, ``diff``) are the JAX package's numpy code, and so
are the terminal renderings but for kitty's and iTerm2's scaling, which is
``resize``. ``flood_fill`` grows its region on the device at every size,
where the JAX package takes a host loop up to 4096 pixels; both reach the
same fixed point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .blending import Blending, blend_arrays
from .color import _scalar as _sc
from .color._classes import CLASS_BY_SPACE, Gray, Rgb, Rgba, _Color
from .enums import BorderMode, Interpolation
from .rectangle import Rectangle

__all__ = ["Image", "PixelIterator"]

_SPACE_CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}
_CHANNELS_SPACE = {1: "gray", 3: "rgb", 4: "rgba"}


def _round_half_away_f32(x) -> float:
    """Round ``f32(x)`` half away from zero (rect sizes of crop/extract)."""
    x = float(np.float32(x))
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def _dtype_space(dtype) -> str:
    if dtype is None:
        return "rgb"
    if isinstance(dtype, _Color):
        dtype = type(dtype)
    if dtype is Gray:
        return "gray"
    if dtype is Rgb:
        return "rgb"
    if dtype is Rgba:
        return "rgba"
    raise TypeError("dtype must be zignal.Gray, zignal.Rgb, or zignal.Rgba")


def _parse_color(value, space: str):
    """Parse an int / float / tuple / color object into u8 components of
    `space` (reference: bindings/python/src/color_utils.zig parseColor)."""
    if isinstance(value, _Color):
        target = CLASS_BY_SPACE[space]
        return tuple(value.to(target)._v)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if isinstance(value, float) and 0.0 <= value <= 1.0 and value != int(value):
            g = _sc.f64_to_u8(value)
        else:
            g = int(value)
        if not 0 <= g <= 255:
            raise ValueError("color component must be in range 0-255")
        return _sc.convert_u8("gray", space, (g,))
    if isinstance(value, (tuple, list)):
        vals = tuple(int(v) for v in value)
        if any(not 0 <= v <= 255 for v in vals):
            raise ValueError("color components must be in range 0-255")
        if len(vals) == 3:
            return _sc.convert_u8("rgb", space, vals)
        if len(vals) == 4:
            return _sc.convert_u8("rgba", space, vals)
        raise ValueError("color tuple must have 3 or 4 components")
    raise TypeError(f"cannot interpret {type(value).__name__} as a color")


def _convert_array_u8(arr: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Host-side u8 dtype conversion, bit-exact fixed point
    (reference: src/color.zig:987-1043)."""
    if src == dst:
        return arr
    a = arr
    path = _sc.conversion_path(src, dst)
    for s, d in path:
        if (s, d) == ("rgb", "gray"):
            v = a.astype(np.int64)
            yr, yg, yb = _sc._GRAY_FWD
            y = (v[..., 0] * yr + v[..., 1] * yg + v[..., 2] * yb + 32768) >> 16
            a = np.clip(y, 0, 255).astype(np.uint8)[..., None]
        elif (s, d) == ("gray", "rgb"):
            a = np.repeat(a, 3, axis=-1)
        elif (s, d) == ("rgb", "rgba"):
            a = np.concatenate([a, np.full_like(a[..., :1], 255)], axis=-1)
        elif (s, d) == ("rgba", "rgb"):
            a = np.ascontiguousarray(a[..., :3])
        elif (s, d) == ("rgb", "ycbcr"):
            v = a.astype(np.int64)
            y = (19595 * v[..., 0] + 38470 * v[..., 1] + 7471 * v[..., 2] + 32768) >> 16
            cb = ((-11059 * v[..., 0] - 21710 * v[..., 1] + 32768 * v[..., 2] + 32768) >> 16) + 128
            cr = ((32768 * v[..., 0] - 27439 * v[..., 1] - 5329 * v[..., 2] + 32768) >> 16) + 128
            a = np.clip(np.stack([y, cb, cr], axis=-1), 0, 255).astype(np.uint8)
        elif (s, d) == ("ycbcr", "rgb"):
            v = a.astype(np.int64)
            y, cb, cr = v[..., 0], v[..., 1] - 128, v[..., 2] - 128
            r = (65536 * y + 91881 * cr + 32768) >> 16
            g = (65536 * y - 22554 * cb - 46802 * cr + 32768) >> 16
            b = (65536 * y + 116130 * cb + 32768) >> 16
            a = np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
        else:  # pragma: no cover
            raise ValueError(f"unsupported u8 conversion edge {s}->{d}")
    return a


def plane_of(image, device):
    """The u8 ``[H, W]`` plane of an Image (its luminance, on its device),
    a torch tensor (on its device) or a numpy array (on ``device``, which
    must be named); raw arrays take channel 0."""
    if isinstance(image, Image):
        return image._gray_u8_plane()
    if isinstance(image, torch.Tensor):
        plane = image if device is None else image.to(device)
    else:
        if device is None:
            raise ValueError("a numpy image needs device=")
        plane = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    return plane[..., 0] if plane.ndim == 3 else plane


class Image:
    """A 2-D image with dtype Gray, Rgb, or Rgba (u8 components) whose
    device ops run on ``device``."""

    __slots__ = ("_np", "_dev", "_space", "_at")

    def __init__(self, rows=None, cols=None, color=None, dtype=None, *,
                 device, _defer=False):
        self._at = torch.device(device)
        self._dev = None
        if _defer:
            self._np = None
            self._space = "rgb"
            return
        rows = int(rows)
        cols = int(cols)
        if rows <= 0 or cols <= 0:
            raise ValueError("rows and cols must be positive")
        if dtype is not None:
            space = _dtype_space(dtype)
        elif color is None:
            space = "rgb"
        elif isinstance(color, (int, float)):
            space = "gray"
        elif isinstance(color, (tuple, list)):
            space = "rgba" if len(color) == 4 else "rgb"
        elif isinstance(color, Rgba):
            space = "rgba"
        else:
            space = "rgb"
        c = _SPACE_CHANNELS[space]
        arr = np.zeros((rows, cols, c), dtype=np.uint8)
        if color is not None:
            arr[:] = np.array(_parse_color(color, space), dtype=np.uint8)
        self._np = arr
        self._space = space

    # -- construction helpers ----------------------------------------------

    @classmethod
    def _from_host(cls, arr: np.ndarray, space: str, device) -> "Image":
        img = cls(device=device, _defer=True)
        img._np = arr
        img._space = space
        return img

    @classmethod
    def _from_device(cls, dev: torch.Tensor, space: str) -> "Image":
        img = cls(device=dev.device, _defer=True)
        img._dev = dev
        img._space = space
        return img

    @classmethod
    def from_numpy(cls, array, *, device) -> "Image":
        """Wrap a numpy uint8 array of shape [H, W, C] (C in 1/3/4).
        The array is borrowed, not copied — mutations are shared
        (reference: bindings/python/src/image/numpy_interop.zig)."""
        if not isinstance(array, np.ndarray):
            raise TypeError("from_numpy expects a numpy.ndarray")
        if array.dtype != np.uint8:
            raise TypeError("from_numpy requires a uint8 array")
        if not array.flags.writeable:
            raise ValueError(
                "from_numpy borrows the array and requires it to be writable "
                "(pass array.copy() for read-only data)"
            )
        if array.ndim == 3 and array.shape[2] in _CHANNELS_SPACE:
            return cls._from_host(array, _CHANNELS_SPACE[array.shape[2]],
                                  device)
        raise ValueError(
            "from_numpy requires shape (rows, cols, channels) with 1, 3, or 4 channels"
        )

    @classmethod
    def load(cls, path: str, *, device) -> "Image":
        """Load a PNG/JPEG/BMP/GIF file (a GIF's first frame, as Rgba);
        dtype follows the file's content
        (reference: src/image.zig:247; bindings load)."""
        from .codecs import load_array

        arr = load_array(path)
        return cls._from_host(arr, _CHANNELS_SPACE[arr.shape[2]], device)

    @classmethod
    def load_from_bytes(cls, data, *, device) -> "Image":
        from .codecs import load_array_from_bytes

        arr = load_array_from_bytes(bytes(data))
        return cls._from_host(arr, _CHANNELS_SPACE[arr.shape[2]], device)

    def save(self, path: str, **options) -> None:
        """Save to PNG/JPEG/BMP/GIF chosen by extension
        (reference: src/image.zig:279)."""
        from .codecs import save_array

        save_array(path, self._host(), **options)

    # -- representation plumbing -------------------------------------------

    def _host(self) -> np.ndarray:
        """Materialize (and return) the authoritative host array: always a
        copy, since another image may hold the same tensor."""
        if self._np is None:
            self._np = self._dev.to("cpu", copy=True).numpy()
            self._dev = None
        return self._np

    def _device(self) -> torch.Tensor:
        """The pixel data on the image's device: the host array uploaded
        anew (a copy, also on the CPU), or the device tensor."""
        if self._np is not None:
            return torch.from_numpy(np.ascontiguousarray(self._np)).to(
                self._at, copy=True)
        return self._dev

    def _gray_u8_plane(self) -> torch.Tensor:
        """u8 ``[H, W]`` luminance on the image's device (BT.709 fixed
        point; a gray image's own plane)."""
        dev = self._device()
        if self._space == "gray":
            return dev[..., 0]
        from .color._array import rgb_to_gray_u8

        return rgb_to_gray_u8(dev[..., :3])[..., 0]

    def canvas(self):
        """A Canvas that draws into this image's host array
        (reference: Canvas.zig:27)."""
        from .canvas import Canvas

        return Canvas(self)

    def _batch(self):
        """The image as an ImageBatch of one on its device."""
        from .batch import ImageBatch

        return ImageBatch(self._device()[None], device=self._at,
                          _space=self._space)

    @staticmethod
    def _first(batch) -> "Image":
        return Image._from_device(batch.device_array()[0], batch._space)

    # -- basic properties ---------------------------------------------------

    @property
    def rows(self) -> int:
        return (self._np if self._np is not None else self._dev).shape[0]

    @property
    def cols(self) -> int:
        return (self._np if self._np is not None else self._dev).shape[1]

    @property
    def channels(self) -> int:
        return _SPACE_CHANNELS[self._space]

    @property
    def dtype(self):
        return CLASS_BY_SPACE[self._space]

    @property
    def device(self) -> torch.device:
        """Where the image's device ops run."""
        return self._at

    def is_contiguous(self) -> bool:
        if self._np is None:
            return True
        return self._np.flags["C_CONTIGUOUS"]

    def get_rectangle(self) -> Rectangle:
        return Rectangle(0, 0, self.cols, self.rows)

    # -- numpy interop ------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Zero-copy [H, W, C] uint8 view of the pixel data; writes are
        reflected in the image."""
        return self._host()

    # -- copying / equality -------------------------------------------------

    def copy(self) -> "Image":
        if self._np is not None:
            return Image._from_host(self._np.copy(), self._space, self._at)
        # no op writes a device tensor in place, and _host copies a CPU one
        return Image._from_device(self._dev, self._space)

    dupe = copy

    def __eq__(self, other):
        if not isinstance(other, Image):
            return NotImplemented
        if self._space != other._space:
            return False
        a, b = self._host(), other._host()
        return a.shape == b.shape and np.array_equal(a, b)

    def __repr__(self):
        return f"Image({self.rows}x{self.cols}, dtype={self.dtype.__name__})"

    def __format__(self, spec):
        if spec in ("", "none"):
            return repr(self)
        from .terminal.display import format_image

        return format_image(self, spec)

    def __len__(self):
        return self.rows * self.cols

    def __iter__(self):
        return PixelIterator(self)

    # -- pixel access -------------------------------------------------------

    def _check_coords(self, row, col):
        if not (0 <= row < self.rows and 0 <= col < self.cols):
            raise IndexError(f"pixel ({row}, {col}) out of bounds")

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            row, col = int(key[0]), int(key[1])
            self._check_coords(row, col)
            if self._space == "gray":
                return int(self._host()[row, col, 0])
            return _PixelProxy(self, row, col)
        raise TypeError("image indices must be a (row, col) tuple")

    def __setitem__(self, key, value):
        if isinstance(key, tuple) and len(key) == 2:
            row, col = int(key[0]), int(key[1])
            self._check_coords(row, col)
            px = _parse_color(value, self._space)
            self._host()[row, col] = np.array(px, dtype=np.uint8)
            return
        if isinstance(key, slice):
            if key != slice(None):
                raise TypeError("only full-slice assignment (img[:] = ...) is supported")
            if isinstance(value, Image):
                self._copy_from(value)
            else:
                self.fill(value)
            return
        raise TypeError("image indices must be (row, col) or [:]")

    def _copy_from(self, src: "Image"):
        """Full-image assignment with dtype conversion
        (reference: test_image.py slice-assignment semantics)."""
        if (src.rows, src.cols) != (self.rows, self.cols):
            raise ValueError("source image dimensions must match")
        data = _convert_array_u8(src._host(), src._space, self._space)
        self._host()[:] = data

    # -- mutation -----------------------------------------------------------

    def fill(self, color):
        px = _parse_color(color, self._space)
        self._host()[:] = np.array(px, dtype=np.uint8)

    def set_border(self, rect=None, color=None):
        """Fill everything outside `rect` with `color` (default zero)
        (reference: src/image.zig setBorder)."""
        if rect is None or isinstance(rect, (int, float)):
            raise TypeError("set_border requires a Rectangle or 4-tuple")
        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        if not isinstance(rect, Rectangle):
            raise TypeError("set_border requires a Rectangle or 4-tuple")
        px = (
            np.zeros(self.channels, dtype=np.uint8)
            if color is None
            else np.array(_parse_color(color, self._space), dtype=np.uint8)
        )
        arr = self._host()
        clipped = rect.intersect(self.get_rectangle())
        if clipped is None:
            arr[:] = px
            return
        l, t = int(clipped.left), int(clipped.top)
        r, b = int(clipped.right), int(clipped.bottom)
        arr[:t, :] = px
        arr[b:, :] = px
        arr[:, :l] = px
        arr[:, r:] = px

    # -- views --------------------------------------------------------------

    def view(self, rect) -> "Image":
        """Zero-copy sub-image view sharing memory with self
        (reference: src/image.zig:332)."""
        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        clipped = self.get_rectangle().intersect(rect)
        if clipped is None:
            raise ValueError("view rectangle does not intersect the image")
        l, t = int(clipped.left), int(clipped.top)
        r, b = int(clipped.right), int(clipped.bottom)
        return Image._from_host(self._host()[t:b, l:r], self._space, self._at)

    # -- dtype conversion ---------------------------------------------------

    def convert(self, dtype) -> "Image":
        """Gray/Rgb/Rgba conversion, exact u8 fixed point: on the host
        array where the image has one, else on the device."""
        space = _dtype_space(dtype)
        if space == self._space:
            return self.copy()
        if self._np is not None:
            return Image._from_host(
                _convert_array_u8(self._np, self._space, space), space,
                self._at)
        from .color._array import convert_u8_array

        return Image._from_device(
            convert_u8_array(self._dev, self._space, space), space)

    # -- simple ops (host) --------------------------------------------------

    def invert(self) -> "Image":
        """Photographic negative; alpha preserved (reference: image.zig invert)."""
        arr = self._host()
        out = 255 - arr
        if self._space == "rgba":
            out[..., 3] = arr[..., 3]
        return Image._from_host(out, self._space, self._at)

    def flip_left_right(self) -> "Image":
        return Image._from_host(self._host()[:, ::-1].copy(), self._space,
                                self._at)

    def flip_top_bottom(self) -> "Image":
        return Image._from_host(self._host()[::-1].copy(), self._space,
                                self._at)

    def blend(self, overlay: "Image", mode: Blending = Blending.NORMAL) -> None:
        """In-place alpha compositing of `overlay` (RGBA) onto self
        (reference: bindings image blend; src/blending.zig): f32 on the
        host, one rounding an operation, then rounded in f64."""
        if not isinstance(overlay, Image):
            raise TypeError("overlay must be an Image")
        if (overlay.rows, overlay.cols) != (self.rows, self.cols):
            raise ValueError("overlay dimensions must match")
        over = _convert_array_u8(overlay._host(), overlay._space, "rgba")
        base = _convert_array_u8(self._host(), self._space, "rgba")
        f32 = np.float32
        out = blend_arrays(
            torch.from_numpy(base.astype(f32) / f32(255.0)),
            torch.from_numpy(over.astype(f32) / f32(255.0)),
            Blending(mode), fused=False,
        ).numpy()
        out_u8 = np.floor(255.0 * np.clip(out.astype(np.float64), 0.0, 1.0) + 0.5)
        out_u8 = out_u8.astype(np.uint8)
        self._host()[:] = _convert_array_u8(out_u8, "rgba", self._space)

    # -- geometry (device) --------------------------------------------------

    def resize(self, size, method: Interpolation = Interpolation.BILINEAR) -> "Image":
        """Resize by scale factor (float) or to (rows, cols) on the
        image's device (reference: src/image.zig:523-543)."""
        if isinstance(size, (int, float)) and not isinstance(size, bool):
            scale = float(size)
            if not np.isfinite(scale) or abs(scale) > 3.4e38:
                raise ValueError("Scale factor must be a finite number")
            if scale <= 0:
                raise ValueError("Scale factor must be positive")
            rows = int(np.round(np.float32(self.rows) * np.float32(scale)))
            cols = int(np.round(np.float32(self.cols) * np.float32(scale)))
            if rows == 0 or cols == 0:
                raise ValueError("resulting dimensions are zero")
        elif isinstance(size, (tuple, list)) and len(size) == 2:
            rows, cols = int(size[0]), int(size[1])
            if rows <= 0 or cols <= 0:
                raise ValueError("Size must be positive")
        else:
            raise TypeError("size must be a scale factor or a (rows, cols) tuple")
        return self._first(self._batch().resize((rows, cols),
                                                Interpolation(method)))

    def letterbox(self, size, method: Interpolation = Interpolation.BILINEAR) -> "Image":
        """Aspect-preserving resize centered on a padded canvas
        (reference: src/image/transforms.zig:49-108)."""
        if isinstance(size, (int, float)) and not isinstance(size, bool):
            rows = cols = int(size)
        elif isinstance(size, (tuple, list)) and len(size) == 2:
            rows, cols = int(size[0]), int(size[1])
        else:
            raise TypeError("size must be an int or a (rows, cols) tuple")
        if rows <= 0 or cols <= 0:
            raise ValueError("Size must be positive")
        return self._first(self._batch().letterbox((rows, cols),
                                                   Interpolation(method)))

    def rotate(self, angle, method: Interpolation = Interpolation.BILINEAR,
               border: BorderMode = BorderMode.ZERO) -> "Image":
        """Rotate around the centre (radians, CCW); the output is sized to
        fit (reference: image.zig:558; transforms.zig:112-213)."""
        angle = float(angle)
        if not np.isfinite(angle) or abs(angle) > 3.4e38:
            raise ValueError("Angle must be a finite number")
        return self._first(self._batch().rotate(angle, method, border))

    def crop(self, rect) -> "Image":
        """Crop a rectangle; out of bounds is black
        (reference: transforms.zig:216-222)."""
        rect = self._coerce_rect(rect)
        rows = int(_round_half_away_f32(rect.height))
        cols = int(_round_half_away_f32(rect.width))
        if rows == 0 or cols == 0:
            raise ValueError("crop rectangle is empty")
        return self.extract(rect, 0.0, (rows, cols), Interpolation.NEAREST)

    def extract(self, rect, angle: float = 0.0, size=None,
                method: Interpolation = Interpolation.BILINEAR,
                border: BorderMode = BorderMode.ZERO) -> "Image":
        """Extract a rotated rect, resampled to ``size``
        (reference: transforms.zig:231-283)."""
        return self._first(self._batch().extract(
            self._coerce_rect(rect), angle, size, method, border))

    def insert(self, source: "Image", rect, angle: float = 0.0,
               method: Interpolation = Interpolation.BILINEAR,
               blend_mode: Blending = Blending.NONE) -> None:
        """Insert ``source`` into self at a rotated rect, in place
        (reference: transforms.zig:293-380): sampled and blended on the
        image's device, written into the host array."""
        if not isinstance(source, Image):
            raise TypeError("source must be an Image")
        rect = self._coerce_rect(rect)
        from .ops.warp import insert_region

        mode = Blending(blend_mode)
        if mode != Blending.NONE and source._space == "rgba":
            src = source._device()
        else:
            src = source.convert(self.dtype)._device()
            mode = Blending.NONE
        # the JAX package runs this op by op, not as one compiled program
        out = insert_region(
            self._device(), src.to(self._at),
            (rect.left, rect.top, rect.right, rect.bottom), float(angle),
            Interpolation(method), mode, compiled=False)
        self._host()[:] = out.cpu().numpy()

    def warp(self, transform, shape=None,
             method: Interpolation = Interpolation.BILINEAR) -> "Image":
        """Backward-map through a geometric transform
        (reference: image.zig:621; transforms.zig:522)."""
        return self._first(self._batch().warp(transform, shape, method))

    def _coerce_rect(self, rect) -> Rectangle:
        if isinstance(rect, (tuple, list)) and len(rect) == 4:
            return Rectangle(*rect)
        if isinstance(rect, Rectangle):
            return rect
        raise TypeError("expected a Rectangle or (l, t, r, b) tuple")

    # -- filtering (device) -------------------------------------------------

    def box_blur(self, radius: int) -> "Image":
        """Box blur via summed-area table (reference: image.zig:635)."""
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self.copy()
        return self._first(self._batch().box_blur(radius))

    def sharpen(self, radius: int) -> "Image":
        """Unsharp mask 2*orig - box_blur (reference: image.zig:785)."""
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self.copy()
        return self._first(self._batch().sharpen(radius))

    def gaussian_blur(self, sigma: float) -> "Image":
        """Separable Gaussian blur, radius=ceil(3*sigma)
        (reference: image.zig:954)."""
        sigma = float(sigma)
        if not (sigma > 0) or not np.isfinite(sigma):
            raise ValueError("sigma must be positive and finite")
        return self._first(self._batch().gaussian_blur(sigma))

    def convolve(self, kernel,
                 border: BorderMode = BorderMode.MIRROR) -> "Image":
        """2-D convolution with an arbitrary kernel (reference:
        image.zig:917 convolve), the reference's 8.8 fixed point."""
        return self._first(self._batch().convolve(kernel, BorderMode(border)))

    def convolve_separable(self, kernel_x, kernel_y,
                           border: BorderMode = BorderMode.MIRROR) -> "Image":
        """Separable convolution with 1-D kernels (reference:
        image.zig:935 convolveSeparable)."""
        return self._first(self._batch().convolve_separable(
            kernel_x, kernel_y, BorderMode(border)))

    def _order_stat(self, name, radius, *args):
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self.copy()
        return self._first(getattr(self._batch(), name)(radius, *args))

    def median_blur(self, radius: int) -> "Image":
        """Median filter (reference: image.zig:653)."""
        return self._order_stat("median_blur", radius)

    def percentile_blur(self, radius: int, percentile: float,
                        border: BorderMode = BorderMode.MIRROR) -> "Image":
        """Percentile filter (reference: image.zig:672)."""
        percentile = float(percentile)
        if not 0.0 <= percentile <= 1.0:
            raise ValueError("percentile must be in [0, 1]")
        return self._order_stat("percentile_blur", radius, percentile,
                                BorderMode(border))

    def min_blur(self, radius: int, border: BorderMode = BorderMode.MIRROR) -> "Image":
        return self._order_stat("min_blur", radius, BorderMode(border))

    def max_blur(self, radius: int, border: BorderMode = BorderMode.MIRROR) -> "Image":
        return self._order_stat("max_blur", radius, BorderMode(border))

    def midpoint_blur(self, radius: int,
                      border: BorderMode = BorderMode.MIRROR) -> "Image":
        return self._order_stat("midpoint_blur", radius, BorderMode(border))

    def alpha_trimmed_mean_blur(self, radius: int, trim_fraction: float,
                                border: BorderMode = BorderMode.MIRROR) -> "Image":
        trim_fraction = float(trim_fraction)
        if not np.isfinite(trim_fraction) or not 0.0 <= trim_fraction < 0.5:
            raise ValueError("trim_fraction must be in [0, 0.5)")
        return self._order_stat("alpha_trimmed_mean_blur", radius,
                                trim_fraction, BorderMode(border))

    def motion_blur(self, config) -> "Image":
        """Linear or radial motion blur (reference: image.zig:1077)."""
        return self._first(self._batch().motion_blur(config))

    def sobel(self) -> "Image":
        """Sobel gradient magnitude as a grayscale image
        (reference: image.zig:999; edges.zig:29)."""
        return self._first(self._batch().sobel())

    def canny(self, sigma: float = 1.4, low: float = 50, high: float = 150) -> "Image":
        """Canny edge detection -> binary gray image
        (reference: image.zig:1047; edges.zig:212)."""
        sigma, low, high = float(sigma), float(low), float(high)
        for v in (sigma, low, high):
            if not np.isfinite(v):
                raise ValueError("parameters must be finite numbers")
        if sigma < 0:
            raise ValueError("sigma must be non-negative")
        if low < 0 or high < 0 or low >= high:
            raise ValueError("thresholds must satisfy 0 <= low < high")
        return self._first(self._batch().canny(sigma, low, high))

    def shen_castan(self, smooth: float = 0.9, window_size: int = 7,
                    high_ratio: float = 0.99, low_rel: float = 0.5,
                    hysteresis: bool = True, use_nms: bool = False) -> "Image":
        """Shen-Castan (ISEF) edge detection -> binary gray image
        (reference: image.zig:1015; ShenCastan.zig)."""
        smooth = float(smooth)
        window_size = int(window_size)
        high_ratio = float(high_ratio)
        low_rel = float(low_rel)
        if not 0 < smooth < 1:
            raise ValueError("smooth must be in (0, 1)")
        if window_size % 2 == 0:
            raise ValueError("window_size must be odd")
        if window_size < 3:
            raise ValueError("window_size must be >= 3")
        if not 0 < high_ratio < 1:
            raise ValueError("high_ratio must be in (0, 1)")
        if not 0 < low_rel < 1:
            raise ValueError("low_rel must be in (0, 1)")
        return self._first(self._batch().shen_castan(
            smooth, window_size, high_ratio, low_rel, bool(hysteresis),
            bool(use_nms)))

    def display(self, format: str = "auto") -> str:
        """Terminal rendering escape sequence (reference: image.zig:462;
        image/display.zig). Formats: auto/kitty/iterm2/sixel/sgr/braille;
        kitty and iterm2 scale through ``resize`` on the image's
        device."""
        from .terminal.display import format_image

        return format_image(self, format)

    def apply_colormap(self, colormap) -> "Image":
        """Map intensities through a colormap -> RGB image on the image's
        device (reference: image.zig:1190; colormaps.zig)."""
        from .colormaps import Colormap

        if not isinstance(colormap, Colormap):
            raise TypeError("apply_colormap expects a Colormap")
        return Image._from_device(colormap.apply_plane(self._gray_u8_plane()),
                                  "rgb")

    def flood_fill(self, row: int, col: int, fill_value, threshold: float = 0.0,
                   connectivity: int = 4, mode=None) -> None:
        """In-place flood fill from a seed pixel (reference: image.zig:831;
        flood_fill.zig): the region grows on the image's device
        (ops/flood_fill.py) at every size, and its pixels are written into
        the host array."""
        from .ops.flood_fill import fill_region

        fill_px = np.array(_parse_color(fill_value, self._space),
                           dtype=np.uint8)
        mask = fill_region(self._device(), row, col, threshold, connectivity,
                           mode)
        self._host()[mask.cpu().numpy()] = fill_px

    # -- thresholding & morphology -----------------------------------------

    def threshold_otsu(self):
        """Otsu binarization -> (binary gray Image, threshold)
        (reference: image.zig:845; binary.zig:38)."""
        out, thresholds = self._batch().threshold_otsu()
        return self._first(out), int(thresholds[0])

    def threshold_adaptive_mean(self, radius: int = 6, c: float = 5.0):
        """Adaptive mean threshold via integral image
        (reference: image.zig:858; binary.zig:86)."""
        radius = int(radius)
        if radius <= 0:
            raise ValueError("radius must be positive")
        return self._first(self._batch().threshold_adaptive_mean(radius,
                                                                 float(c)))

    def _morph(self, name: str, kernel_size: int, iterations: int):
        kernel_size = int(kernel_size)
        iterations = int(iterations)
        if kernel_size < 3 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >= 3")
        if iterations < 0:
            raise ValueError("iterations must be non-negative")
        if iterations == 0:
            return self.copy()
        return self._first(getattr(self._batch(), name)(kernel_size,
                                                        iterations))

    def dilate_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph("dilate_binary", kernel_size, iterations)

    def erode_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph("erode_binary", kernel_size, iterations)

    def open_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph("open_binary", kernel_size, iterations)

    def close_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph("close_binary", kernel_size, iterations)

    # -- enhancement ---------------------------------------------------------

    def autocontrast(self, cutoff: float = 0.0) -> "Image":
        """Contrast stretch ignoring `cutoff` fraction per end
        (reference: image.zig:804; enhancement.zig:11)."""
        return self._first(self._batch().autocontrast(cutoff))

    def equalize(self) -> "Image":
        """Histogram equalization per channel
        (reference: image.zig:824; enhancement.zig:84)."""
        return self._first(self._batch().equalize())

    def histogram(self):
        """Per-channel 256-bin histogram (reference: image.zig:1161)."""
        from .histogram import Histogram

        return Histogram.from_image(self)

    # -- metrics --------------------------------------------------------------

    def ssim(self, other: "Image") -> float:
        """Mean SSIM over 11x11 Gaussian windows, f32 on the image's device
        (reference: image.zig:1126; metrics.zig:56)."""
        self._check_same(other)
        if self.rows < 11 or self.cols < 11:
            raise ValueError("images must be at least 11x11 for SSIM")
        return float(self._batch().ssim(other._batch())[0])

    def psnr(self, other: "Image") -> float:
        """Peak signal-to-noise ratio in dB, host f64
        (reference: src/image/metrics.zig:10)."""
        self._check_same(other)
        a = self._host().astype(np.float64)
        b = other._host().astype(np.float64)
        mse = np.mean((a - b) ** 2)
        if mse == 0:
            return float("inf")
        return float(10.0 * np.log10(255.0**2 / mse))

    def diff(self, other: "Image", threshold: float = 0.0, scale: float = 1.0,
             binary: bool = False, force_opaque: bool = False):
        """Per-pixel difference visualisation and its statistics -> (Image,
        DiffResult), host numpy (reference: src/image.zig:1139 diff,
        src/image/diff.zig:27)."""
        self._check_same(other)
        from .ops.diff import DiffOptions, compute

        vis, result = compute(
            self._host(), other._host(),
            DiffOptions(threshold=threshold, scale=scale, binary=binary,
                        force_opaque=force_opaque))
        return Image._from_host(vis, self._space, self._at), result

    def mean_pixel_error(self, other: "Image") -> float:
        """Mean absolute pixel error normalised to [0, 1], host f64
        (reference: src/image/metrics.zig:114)."""
        self._check_same(other)
        a = self._host().astype(np.float64)
        b = other._host().astype(np.float64)
        return float(np.mean(np.abs(a - b)) / 255.0)

    def _check_same(self, other):
        if not isinstance(other, Image):
            raise TypeError("expected an Image")
        if (other.rows, other.cols) != (self.rows, self.cols):
            raise ValueError("image dimensions must match")
        if other._space != self._space:
            raise ValueError("image dtypes must match")


class _PixelProxy:
    """Mutable view of one RGB(A) pixel (reference:
    bindings/python/src/pixel_proxy.zig)."""

    __slots__ = ("_img", "_row", "_col")

    def __init__(self, img, row, col):
        object.__setattr__(self, "_img", img)
        object.__setattr__(self, "_row", row)
        object.__setattr__(self, "_col", col)

    def _values(self):
        return tuple(int(v) for v in self._img._host()[self._row, self._col])

    @property
    def _fields(self):
        return ("r", "g", "b", "a")[: self._img.channels]

    def __getattr__(self, name):
        fields = ("r", "g", "b", "a")[: object.__getattribute__(self, "_img").channels]
        if name in fields:
            img = object.__getattribute__(self, "_img")
            return int(img._host()[self._row, self._col, fields.index(name)])
        raise AttributeError(name)

    def __setattr__(self, name, value):
        fields = self._fields
        if name in fields:
            if not (isinstance(value, int) and 0 <= value <= 255):
                raise ValueError("component must be an integer in 0-255")
            self._img._host()[self._row, self._col, fields.index(name)] = value
            return
        raise AttributeError(name)

    def item(self):
        cls = CLASS_BY_SPACE[self._img._space]
        return cls._new_unchecked(list(self._values()))

    def to(self, target):
        return self.item().to(target)

    def blend(self, overlay, mode: Blending = Blending.NORMAL):
        """Blend overlay into this pixel in place; returns the new color."""
        out = self.item().blend(overlay, mode)
        self._img._host()[self._row, self._col] = np.array(out._v, dtype=np.uint8)
        return out

    def __eq__(self, other):
        if isinstance(other, (tuple, list)):
            return self._values() == tuple(other)
        if isinstance(other, _PixelProxy):
            return self._values() == other._values()
        if isinstance(other, _Color):
            return self.item() == other
        return NotImplemented

    def __repr__(self):
        return repr(self.item())

    def __format__(self, spec):
        if spec == "sgr":
            rgb = self.to(Rgb)
            return f"\x1b[48;2;{rgb.r};{rgb.g};{rgb.b}m  \x1b[0m"
        return format(self.item(), spec)


class PixelIterator:
    """Row-major pixel iterator yielding (row, col, pixel)
    (reference: src/image/PixelIterator.zig)."""

    __slots__ = ("_img", "_idx")

    def __init__(self, img):
        self._img = img
        self._idx = 0

    def __iter__(self):
        return self

    def __next__(self):
        img = self._img
        if self._idx >= len(img):
            raise StopIteration
        row, col = divmod(self._idx, img.cols)
        self._idx += 1
        arr = img._host()
        if img._space == "gray":
            px = int(arr[row, col, 0])
        else:
            px = CLASS_BY_SPACE[img._space]._new_unchecked(
                [int(v) for v in arr[row, col]]
            )
        return (row, col, px)
