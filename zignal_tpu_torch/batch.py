"""ImageBatch — a batch of same-shape u8 images ``[B, H, W, C]`` held as a
torch tensor on one explicit device with a dtype tag (Gray, Rgb or Rgba),
the counterpart of zignal_tpu/batch.py: construction (from arrays,
Images and files), interop with ``Image``, save, resize and letterbox, the
resize -> blur -> Oklab path, the windowed filters (convolutions,
clamped-window and order-statistic blurs, morphology), the edge detectors,
the pointwise ops (convert, invert, flips, fill, set_border, blend), the
histogram and threshold ops, the geometric ops (rotate, crop, extract,
warp, insert), motion blur, the metrics (psnr, ssim, mean_pixel_error,
diff), colormaps and flood fill. The ops take ``[B, H, W, C]`` (or the
``[B, H, W]`` gray plane) directly: nothing is mapped image by image, and the geometric ops' host
coordinates are shared by the batch.

The device is always the caller's choice (``device=``); nothing here
picks one. There is no mesh yet (ROADMAP item 15).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .blending import Blending, blend_arrays
from .color._array import convert_u8_array, rgb_to_gray_u8
from .color._classes import CLASS_BY_SPACE
from .enums import BorderMode, Interpolation
from .image import (_CHANNELS_SPACE, _SPACE_CHANNELS, Image, _dtype_space,
                    _parse_color)
from .ops import (binary, edges, enhancement, integral, metrics,
                  motion_blur_ops, order_stat, warp)
from .ops.fma import fma
from .ops.convolution import convolve2d, sobel_magnitude
from .ops.convolution import convolve_separable as convolve_separable_op
from .ops.convolution import gaussian_blur as gaussian_blur_op
from .ops.interpolation import resize as resize_op
from .pipeline import resize_blur_oklab as _chain
from .rectangle import Rectangle

__all__ = ["ImageBatch", "resize_blur_oklab_fn"]


def resize_blur_oklab_fn(rows: int, cols: int, sigma: float, method):
    """The callable behind ImageBatch.resize_blur_oklab: the north-star
    chain with its parameters bound. It runs on its input's device."""
    return partial(_chain, out_rows=rows, out_cols=cols, sigma=sigma,
                   method=method)


class ImageBatch:
    """A batch of same-shape images: u8 [B, H, W, C] on ``device``."""

    __slots__ = ("_dev", "_space")

    def __init__(self, array, dtype=None, *, device, _space=None):
        if isinstance(array, np.ndarray):
            is_u8 = array.dtype == np.uint8
        elif isinstance(array, torch.Tensor):
            is_u8 = array.dtype == torch.uint8
        else:
            raise TypeError("ImageBatch expects a numpy array or a torch "
                            "tensor")
        if array.ndim != 4:
            raise ValueError("ImageBatch expects a [B, H, W, C] array")
        space = _space if _space is not None else (
            _dtype_space(dtype) if dtype is not None else None)
        c = array.shape[-1]
        if space is None:
            if c not in _CHANNELS_SPACE:
                raise ValueError("channel count must be 1, 3, or 4")
            space = _CHANNELS_SPACE[c]
        elif _SPACE_CHANNELS[space] != c:
            raise ValueError(f"dtype {space} expects {_SPACE_CHANNELS[space]}"
                             f" channels, array has {c}")
        if not is_u8:
            raise TypeError("ImageBatch requires uint8 pixel data")
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        self._dev = array.to(torch.device(device)).contiguous()
        self._space = space

    # -- construction --------------------------------------------------------

    @classmethod
    def from_numpy(cls, array, *, device) -> "ImageBatch":
        if not isinstance(array, np.ndarray):
            raise TypeError("from_numpy expects a numpy.ndarray")
        return cls(array, device=device)

    @classmethod
    def from_images(cls, images, *, device) -> "ImageBatch":
        """Stack a list of same-shape, same-dtype Images."""
        if not images:
            raise ValueError("from_images requires at least one image")
        if not all(isinstance(im, Image) for im in images):
            raise TypeError("from_images expects a list of Image")
        space = images[0]._space
        shape = (images[0].rows, images[0].cols)
        for im in images[1:]:
            if im._space != space or (im.rows, im.cols) != shape:
                raise ValueError(
                    "all images must share shape and dtype (use "
                    ".convert()/.resize() first)")
        arr = np.stack([im.to_numpy() for im in images])
        return cls(arr, device=device, _space=space)

    @classmethod
    def from_paths(cls, paths, shape=None, interpolation=None, *, device,
                   workers: int = 8) -> "ImageBatch":
        """Decode files in parallel (io_pipeline) into one batch on
        ``device`` (through pinned memory on the card); pass ``shape`` to
        letterbox each image so the batch is uniform."""
        from .io_pipeline import load_image_batch

        return cls(load_image_batch(paths, shape=shape,
                                    interpolation=interpolation,
                                    workers=workers, device=device),
                   device=device)

    # -- metadata / interop --------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self._dev.shape[0]

    @property
    def rows(self) -> int:
        return self._dev.shape[1]

    @property
    def cols(self) -> int:
        return self._dev.shape[2]

    @property
    def channels(self) -> int:
        return self._dev.shape[3]

    @property
    def dtype(self):
        return CLASS_BY_SPACE[self._space]

    @property
    def device(self) -> torch.device:
        return self._dev.device

    def __len__(self) -> int:
        return self.batch_size

    def __repr__(self):
        return (f"ImageBatch({self.batch_size}x{self.rows}x{self.cols}, "
                f"dtype={self.dtype.__name__})")

    def to_numpy(self) -> np.ndarray:
        return self._dev.cpu().numpy()

    def device_array(self) -> torch.Tensor:
        """The underlying [B, H, W, C] tensor (no copy)."""
        return self._dev

    def block_until_ready(self) -> "ImageBatch":
        if self._dev.device.type == "cuda":
            torch.cuda.current_stream(self._dev.device).synchronize()
        return self

    def __getitem__(self, i) -> Image:
        i = int(i)
        if not -self.batch_size <= i < self.batch_size:
            raise IndexError("batch index out of range")
        return Image._from_host(self._dev[i].to("cpu", copy=True).numpy(),
                                self._space, self.device)

    def to_images(self):
        arr = self.to_numpy()
        return [Image._from_host(arr[i].copy(), self._space, self.device)
                for i in range(arr.shape[0])]

    def copy(self) -> "ImageBatch":
        """Same pixels and device (no op writes a batch in place, so the
        tensor is shared)."""
        return self._wrap(self._dev)

    def get_rectangle(self):
        from .rectangle import Rectangle

        return Rectangle(0, 0, self.cols, self.rows)

    def save(self, paths, workers: int = 8, **options) -> None:
        """Encode every image to its path (codec picked by extension,
        like Image.save; reference: src/image.zig:279) on worker threads:
        the codecs' native hot loops release the interpreter lock, so
        encodes overlap."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        from .codecs import save_array

        paths = [os.fspath(p) for p in paths]
        if len(paths) != self.batch_size:
            raise ValueError(
                f"need {self.batch_size} paths, got {len(paths)}")
        arr = self.to_numpy()
        with ThreadPoolExecutor(max_workers=max(1, int(workers))) as ex:
            list(ex.map(lambda i: save_array(paths[i], arr[i], **options),
                        range(len(paths))))

    # -- geometry ------------------------------------------------------------

    def _out_size(self, size):
        if isinstance(size, (int, float)) and not isinstance(size, bool):
            scale = float(size)
            if not np.isfinite(scale) or scale <= 0:
                raise ValueError("scale factor must be positive and finite")
            rows = int(np.round(np.float32(self.rows) * np.float32(scale)))
            cols = int(np.round(np.float32(self.cols) * np.float32(scale)))
            if rows == 0 or cols == 0:
                raise ValueError("resulting dimensions are zero")
            return rows, cols
        if isinstance(size, (tuple, list)) and len(size) == 2:
            rows, cols = int(size[0]), int(size[1])
            if rows <= 0 or cols <= 0:
                raise ValueError("size must be positive")
            return rows, cols
        raise TypeError("size must be a scale factor or (rows, cols)")

    def resize(self, size, method: Interpolation = Interpolation.BILINEAR
               ) -> "ImageBatch":
        """Batched resize; on the card u8 bilinear is the fused kernel
        with the blur and the Oklab epilogue off."""
        rows, cols = self._out_size(size)
        return self._wrap(resize_op(self._dev, rows, cols,
                                    Interpolation(method)))

    def letterbox(self, size, method: Interpolation = Interpolation.BILINEAR
                  ) -> "ImageBatch":
        """Resize into ``size`` keeping the aspect ratio, centred on a
        zero canvas."""
        if isinstance(size, (int, float)) and not isinstance(size, bool):
            rows = cols = int(size)
        else:
            rows, cols = int(size[0]), int(size[1])
        if rows <= 0 or cols <= 0:
            raise ValueError("size must be positive")
        f32 = np.float32
        rs, cs = f32(rows) / f32(self.rows), f32(cols) / f32(self.cols)
        if rs == cs:
            return self.resize((rows, cols), method)
        aspect = min(rs, cs)
        sr = max(1, int(np.round(aspect * f32(self.rows))))
        sc = max(1, int(np.round(aspect * f32(self.cols))))
        off_r, off_c = (rows - sr) // 2, (cols - sc) // 2
        content = resize_op(self._dev, sr, sc, Interpolation(method))
        canvas = self._dev.new_zeros((self._dev.shape[0], rows, cols,
                                      self.channels))
        canvas[:, off_r:off_r + sr, off_c:off_c + sc] = content
        return self._wrap(canvas)

    def resize_blur_oklab(self, size, sigma: float = 2.0,
                          method: Interpolation = Interpolation.BILINEAR):
        """The north-star chain (BASELINE.md): resize -> Gaussian blur ->
        sRGB->Oklab, one kernel launch on the card.

        Returns a [B, rows, cols, 3] float32 Oklab tensor on the batch's
        device (not an ImageBatch — Oklab is float-typed)."""
        rows, cols = self._out_size(size)
        if self.channels != 3:
            raise ValueError("resize_blur_oklab expects an Rgb batch")
        fn = resize_blur_oklab_fn(rows, cols, float(sigma),
                                  Interpolation(method))
        return fn(self._dev)

    def rotate(self, angle, method: Interpolation = Interpolation.BILINEAR,
               border: BorderMode = BorderMode.ZERO) -> "ImageBatch":
        """Rotate every image around its centre (radians, CCW), sized to
        fit; the coordinates are host f32, shared by the batch."""
        angle = float(angle)
        if not np.isfinite(angle):
            raise ValueError("angle must be finite")
        rows, cols = warp.rotate_bounds(self.rows, self.cols, angle)
        return self._wrap(warp.rotate(self._dev, angle, rows, cols,
                                      Interpolation(method),
                                      BorderMode(border)))

    def crop(self, rect) -> "ImageBatch":
        """Crop a rectangle of every image; out of bounds is black."""
        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        return self.extract(rect, 0.0, None, Interpolation.NEAREST)

    def extract(self, rect, angle: float = 0.0, size=None,
                method: Interpolation = Interpolation.BILINEAR,
                border: BorderMode = BorderMode.ZERO) -> "ImageBatch":
        """Sample a rotated rect of every image into ``size`` (default: the
        rect's own size)."""
        from .image import _round_half_away_f32

        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        if size is None:
            rows = max(1, int(_round_half_away_f32(rect.height)))
            cols = max(1, int(_round_half_away_f32(rect.width)))
        elif isinstance(size, (int, float)):
            rows = cols = int(size)
        else:
            rows, cols = int(size[0]), int(size[1])
        if rows <= 0 or cols <= 0:
            raise ValueError("size must be positive")
        return self._wrap(warp.extract(
            self._dev, (rect.left, rect.top, rect.right, rect.bottom),
            float(angle), rows, cols, Interpolation(method),
            BorderMode(border)))

    def warp(self, transform, shape=None,
             method: Interpolation = Interpolation.BILINEAR) -> "ImageBatch":
        """Backward-map every image through a Similarity, Affine or
        Projective transform (MIRROR border), host f32 coordinates."""
        from .geometry.transforms import (AffineTransform,
                                          ProjectiveTransform,
                                          SimilarityTransform)

        if not isinstance(transform, (SimilarityTransform, AffineTransform,
                                      ProjectiveTransform)):
            raise TypeError("transform must be a Similarity/Affine/"
                            "Projective transform")
        rows, cols = ((self.rows, self.cols) if shape is None
                      else (int(shape[0]), int(shape[1])))
        return self._wrap(warp.warp(self._dev, transform.homogeneous(), rows,
                                    cols, Interpolation(method)))

    def insert(self, source, rect, angle: float = 0.0,
               method: Interpolation = Interpolation.BILINEAR,
               blend_mode=None) -> "ImageBatch":
        """Insert ``source`` at a rotated rect into every image, the
        functional mirror of the mutating Image.insert (reference:
        transforms.zig:293-380). ``source`` is an Image, shared by the
        batch, or an ImageBatch of the same length, one an image. An Rgba
        source blends with ``blend_mode``, rounded as the JAX package's
        compiled batch op rounds it (fused multiply-adds)."""
        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        if not isinstance(rect, Rectangle):
            raise TypeError("expected a Rectangle or (l, t, r, b) tuple")
        mode = Blending.NONE if blend_mode is None else Blending(blend_mode)
        per_image = isinstance(source, ImageBatch)
        if not per_image and not isinstance(source, Image):
            raise TypeError("source must be an Image or an ImageBatch")
        if per_image and source.batch_size != self.batch_size:
            raise ValueError("source batch length must match")
        if mode == Blending.NONE or source._space != "rgba":
            source = source.convert(self.dtype)
            mode = Blending.NONE
        src = source._dev if per_image else source._device()
        return self._wrap(warp.insert_region(
            self._dev, src.to(self._dev.device),
            (rect.left, rect.top, rect.right, rect.bottom), float(angle),
            Interpolation(method), mode, compiled=True))

    def flood_fill(self, row: int, col: int, fill_value,
                   threshold: float = 0.0, connectivity: int = 4,
                   mode=None) -> "ImageBatch":
        """Flood fill every image from the same seed, the functional mirror
        of Image.flood_fill (reference: image.zig:831; flood_fill.zig): one
        region mask [B, H, W] grown on the batch's device."""
        from .ops.flood_fill import fill_region

        px = torch.tensor(_parse_color(fill_value, self._space),
                          dtype=torch.uint8, device=self._dev.device)
        mask = fill_region(self._dev, row, col, threshold, connectivity,
                           mode)
        return self._wrap(torch.where(mask[..., None], px, self._dev))

    def motion_blur(self, config) -> "ImageBatch":
        """Linear or radial motion blur of every image: an axis-aligned
        linear blur is the separable kernel on the card; the others gather
        at host coordinates (the radial ones cached on the device)."""
        from .motion_blur import MotionBlur

        if not isinstance(config, MotionBlur):
            raise TypeError("motion_blur expects a MotionBlur configuration")
        if config.kind == "linear":
            out = motion_blur_ops.linear_motion_blur(self._dev, config.angle,
                                                     config.distance)
        else:
            out = motion_blur_ops.radial_blur(
                self._dev, config.center_x, config.center_y, config.strength,
                config.kind == "zoom")
        return self._wrap(out)

    # -- windowed filters ----------------------------------------------------

    def _wrap(self, arr, space=None) -> "ImageBatch":
        """A batch of ``arr`` on this batch's device: in ``space``, else
        in this batch's space where the channel count is its own, else in
        the space of the count."""
        if space is None and arr.shape[-1] == self.channels:
            space = self._space
        return ImageBatch(arr, device=self._dev.device, _space=space)

    def _gray_plane(self) -> torch.Tensor:
        """u8 [B, H, W] luminance plane (BT.709 fixed point)."""
        if self.channels == 1:
            return self._dev[..., 0]
        return rgb_to_gray_u8(self._dev[..., :3])[..., 0]

    def _gray_f32(self) -> torch.Tensor:
        return self._gray_plane().to(torch.float32)

    def gaussian_blur(self, sigma: float) -> "ImageBatch":
        """MIRROR-bordered Gaussian blur; the separable kernel on the
        card."""
        sigma = float(sigma)
        if not (sigma > 0) or not np.isfinite(sigma):
            raise ValueError("sigma must be positive and finite")
        return self._wrap(gaussian_blur_op(self._dev, sigma))

    def convolve_separable(self, kernel_x, kernel_y,
                           border=BorderMode.MIRROR) -> "ImageBatch":
        """Batched separable convolution (reference: image.zig:935); the
        separable kernel on the card."""
        kx = np.asarray(kernel_x, dtype=np.float32)
        ky = np.asarray(kernel_y, dtype=np.float32)
        if kx.ndim != 1 or ky.ndim != 1 or len(kx) % 2 == 0 \
                or len(ky) % 2 == 0:
            raise ValueError("kernels must be 1-D with odd length")
        kxt = tuple(float(v) for v in kx)
        kyt = tuple(float(v) for v in ky)
        return self._wrap(convolve_separable_op(self._dev, kxt, kyt,
                                                BorderMode(border)))

    def convolve(self, kernel, border=BorderMode.MIRROR) -> "ImageBatch":
        """Batched 2-D convolution (reference: image.zig:917)."""
        k = np.asarray(kernel, dtype=np.float32)
        if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
            raise ValueError("kernel must be 2-D with odd dimensions")
        return self._wrap(convolve2d(self._dev, k, BorderMode(border)))

    def _order_stat(self, op, radius: int, *args) -> "ImageBatch":
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self._wrap(self._dev)
        return self._wrap(op(self._dev, radius, *args))

    def median_blur(self, radius: int) -> "ImageBatch":
        return self._order_stat(order_stat.median_blur, radius)

    def percentile_blur(self, radius: int, percentile: float,
                        border: BorderMode = BorderMode.MIRROR
                        ) -> "ImageBatch":
        percentile = float(percentile)
        if not 0.0 <= percentile <= 1.0:
            raise ValueError("percentile must be in [0, 1]")
        return self._order_stat(order_stat.percentile_blur, radius,
                                percentile, BorderMode(border))

    def min_blur(self, radius: int,
                 border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.min_blur, radius,
                                BorderMode(border))

    def max_blur(self, radius: int,
                 border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.max_blur, radius,
                                BorderMode(border))

    def midpoint_blur(self, radius: int,
                      border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.midpoint_blur, radius,
                                BorderMode(border))

    def alpha_trimmed_mean_blur(self, radius: int, trim_fraction: float,
                                border: BorderMode = BorderMode.MIRROR
                                ) -> "ImageBatch":
        trim_fraction = float(trim_fraction)
        if not np.isfinite(trim_fraction) or not 0.0 <= trim_fraction < 0.5:
            raise ValueError("trim_fraction must be in [0, 0.5)")
        return self._order_stat(order_stat.alpha_trimmed_mean_blur, radius,
                                trim_fraction, BorderMode(border))

    def sobel(self) -> "ImageBatch":
        return self._wrap(sobel_magnitude(self._gray_f32())[..., None])

    def canny(self, sigma: float = 1.4, low: float = 50,
              high: float = 150) -> "ImageBatch":
        sigma, low, high = float(sigma), float(low), float(high)
        if sigma < 0 or low < 0 or high < 0 or low >= high:
            raise ValueError("need sigma >= 0 and 0 <= low < high")
        return self._wrap(edges.canny(self._gray_f32(), sigma, low,
                                      high)[..., None])

    def shen_castan(self, smooth: float = 0.9, window_size: int = 7,
                    high_ratio: float = 0.99, low_rel: float = 0.5,
                    hysteresis: bool = True, use_nms: bool = False
                    ) -> "ImageBatch":
        out = edges.shen_castan(
            self._gray_f32(), smooth=float(smooth),
            window_size=int(window_size), high_ratio=float(high_ratio),
            low_rel=float(low_rel), hysteresis=bool(hysteresis),
            use_nms=bool(use_nms))
        return self._wrap(out[..., None])

    def _clamped(self, op, radius: int) -> "ImageBatch":
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self._wrap(self._dev)
        return self._wrap(op(self._dev, radius))

    def box_blur(self, radius: int) -> "ImageBatch":
        return self._clamped(integral.box_blur, radius)

    def sharpen(self, radius: int) -> "ImageBatch":
        return self._clamped(integral.sharpen, radius)

    def threshold_adaptive_mean(self, radius: int = 6, c: float = 5.0
                                ) -> "ImageBatch":
        """255 where the gray plane exceeds its clamped-window mean less
        ``c``, else 0 (a gray batch)."""
        if int(radius) <= 0:
            raise ValueError("radius must be positive")
        out = binary.adaptive_mean_threshold(self._gray_plane(), int(radius),
                                             float(c))
        return self._wrap(out[..., None])

    def _morph(self, op, kernel_size: int, iterations: int) -> "ImageBatch":
        kernel_size = int(kernel_size)
        iterations = int(iterations)
        if kernel_size < 3 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >= 3")
        if iterations < 0:
            raise ValueError("iterations must be non-negative")
        plane = self._gray_plane()
        if iterations:
            plane = op(plane, kernel_size, iterations)
        return self._wrap(plane[..., None])

    def dilate_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.dilate, kernel_size, iterations)

    def erode_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.erode, kernel_size, iterations)

    def open_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.open_morph, kernel_size, iterations)

    def close_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.close_morph, kernel_size, iterations)

    # -- pointwise ops -------------------------------------------------------

    def convert(self, dtype) -> "ImageBatch":
        """Conversion among Gray, Rgb and Rgba (the dtype classes), exact
        u8 fixed point."""
        space = _dtype_space(dtype)
        if space == self._space:
            return self._wrap(self._dev)
        return self._wrap(convert_u8_array(self._dev, self._space, space),
                          space)

    def invert(self) -> "ImageBatch":
        """Photographic negative; alpha preserved."""
        out = 255 - self._dev
        if self._space == "rgba":
            out[..., 3] = self._dev[..., 3]
        return self._wrap(out)

    def apply_colormap(self, colormap) -> "ImageBatch":
        """Map every image's intensities through a colormap -> an RGB batch;
        the auto range is each image's own min and max, and a fixed range
        is rounded as the JAX package's compiled batch op rounds it."""
        from .colormaps import Colormap

        if not isinstance(colormap, Colormap):
            raise TypeError("apply_colormap expects a Colormap")
        return self._wrap(colormap.apply_plane(self._gray_plane(),
                                               compiled=True), "rgb")

    def flip_left_right(self) -> "ImageBatch":
        return self._wrap(torch.flip(self._dev, (2,)))

    def flip_top_bottom(self) -> "ImageBatch":
        return self._wrap(torch.flip(self._dev, (1,)))

    def blend(self, overlay: "ImageBatch", mode=None) -> "ImageBatch":
        """Alpha-composite ``overlay`` over every image; unlike the
        mutating ``Image.blend``, returns a new batch in self's dtype. f32
        on the device with the JAX package's device rounding (fused
        multiply-adds): equal to its ``ImageBatch.blend`` for the
        arithmetic modes, within 1 u8 step of it for the others."""
        if not isinstance(overlay, ImageBatch):
            raise TypeError("overlay must be an ImageBatch")
        if overlay._dev.shape[:3] != self._dev.shape[:3]:
            raise ValueError("overlay batch dimensions must match")
        mode = Blending.NORMAL if mode is None else Blending(mode)
        # XLA divides by a constant as a multiplication by its f32
        # reciprocal
        inv = np.float32(1.0 / 255.0)
        base = convert_u8_array(self._dev, self._space, "rgba") \
            .to(torch.float32) * inv
        over = convert_u8_array(overlay._dev.to(self._dev.device),
                                overlay._space, "rgba") \
            .to(torch.float32) * inv
        out = torch.clamp(blend_arrays(base, over, mode, fused=True), 0.0,
                          1.0)
        u8 = torch.floor(fma(out, torch.full((), 255.0, device=out.device),
                             torch.full((), 0.5, device=out.device))) \
            .to(torch.uint8)
        return self._wrap(convert_u8_array(u8, "rgba", self._space))

    def fill(self, color) -> "ImageBatch":
        """Every image becomes the constant ``color`` (the functional
        mirror of Image.fill)."""
        px = torch.tensor(_parse_color(color, self._space), dtype=torch.uint8,
                          device=self._dev.device)
        return self._wrap(px.expand(self._dev.shape).contiguous())

    def set_border(self, rect, color=None) -> "ImageBatch":
        """Fill everything outside ``rect`` with ``color`` (default zero),
        the functional mirror of Image.set_border."""
        from .rectangle import Rectangle

        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        if not isinstance(rect, Rectangle):
            raise TypeError("set_border requires a Rectangle or 4-tuple")
        px = (np.zeros(self.channels, dtype=np.uint8) if color is None
              else np.array(_parse_color(color, self._space),
                            dtype=np.uint8))
        out = torch.from_numpy(px).to(self._dev.device) \
            .expand(self._dev.shape).clone()
        clipped = rect.intersect(self.get_rectangle())
        if clipped is not None:
            l, t = int(clipped.left), int(clipped.top)
            r, b = int(clipped.right), int(clipped.bottom)
            out[:, t:b, l:r] = self._dev[:, t:b, l:r]
        return self._wrap(out)

    # -- histogram-based global ops ------------------------------------------

    def _hists(self, plane=None) -> torch.Tensor:
        """Per-image per-channel histograms [B, C, 256] int32 (a gray
        plane [B, H, W]: [B, 1, 256])."""
        arr = self._dev if plane is None else plane[..., None]
        return binary.histogram256_batch(arr)

    def histogram(self) -> torch.Tensor:
        """[B, C, 256] int32 histograms on the batch's device."""
        return self._hists()

    def equalize(self) -> "ImageBatch":
        return self._wrap(enhancement.equalize(self._dev))

    def autocontrast(self, cutoff: float = 0.0) -> "ImageBatch":
        cutoff = float(cutoff)
        if cutoff < 0 or cutoff >= 0.5:
            raise ValueError("cutoff must be in [0, 0.5)")
        return self._wrap(enhancement.autocontrast(self._dev, cutoff))

    def threshold_otsu(self):
        """Otsu per image -> (binary gray ImageBatch, [B] int32 numpy
        thresholds): exact histograms on the device, the f64 variance
        sweep on the host, the threshold applied on the device."""
        plane = self._gray_plane()
        thresholds = binary.otsu_from_hists(
            self._hists(plane)[:, 0].cpu().numpy())
        t = torch.from_numpy(thresholds).to(plane.device)
        out = (plane > t[:, None, None]).to(torch.uint8) * 255
        return self._wrap(out[..., None]), thresholds

    # -- metrics (one value an image) ------------------------------------------

    def _check_same(self, other):
        if not isinstance(other, ImageBatch):
            raise TypeError("expected an ImageBatch")
        if other._dev.shape != self._dev.shape:
            raise ValueError("batch shapes must match")
        if other._space != self._space:
            raise ValueError("batch dtypes must match")

    def _other(self, other) -> torch.Tensor:
        self._check_same(other)
        return other._dev.to(self._dev.device)

    def diff(self, other: "ImageBatch", threshold: float = 0.0,
             scale: float = 1.0, binary: bool = False,
             force_opaque: bool = False):
        """Per-pixel difference visualisation of every image -> (ImageBatch,
        [B] int32 counts of differing pixels) on the device; the same
        visualisation as the JAX package's ``ImageBatch.diff`` (the strict ``>
        threshold`` on integer differences is the integer cut ``>=
        floor(threshold) + 1``). The RunningStats summary stays
        ``Image.diff``'s."""
        b = self._other(other)
        cut = float(int(np.floor(float(threshold))) + 1)
        a = self._dev
        d = torch.abs(a.to(torch.float32) - b.to(torch.float32))
        differs = (d >= cut).any(dim=-1)
        counts = differs.sum(dim=(-2, -1), dtype=torch.int32)
        if binary:
            vis = (differs[..., None].to(torch.uint8) * 255).expand(a.shape)
        else:
            # the JAX package's compiled d * scale + 0.5 is one fused
            # multiply-add
            scl = torch.full((), float(np.float32(scale)), device=d.device)
            half = torch.full((), 0.5, device=d.device)
            vis = torch.clamp(torch.floor(fma(d, scl, half)), 0, 255) \
                .to(torch.uint8)
        vis = vis.contiguous()
        if force_opaque and a.shape[-1] == 4:
            vis[..., 3] = 255
        return self._wrap(vis), counts

    def psnr(self, other: "ImageBatch") -> torch.Tensor:
        """[B] PSNR in dB, f32 on the device (``Image.psnr``'s host f64 is
        the per-image oracle)."""
        return metrics.psnr(self._dev, self._other(other))

    def mean_pixel_error(self, other: "ImageBatch") -> torch.Tensor:
        """[B] mean absolute error in [0, 1], f32 on the device."""
        return metrics.mean_pixel_error(self._dev, self._other(other))

    def ssim(self, other: "ImageBatch") -> torch.Tensor:
        """[B] mean SSIM over valid 11x11 windows, f32 on the device."""
        b = self._other(other)
        if self.rows < 11 or self.cols < 11:
            raise ValueError("images must be at least 11x11 for SSIM")
        return metrics.ssim(self._dev, b)
