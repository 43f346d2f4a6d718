"""ImageBatch — a batch of same-shape u8 images ``[B, H, W, C]`` held as a
torch tensor on one explicit device, the counterpart of
zignal_tpu/batch.py as far as resize and letterbox, the resize -> blur ->
Oklab path, the windowed filters (convolutions, clamped-window and
order-statistic blurs, morphology), the edge detectors, colour conversion
among gray/rgb/rgba and the histogram and threshold ops need it. The ops
take ``[B, H, W, C]`` (or the ``[B, H, W]`` gray plane) directly: nothing
is mapped image by image.

The device is always the caller's choice (``device=``); nothing here
picks one. There is no mesh yet (ROADMAP item 15).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .color._array import convert_u8_array, rgb_to_gray_u8
from .enums import BorderMode, Interpolation
from .ops import binary, edges, enhancement, integral, order_stat
from .ops.convolution import convolve2d, sobel_magnitude
from .ops.convolution import convolve_separable as convolve_separable_op
from .ops.convolution import gaussian_blur as gaussian_blur_op
from .ops.interpolation import resize as resize_op
from .pipeline import resize_blur_oklab as _chain

__all__ = ["ImageBatch", "resize_blur_oklab_fn"]

_CHANNELS_SPACE = {1: "gray", 3: "rgb", 4: "rgba"}  # the count is the space
_CHANNELS = tuple(_CHANNELS_SPACE)


def resize_blur_oklab_fn(rows: int, cols: int, sigma: float, method):
    """The callable behind ImageBatch.resize_blur_oklab: the north-star
    chain with its parameters bound. It runs on its input's device."""
    return partial(_chain, out_rows=rows, out_cols=cols, sigma=sigma,
                   method=method)


class ImageBatch:
    """A batch of same-shape images: u8 [B, H, W, C] on ``device``."""

    __slots__ = ("_dev",)

    def __init__(self, array, *, device):
        if isinstance(array, np.ndarray):
            is_u8 = array.dtype == np.uint8
        elif isinstance(array, torch.Tensor):
            is_u8 = array.dtype == torch.uint8
        else:
            raise TypeError("ImageBatch expects a numpy array or a torch "
                            "tensor")
        if array.ndim != 4:
            raise ValueError("ImageBatch expects a [B, H, W, C] array")
        if array.shape[-1] not in _CHANNELS:
            raise ValueError("channel count must be 1, 3, or 4")
        if not is_u8:
            raise TypeError("ImageBatch requires uint8 pixel data")
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        self._dev = array.to(torch.device(device)).contiguous()

    @classmethod
    def from_numpy(cls, array, *, device) -> "ImageBatch":
        if not isinstance(array, np.ndarray):
            raise TypeError("from_numpy expects a numpy.ndarray")
        return cls(array, device=device)

    # -- metadata / interop --------------------------------------------------

    @property
    def rows(self) -> int:
        return self._dev.shape[1]

    @property
    def cols(self) -> int:
        return self._dev.shape[2]

    @property
    def channels(self) -> int:
        return self._dev.shape[3]

    def to_numpy(self) -> np.ndarray:
        return self._dev.cpu().numpy()

    def device_array(self) -> torch.Tensor:
        """The underlying [B, H, W, C] tensor (no copy)."""
        return self._dev

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

    # -- windowed filters ----------------------------------------------------

    def _wrap(self, arr) -> "ImageBatch":
        return ImageBatch(arr, device=self._dev.device)

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

    # -- colour --------------------------------------------------------------

    def convert(self, space: str) -> "ImageBatch":
        """Colour conversion among ``"gray"``, ``"rgb"`` and ``"rgba"``
        (the spaces an ImageBatch holds), exact u8 fixed point."""
        if space not in _CHANNELS_SPACE.values():
            raise TypeError("space must be 'gray', 'rgb', or 'rgba'")
        src = _CHANNELS_SPACE[self.channels]
        if space == src:
            return self._wrap(self._dev)
        return self._wrap(convert_u8_array(self._dev, src, space))

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
