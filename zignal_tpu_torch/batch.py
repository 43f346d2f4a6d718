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

The device is always the caller's choice (``device=``, or a mesh's);
nothing here picks one.

Sharding (``mesh=``, a ``DeviceMesh`` of ``parallel.make_mesh``; the
order of its axes is the contract). Every rank builds the batch from the
same global array and holds its shard as a plain tensor (``_dev``):

- a 1-D mesh ``(batch,)`` shards the images; every op runs on the rank's
  images with no collective, the ops that change the grid included;
- a 2-D mesh ``(batch, space)`` also shards the rows. Pointwise ops stay
  local; windowed ops run on halo-extended blocks (``parallel.spatial``);
  the clamped-window family sums exactly over ZERO halos; the histogram
  ops and the per-image reductions sum over the space axis; the ops that
  change the grid (or scan whole images) raise.

Values that leave the mesh come back whole on every rank: ``to_numpy``,
``__getitem__``, Otsu's thresholds; the per-image ones
(``histogram``, the metrics, ``resize_blur_oklab``) and ``device_array``
as a ``DTensor`` over the ranks' shards.
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
from .ops.tables import gaussian_kernel
from .ops.convolution import convolve2d, sobel_magnitude
from .ops.convolution import convolve_separable as convolve_separable_op
from .ops.convolution import gaussian_blur as gaussian_blur_op
from .ops.interpolation import resize as resize_op
from .parallel import _comm
from .parallel.spatial import crop_op, sharded_box_sums, ssim_sharded
from .pipeline import resize_blur_oklab as _chain
from .rectangle import Rectangle

__all__ = ["ImageBatch", "resize_blur_oklab_fn"]


def resize_blur_oklab_fn(rows: int, cols: int, sigma: float, method,
                         mesh=None):
    """The callable behind ImageBatch.resize_blur_oklab: the north-star
    chain with its parameters bound, on its input's device. With a 1-D
    ``mesh`` it takes the global batch (or a DTensor) and runs the chain on
    this rank's images (no collective), returning a DTensor."""
    chain = partial(_chain, out_rows=rows, out_cols=cols, sigma=sigma,
                    method=method)
    if mesh is None:
        return chain
    if len(mesh.mesh_dim_names) != 1:
        raise ValueError("resize_blur_oklab_fn takes a 1-D (batch,) mesh")
    dims = {mesh.mesh_dim_names[0]: 0}
    return lambda batch: _comm.as_global(
        chain(_comm.local_shard(batch, mesh, dims)), mesh, dims)


def _check_device(device, mesh) -> None:
    if device is None:
        return
    want, got = _comm.mesh_device(mesh), torch.device(device)
    if got.type != want.type or got.index not in (None, want.index):
        raise ValueError(f"device={got} differs from the mesh's device "
                         f"{want}")


def _check_split(n: int, parts: int, axis: str, what: str = "batch size"):
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by mesh axis '{axis}' "
                         f"({parts} devices)")


class ImageBatch:
    """A batch of same-shape images: u8 [B, H, W, C] on ``device``, or
    sharded over the ranks of ``mesh``."""

    __slots__ = ("_dev", "_space", "_mesh")

    def __init__(self, array, dtype=None, *, device=None, mesh=None,
                 _space=None):
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
        self._space = space
        self._mesh = None
        if mesh is None:
            if device is None:
                raise TypeError("ImageBatch needs device= (or mesh=)")
            self._dev = array.to(torch.device(device)).contiguous()
        else:
            _check_device(device, mesh)
            self._dev = self._place(array, mesh)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_numpy(cls, array, *, device=None, mesh=None) -> "ImageBatch":
        if not isinstance(array, np.ndarray):
            raise TypeError("from_numpy expects a numpy.ndarray")
        return cls(array, device=device, mesh=mesh)

    @classmethod
    def from_images(cls, images, *, device=None,
                    mesh=None) -> "ImageBatch":
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
        return cls(arr, device=device, mesh=mesh, _space=space)

    @classmethod
    def from_paths(cls, paths, shape=None, interpolation=None, *,
                   device=None, mesh=None, workers: int = 8) -> "ImageBatch":
        """Decode files in parallel (io_pipeline) into one batch on
        ``device`` (through pinned memory on the card), or sharded over
        ``mesh`` (every rank decodes the files and keeps its shard); pass
        ``shape`` to letterbox each image so the batch is uniform."""
        from .io_pipeline import load_image_batch

        if mesh is not None:
            _check_device(device, mesh)
            device = _comm.mesh_device(mesh)
        elif device is None:
            raise TypeError("from_paths needs device= (or mesh=)")
        return cls(load_image_batch(paths, shape=shape,
                                    interpolation=interpolation,
                                    workers=workers, device=device),
                   device=device, mesh=mesh)

    # -- mesh plumbing -------------------------------------------------------

    def _place(self, array, mesh):
        """This rank's shard of the global ``array`` on ``mesh``."""
        names = mesh.mesh_dim_names or ()
        if len(names) not in (1, 2):
            raise ValueError(
                "ImageBatch supports a 1-D (batch,) or 2-D (batch, space) "
                f"mesh; got axes {names}")
        _check_split(array.shape[0], _comm.axis_size(mesh, names[0]),
                     names[0])
        if len(names) == 2:
            _check_split(array.shape[1], _comm.axis_size(mesh, names[1]),
                         names[1], "image height")
        self._mesh = mesh
        return _comm.local_shard(array, mesh, self._dims())

    def with_mesh(self, mesh) -> "ImageBatch":
        """The same pixels placed on ``mesh`` (shards the images; a 2-D
        mesh also shards their rows)."""
        whole = self._dev if self._mesh is None \
            else _comm.full(self.device_array())
        return ImageBatch(whole, mesh=mesh, _space=self._space)

    @property
    def mesh(self):
        return self._mesh

    @property
    def sharding(self):
        """The placements of the batch over the mesh's axes (``Shard(0)``,
        and ``Shard(1)`` on a 2-D mesh), or None without a mesh."""
        return None if self._mesh is None else \
            tuple(self.device_array().placements)

    def _axes(self):
        """(batch axis, space axis or None) of the mesh."""
        names = self._mesh.mesh_dim_names
        return names[0], (names[1] if len(names) == 2 else None)

    def _dims(self) -> dict:
        b_ax, s_ax = self._axes()
        return {b_ax: 0} if s_ax is None else {b_ax: 0, s_ax: 1}

    def _space_sharded(self) -> bool:
        return self._mesh is not None and len(self._mesh.mesh_dim_names) == 2

    def _batch_only(self, op: str) -> None:
        if self._space_sharded():
            raise ValueError(
                f"{op} changes the image grid and requires batch-only "
                "sharding; construct the batch with a 1-D mesh (or "
                ".with_mesh(make_mesh(...)) to reshard explicitly)")

    def _per_image(self, values):
        """Per-image values ``[b, ...]`` of this rank's images as the global
        ``[B, ...]`` (a DTensor sharded over the batch axis on a mesh)."""
        if self._mesh is None:
            return values
        return _comm.as_global(values, self._mesh, {self._axes()[0]: 0})

    def _sum_space(self, t):
        """``t`` summed over the space axis (a no-op without one)."""
        if not self._space_sharded():
            return t
        return _comm.all_reduce(t, self._mesh, self._axes()[1])

    def _row_offset(self) -> int:
        """Global index of this rank's first row."""
        if not self._space_sharded():
            return 0
        return _comm.axis_rank(self._mesh, self._axes()[1]) * \
            self._dev.shape[1]

    # -- metadata / interop --------------------------------------------------

    @property
    def batch_size(self) -> int:
        if self._mesh is None:
            return self._dev.shape[0]
        return self._dev.shape[0] * _comm.axis_size(self._mesh,
                                                    self._axes()[0])

    @property
    def rows(self) -> int:
        if not self._space_sharded():
            return self._dev.shape[1]
        return self._dev.shape[1] * _comm.axis_size(self._mesh,
                                                    self._axes()[1])

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
        shard = ""
        if self._mesh is not None:
            shard = (f", mesh={'x'.join(map(str, self._mesh.shape))} "
                     f"{tuple(self._mesh.mesh_dim_names)}")
        return (f"ImageBatch({self.batch_size}x{self.rows}x{self.cols}, "
                f"dtype={self.dtype.__name__}{shard})")

    def to_numpy(self) -> np.ndarray:
        if self._mesh is not None:
            return _comm.full(self.device_array()).cpu().numpy()
        return self._dev.cpu().numpy()

    def device_array(self):
        """The underlying [B, H, W, C] tensor (no copy); on a mesh, a
        DTensor over the ranks' shards."""
        if self._mesh is None:
            return self._dev
        return _comm.as_global(self._dev, self._mesh, self._dims())

    def block_until_ready(self) -> "ImageBatch":
        if self._dev.device.type == "cuda":
            torch.cuda.current_stream(self._dev.device).synchronize()
        return self

    def __getitem__(self, i) -> Image:
        i = int(i)
        if not -self.batch_size <= i < self.batch_size:
            raise IndexError("batch index out of range")
        if self._mesh is not None:  # gathered whole on every rank
            return Image._from_host(self.to_numpy()[i].copy(), self._space,
                                    self.device)
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
        if self._mesh is not None and self._mesh.get_rank() != 0:
            return  # gathered on every rank, written by rank 0
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
        self._batch_only("resize")
        rows, cols = self._out_size(size)
        return self._wrap(resize_op(self._dev, rows, cols,
                                    Interpolation(method)))

    def letterbox(self, size, method: Interpolation = Interpolation.BILINEAR
                  ) -> "ImageBatch":
        """Resize into ``size`` keeping the aspect ratio, centred on a
        zero canvas."""
        self._batch_only("letterbox")
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
        device (not an ImageBatch — Oklab is float-typed); on a 1-D mesh
        a DTensor over the ranks' shards, each its own launch."""
        self._batch_only("resize_blur_oklab")
        rows, cols = self._out_size(size)
        if self.channels != 3:
            raise ValueError("resize_blur_oklab expects an Rgb batch")
        fn = resize_blur_oklab_fn(rows, cols, float(sigma),
                                  Interpolation(method))
        return self._per_image(fn(self._dev))

    def rotate(self, angle, method: Interpolation = Interpolation.BILINEAR,
               border: BorderMode = BorderMode.ZERO) -> "ImageBatch":
        """Rotate every image around its centre (radians, CCW), sized to
        fit; the coordinates are host f32, shared by the batch."""
        self._batch_only("rotate")
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

        self._batch_only("extract")
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
        self._batch_only("warp")
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
        self._batch_only("insert")
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
        src = self._other_local(source) if per_image else source._device()
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

        self._batch_only("flood_fill")
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

        self._batch_only("motion_blur")
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
        """A batch of ``arr`` (this rank's shard on a mesh) on this batch's
        device and mesh: in ``space``, else in this batch's space where the
        channel count is its own, else in the space of the count."""
        if space is None and arr.shape[-1] == self.channels:
            space = self._space
        out = ImageBatch(arr, device=self._dev.device, _space=space)
        out._mesh = self._mesh
        return out

    def _windowed(self, fn, radius: int, border, arr=None):
        """``fn`` of the batch (or of ``arr``, a ``[B, H, W, ...]`` view of
        it): on a 2-D mesh, of this rank's rows halo-extended along the
        space axis."""
        x = self._dev if arr is None else arr
        if not self._space_sharded() or radius == 0:
            return fn(x)
        return crop_op(x, fn, radius, BorderMode(border), self._mesh,
                       self._axes()[1], axis=1)

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
        return self._wrap(self._windowed(
            partial(gaussian_blur_op, sigma=sigma),
            len(gaussian_kernel(sigma)) // 2, BorderMode.MIRROR))

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
        return self._wrap(self._windowed(
            lambda x: convolve_separable_op(x, kxt, kyt, BorderMode(border)),
            len(kyt) // 2, border))

    def convolve(self, kernel, border=BorderMode.MIRROR) -> "ImageBatch":
        """Batched 2-D convolution (reference: image.zig:917)."""
        k = np.asarray(kernel, dtype=np.float32)
        if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
            raise ValueError("kernel must be 2-D with odd dimensions")
        return self._wrap(self._windowed(
            lambda x: convolve2d(x, k, BorderMode(border)), k.shape[0] // 2,
            border))

    def _order_stat(self, op, radius: int, border, *args) -> "ImageBatch":
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self._wrap(self._dev)
        return self._wrap(self._windowed(lambda x: op(x, radius, *args),
                                         radius, border))

    def median_blur(self, radius: int) -> "ImageBatch":
        return self._order_stat(order_stat.median_blur, radius,
                                BorderMode.MIRROR)

    def percentile_blur(self, radius: int, percentile: float,
                        border: BorderMode = BorderMode.MIRROR
                        ) -> "ImageBatch":
        percentile = float(percentile)
        if not 0.0 <= percentile <= 1.0:
            raise ValueError("percentile must be in [0, 1]")
        return self._order_stat(order_stat.percentile_blur, radius, border,
                                percentile, BorderMode(border))

    def min_blur(self, radius: int,
                 border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.min_blur, radius, border,
                                BorderMode(border))

    def max_blur(self, radius: int,
                 border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.max_blur, radius, border,
                                BorderMode(border))

    def midpoint_blur(self, radius: int,
                      border: BorderMode = BorderMode.MIRROR) -> "ImageBatch":
        return self._order_stat(order_stat.midpoint_blur, radius, border,
                                BorderMode(border))

    def alpha_trimmed_mean_blur(self, radius: int, trim_fraction: float,
                                border: BorderMode = BorderMode.MIRROR
                                ) -> "ImageBatch":
        trim_fraction = float(trim_fraction)
        if not np.isfinite(trim_fraction) or not 0.0 <= trim_fraction < 0.5:
            raise ValueError("trim_fraction must be in [0, 0.5)")
        return self._order_stat(order_stat.alpha_trimmed_mean_blur, radius,
                                border, trim_fraction, BorderMode(border))

    def sobel(self) -> "ImageBatch":
        return self._wrap(self._windowed(sobel_magnitude, 1,
                                         BorderMode.REPLICATE,
                                         arr=self._gray_f32())[..., None])

    def canny(self, sigma: float = 1.4, low: float = 50,
              high: float = 150) -> "ImageBatch":
        # hysteresis propagates labels over the whole image: no bounded
        # halo exists
        self._batch_only("canny")
        sigma, low, high = float(sigma), float(low), float(high)
        if sigma < 0 or low < 0 or high < 0 or low >= high:
            raise ValueError("need sigma >= 0 and 0 <= low < high")
        return self._wrap(edges.canny(self._gray_f32(), sigma, low,
                                      high)[..., None])

    def shen_castan(self, smooth: float = 0.9, window_size: int = 7,
                    high_ratio: float = 0.99, low_rel: float = 0.5,
                    hysteresis: bool = True, use_nms: bool = False
                    ) -> "ImageBatch":
        self._batch_only("shen_castan")
        out = edges.shen_castan(
            self._gray_f32(), smooth=float(smooth),
            window_size=int(window_size), high_ratio=float(high_ratio),
            low_rel=float(low_rel), hysteresis=bool(hysteresis),
            use_nms=bool(use_nms))
        return self._wrap(out[..., None])

    def _sharded_sums(self, x, radius: int):
        """Exact window sums, areas and the rounding form of ``x`` (this
        rank's rows, ``[b, h, W, C]``) on a 2-D mesh: ZERO halos along the
        space ring, areas from the global extent table."""
        sums, area = sharded_box_sums(x, self.rows, radius, self._mesh,
                                      self._axes()[1])
        return sums, area, integral.sums_fit_f32(self.rows, self.cols,
                                                 radius)

    def _clamped(self, op, from_sums, radius: int) -> "ImageBatch":
        radius = int(radius)
        if radius < 0:
            raise ValueError("radius must be non-negative")
        if radius == 0:
            return self._wrap(self._dev)
        if not self._space_sharded():
            return self._wrap(op(self._dev, radius))
        return self._wrap(from_sums(self._dev,
                                    *self._sharded_sums(self._dev, radius)))

    def box_blur(self, radius: int) -> "ImageBatch":
        return self._clamped(integral.box_blur,
                             lambda x, *sums: integral.box_from_sums(*sums),
                             radius)

    def sharpen(self, radius: int) -> "ImageBatch":
        return self._clamped(integral.sharpen, integral.sharpen_from_sums,
                             radius)

    def threshold_adaptive_mean(self, radius: int = 6, c: float = 5.0
                                ) -> "ImageBatch":
        """255 where the gray plane exceeds its clamped-window mean less
        ``c``, else 0 (a gray batch)."""
        if int(radius) <= 0:
            raise ValueError("radius must be positive")
        plane = self._gray_plane()
        if not self._space_sharded():
            out = binary.adaptive_mean_threshold(plane, int(radius), float(c))
        else:
            out = binary.adaptive_from_sums(
                plane, *self._sharded_sums(plane[..., None], int(radius)),
                float(c))
        return self._wrap(out[..., None])

    def _morph(self, op, kernel_size: int, iterations: int,
               parts=None) -> "ImageBatch":
        kernel_size = int(kernel_size)
        iterations = int(iterations)
        if kernel_size < 3 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >= 3")
        if iterations < 0:
            raise ValueError("iterations must be non-negative")
        if parts is not None and iterations and self._space_sharded():
            # a compound erode -> dilate (or the reverse) cannot ride one
            # halo: each pass re-applies the zero fill at the real image
            # edge, so run its two passes as separate windowed ops
            first, second = parts
            return self._morph(first, kernel_size, iterations) \
                ._morph(second, kernel_size, iterations)
        plane = self._gray_plane()
        if iterations:
            plane = self._windowed(
                lambda p: op(p, kernel_size, iterations),
                (kernel_size // 2) * iterations * (1 if parts is None else 2),
                BorderMode.ZERO, arr=plane)
        return self._wrap(plane[..., None])

    def dilate_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.dilate, kernel_size, iterations)

    def erode_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.erode, kernel_size, iterations)

    def open_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.open_morph, kernel_size, iterations,
                           (binary.erode, binary.dilate))

    def close_binary(self, kernel_size: int = 3, iterations: int = 1):
        return self._morph(binary.close_morph, kernel_size, iterations,
                           (binary.dilate, binary.erode))

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
        if colormap.min is None or colormap.max is None:
            # the auto range is each image's min and max: a reduction over
            # the space axis
            self._batch_only("apply_colormap with auto range")
        return self._wrap(colormap.apply_plane(self._gray_plane(),
                                               compiled=True), "rgb")

    def flip_left_right(self) -> "ImageBatch":
        return self._wrap(torch.flip(self._dev, (2,)))

    def flip_top_bottom(self) -> "ImageBatch":
        """Rows reversed; on a 2-D mesh rank s of the space ring trades its
        rows with rank n - 1 - s first."""
        x = self._dev
        if self._space_sharded():
            s_ax = self._axes()[1]
            n = _comm.axis_size(self._mesh, s_ax)
            i = _comm.axis_rank(self._mesh, s_ax)
            if n - 1 - i != i:
                got = torch.empty_like(x)
                peer = _comm.peer(self._mesh, s_ax, n - 1 - 2 * i)
                _comm.exchange([(x, peer, 0)], [(got, peer, 0)], self._mesh,
                               s_ax)
                x = got
        return self._wrap(torch.flip(x, (1,)))

    def blend(self, overlay: "ImageBatch", mode=None) -> "ImageBatch":
        """Alpha-composite ``overlay`` over every image; unlike the
        mutating ``Image.blend``, returns a new batch in self's dtype. f32
        on the device with the JAX package's device rounding (fused
        multiply-adds): equal to its ``ImageBatch.blend`` for the
        arithmetic modes, within 1 u8 step of it for the others."""
        if not isinstance(overlay, ImageBatch):
            raise TypeError("overlay must be an ImageBatch")
        if overlay._shape()[:3] != self._shape()[:3]:
            raise ValueError("overlay batch dimensions must match")
        mode = Blending.NORMAL if mode is None else Blending(mode)
        # XLA divides by a constant as a multiplication by its f32
        # reciprocal
        inv = np.float32(1.0 / 255.0)
        base = convert_u8_array(self._dev, self._space, "rgba") \
            .to(torch.float32) * inv
        over = convert_u8_array(self._other_local(overlay),
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
            off, h = self._row_offset(), self._dev.shape[1]
            l, r = int(clipped.left), int(clipped.right)
            t = min(max(int(clipped.top) - off, 0), h)
            b = min(max(int(clipped.bottom) - off, 0), h)
            out[:, t:b, l:r] = self._dev[:, t:b, l:r]
        return self._wrap(out)

    # -- histogram-based global ops ------------------------------------------

    def _hists(self, plane=None) -> torch.Tensor:
        """Per-image per-channel histograms [B, C, 256] int32 (a gray
        plane [B, H, W]: [B, 1, 256]) of this rank's images, summed over
        the space axis (integer counts: the same bits)."""
        arr = self._dev if plane is None else plane[..., None]
        return self._sum_space(binary.histogram256_batch(arr))

    def histogram(self):
        """[B, C, 256] int32 histograms on the batch's device."""
        return self._per_image(self._hists())

    def equalize(self) -> "ImageBatch":
        if not self._space_sharded():
            return self._wrap(enhancement.equalize(self._dev))
        return self._wrap(enhancement.equalize_from_hists(
            self._dev, self._hists(), self.rows * self.cols))

    def autocontrast(self, cutoff: float = 0.0) -> "ImageBatch":
        cutoff = float(cutoff)
        if cutoff < 0 or cutoff >= 0.5:
            raise ValueError("cutoff must be in [0, 0.5)")
        if not self._space_sharded():
            return self._wrap(enhancement.autocontrast(self._dev, cutoff))
        return self._wrap(enhancement.autocontrast_from_hists(
            self._dev, self._hists(),
            enhancement.cutoff_pixels(self.rows * self.cols, cutoff)))

    def threshold_otsu(self):
        """Otsu per image -> (binary gray ImageBatch, [B] int32 numpy
        thresholds): exact histograms on the device, the f64 variance
        sweep on the host, the threshold applied on the device."""
        plane = self._gray_plane()
        hists = self._hists(plane)[:, 0]
        if self._mesh is not None:  # every image's, on every rank
            hists = _comm.all_gather(hists, self._mesh, self._axes()[0], 0)
        thresholds = binary.otsu_from_hists(hists.cpu().numpy())
        b, first = plane.shape[0], 0
        if self._mesh is not None:
            first = _comm.axis_rank(self._mesh, self._axes()[0]) * b
        t = torch.from_numpy(thresholds[first:first + b]).to(plane.device)
        out = (plane > t[:, None, None]).to(torch.uint8) * 255
        return self._wrap(out[..., None]), thresholds

    # -- metrics (one value an image) ------------------------------------------

    def _shape(self) -> tuple:
        return (self.batch_size, self.rows, self.cols, self.channels)

    def _check_same(self, other):
        if not isinstance(other, ImageBatch):
            raise TypeError("expected an ImageBatch")
        if other._shape() != self._shape():
            raise ValueError("batch shapes must match")
        if other._space != self._space:
            raise ValueError("batch dtypes must match")

    def _other_local(self, other) -> torch.Tensor:
        """``other``'s pixels where this batch's shard lies: its shard on
        the same mesh, this rank's slice of an unsharded batch."""
        if other._mesh == self._mesh:
            return other._dev.to(self._dev.device)
        if other._mesh is not None:
            if self._mesh is not None:
                raise ValueError("the batches lie on different meshes")
            return _comm.full(other.device_array()).to(self._dev.device)
        return _comm.local_shard(other._dev, self._mesh, self._dims())

    def _other(self, other) -> torch.Tensor:
        self._check_same(other)
        return self._other_local(other)

    def _mean_over_space(self, values):
        """Per-image means of ``values`` ``[b, h, W, C]`` f32 (this rank's
        rows): the rank's f64 sums added over the space axis."""
        sums = self._sum_space(values.sum(dim=(-3, -2, -1),
                                          dtype=torch.float64))
        return (sums / float(self.rows * self.cols * self.channels)) \
            .to(torch.float32)

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
        return self._wrap(vis), self._per_image(self._sum_space(counts))

    def psnr(self, other: "ImageBatch") -> torch.Tensor:
        """[B] PSNR in dB, f32 on the device (``Image.psnr``'s host f64 is
        the per-image oracle)."""
        b = self._other(other)
        if not self._space_sharded():
            return self._per_image(metrics.psnr(self._dev, b))
        diff = self._dev.to(torch.float32) - b.to(torch.float32)
        return self._per_image(
            metrics.psnr_of_mse(self._mean_over_space(diff * diff)))

    def mean_pixel_error(self, other: "ImageBatch") -> torch.Tensor:
        """[B] mean absolute error in [0, 1], f32 on the device."""
        b = self._other(other)
        if not self._space_sharded():
            return self._per_image(metrics.mean_pixel_error(self._dev, b))
        diff = torch.abs(self._dev.to(torch.float32) - b.to(torch.float32))
        return self._per_image(self._mean_over_space(diff) / 255.0)

    def ssim(self, other: "ImageBatch") -> torch.Tensor:
        """[B] mean SSIM over valid 11x11 windows, f32 on the device."""
        b = self._other(other)
        if self.rows < 11 or self.cols < 11:
            raise ValueError("images must be at least 11x11 for SSIM")
        if not self._space_sharded():
            return self._per_image(metrics.ssim(self._dev, b))
        return self._per_image(ssim_sharded(self._dev, b, self.rows,
                                            self._mesh, self._axes()[1]))
