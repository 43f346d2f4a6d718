"""Canvas: drawing on an Image (reference: src/canvas/Canvas.zig).

Rasterization is vectorized coverage math over each primitive's bounding
box (the SURVEY "coverage/SDF rasterization" formulation): FAST mode
thresholds the signed-distance coverage to hard edges, SOFT mode keeps
the fractional coverage for anti-aliasing. Strokes and fills composite
through the blending-aware pixel store (reference: image.zig
assignPixel:67-94).

Copied from zignal_tpu/canvas.py: host numpy on the Image's host array,
whatever the Image's device. ``draw_image`` blends through
``blending.blend_arrays`` on CPU tensors, one rounding an operation, as
the JAX package's numpy blend does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .blending import Blending, blend_arrays
from .enums import DrawMode
from .image import Image, _parse_color
from .rectangle import Rectangle

__all__ = ["Canvas"]


def _pt(p):
    return float(p[0]), float(p[1])


class Canvas:
    """Draws into the wrapped Image in place (reference: Canvas.zig:27)."""

    def __init__(self, image: Image):
        if not isinstance(image, Image):
            raise TypeError("Canvas wraps an Image")
        self._image = image

    @property
    def image(self) -> Image:
        return self._image

    @property
    def rows(self) -> int:
        return self._image.rows

    @property
    def cols(self) -> int:
        return self._image.cols

    # -- pixel store --------------------------------------------------------

    def _composite(self, coverage: np.ndarray, color, bbox, binary=False):
        """Blend `color` into the image weighted by [h, w] coverage in
        the bbox region (x0, y0). `binary` promises coverage is 0/1
        (FAST mode), enabling the masked-store fast path."""
        x0, y0 = bbox
        arr = self._image._host()
        h, w = coverage.shape
        H, W = arr.shape[:2]
        cx0, cy0 = max(0, -x0), max(0, -y0)
        cx1 = min(w, W - x0)
        cy1 = min(h, H - y0)
        if cx1 <= cx0 or cy1 <= cy0:
            return
        cov = coverage[cy0:cy1, cx0:cx1]
        region = arr[y0 + cy0:y0 + cy1, x0 + cx0:x0 + cx1]

        rgba = _parse_color(color, "rgba")
        if binary and rgba[3] == 255 and self._image._space != "gray" \
                and region.shape[-1] == 3:
            # FAST mode + opaque color: coverage is exactly 0/1, so the
            # float blend reduces to a masked store (4-5x cheaper; the
            # blend below yields bit-identical results on this input)
            region[cov != 0] = np.asarray(rgba[:3], dtype=np.uint8)
            return
        alpha = rgba[3] / 255.0
        eff = cov * alpha
        if self._image._space == "gray":
            from .color import _scalar as _sc

            target = float(_sc.convert_u8("rgba", "gray", rgba)[0])
            vals = region[..., 0].astype(np.float32)
            out = vals * (1 - eff) + target * eff
            region[..., 0] = np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
            return
        n = region.shape[-1]
        target = np.array(rgba[:n], dtype=np.float32)
        vals = region.astype(np.float32)
        if n == 4:
            # alpha compositing onto RGBA
            src_a = eff[..., None]
            dst_a = vals[..., 3:4] / 255.0
            out_a = src_a + dst_a * (1 - src_a)
            safe = np.maximum(out_a, 1e-6)
            out_rgb = (target[:3] * src_a + vals[..., :3] * dst_a * (1 - src_a)) / safe
            out = np.concatenate([out_rgb, out_a * 255.0], axis=-1)
        else:
            out = vals * (1 - eff[..., None]) + target * eff[..., None]
        region[:] = np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)

    def _grid(self, x0, y0, x1, y1):
        """Pixel-center coordinate grids for an integer bbox."""
        xs = np.arange(x0, x1, dtype=np.float32)
        ys = np.arange(y0, y1, dtype=np.float32)
        return np.meshgrid(xs, ys)

    @staticmethod
    def _coverage(dist, mode):
        """Signed distance (negative inside) -> coverage."""
        if DrawMode(mode) == DrawMode.SOFT:
            return np.clip(0.5 - dist, 0.0, 1.0)
        return (dist <= 0).astype(np.float32)

    # -- fills --------------------------------------------------------------

    def fill(self, color):
        self._image.fill(color)

    def _sdf_draw(self, bx0, by0, bx1, by1, dist_fn, color, mode,
                  prune=None, tile: int = 96):
        """Evaluate the signed-distance field and composite. Large
        bounding boxes are PARTITIONED into tiles and `prune(cx, cy)`
        (a conservative lower bound on the ink distance from the tile
        center, margins included by the caller) skips empty tiles —
        every painted pixel sees the identical dist value, so this is
        exact; zero-coverage pixels in skipped tiles are left untouched.
        A 512-px diagonal line drops from ~262k to ~40k evaluated px."""
        binary = DrawMode(mode) != DrawMode.SOFT
        # open (1, w) / (h, 1) grids: dist_fns that mix x and y broadcast to
        # the full field without materializing two [h, w] meshes per tile;
        # the explicit broadcast_to below enforces full shape even for a
        # dist_fn that depends on a single axis
        def open_grid(x0, y0, x1, y1):
            return (np.arange(x0, x1, dtype=np.float32)[None, :],
                    np.arange(y0, y1, dtype=np.float32)[:, None])

        def field(x0, y0, x1, y1):
            xg, yg = open_grid(x0, y0, x1, y1)
            return np.broadcast_to(np.asarray(dist_fn(xg, yg),
                                              dtype=np.float32),
                                   (y1 - y0, x1 - x0))

        if (bx1 - bx0) * (by1 - by0) <= (1 << 14) or prune is None:
            self._composite(self._coverage(field(bx0, by0, bx1, by1), mode),
                            color, (bx0, by0), binary=binary)
            return
        margin = tile * math.sqrt(0.5) + 1.5
        for ty in range(by0, by1, tile):
            for tx in range(bx0, bx1, tile):
                ty1 = min(ty + tile, by1)
                tx1 = min(tx + tile, bx1)
                if prune((tx + tx1) / 2.0, (ty + ty1) / 2.0) > margin:
                    continue
                self._composite(self._coverage(field(tx, ty, tx1, ty1), mode),
                                color, (tx, ty), binary=binary)

    # -- lines --------------------------------------------------------------

    def draw_line(self, p1, p2, color, width: int = 1,
                  mode: DrawMode = DrawMode.FAST):
        x1, y1 = _pt(p1)
        x2, y2 = _pt(p2)
        half = max(float(width), 1.0) / 2.0
        pad = int(math.ceil(half)) + 1
        bx0 = int(math.floor(min(x1, x2))) - pad
        by0 = int(math.floor(min(y1, y2))) - pad
        bx1 = int(math.ceil(max(x1, x2))) + pad + 1
        by1 = int(math.ceil(max(y1, y2))) + pad + 1
        dx, dy = x2 - x1, y2 - y1
        len_sq = dx * dx + dy * dy

        def dist_fn(xg, yg):
            if len_sq == 0:
                return np.hypot(xg - x1, yg - y1) - half
            t = np.clip(((xg - x1) * dx + (yg - y1) * dy) / len_sq, 0.0, 1.0)
            return np.hypot(xg - (x1 + t * dx), yg - (y1 + t * dy)) - half

        def prune(cx, cy):
            if len_sq == 0:
                return math.hypot(cx - x1, cy - y1) - half
            t = min(max(((cx - x1) * dx + (cy - y1) * dy) / len_sq, 0.0), 1.0)
            return math.hypot(cx - (x1 + t * dx), cy - (y1 + t * dy)) - half

        self._sdf_draw(bx0, by0, bx1, by1, dist_fn, color, mode, prune)

    # -- rectangles ---------------------------------------------------------

    def _rect(self, rect) -> Rectangle:
        if isinstance(rect, (tuple, list)):
            return Rectangle(*rect)
        if isinstance(rect, Rectangle):
            return rect
        raise TypeError("expected a Rectangle or (l, t, r, b) tuple")

    def draw_rectangle(self, rect, color, width: int = 1,
                       mode: DrawMode = DrawMode.FAST):
        r = self._rect(rect)
        corners = [(r.left, r.top), (r.right, r.top),
                   (r.right, r.bottom), (r.left, r.bottom)]
        for i in range(4):
            self.draw_line(corners[i], corners[(i + 1) % 4], color, width, mode)

    def fill_rectangle(self, rect, color, mode: DrawMode = DrawMode.FAST):
        r = self._rect(rect)
        bx0, by0 = int(math.floor(r.left)) - 1, int(math.floor(r.top)) - 1
        bx1, by1 = int(math.ceil(r.right)) + 1, int(math.ceil(r.bottom)) + 1
        xg, yg = self._grid(bx0, by0, bx1, by1)
        dist = np.maximum.reduce([
            r.left - 0.5 - xg, xg - (r.right - 0.5),
            r.top - 0.5 - yg, yg - (r.bottom - 0.5),
        ])
        self._composite(self._coverage(dist, mode), color, (bx0, by0))

    # -- circles / arcs -----------------------------------------------------

    def draw_circle(self, center, radius, color, width: int = 1,
                    mode: DrawMode = DrawMode.FAST):
        cx, cy = _pt(center)
        radius = float(radius)
        half = max(float(width), 1.0) / 2.0
        pad = int(math.ceil(radius + half)) + 1
        bx0, by0 = int(cx) - pad, int(cy) - pad
        bx1, by1 = int(cx) + pad + 1, int(cy) + pad + 1

        def dist_fn(xg, yg):
            return np.abs(np.hypot(xg - cx, yg - cy) - radius) - half

        def prune(px, py):
            return abs(math.hypot(px - cx, py - cy) - radius) - half

        self._sdf_draw(bx0, by0, bx1, by1, dist_fn, color, mode, prune)

    def fill_circle(self, center, radius, color, mode: DrawMode = DrawMode.FAST):
        cx, cy = _pt(center)
        radius = float(radius)
        pad = int(math.ceil(radius)) + 1
        bx0, by0 = int(cx) - pad, int(cy) - pad
        bx1, by1 = int(cx) + pad + 1, int(cy) + pad + 1

        def dist_fn(xg, yg):
            return np.hypot(xg - cx, yg - cy) - radius

        def prune(px, py):
            return math.hypot(px - cx, py - cy) - radius

        self._sdf_draw(bx0, by0, bx1, by1, dist_fn, color, mode, prune)

    def _arc_mask(self, xg, yg, cx, cy, start, end):
        ang = np.arctan2(yg - cy, xg - cx)
        start = math.remainder(start, math.tau)
        end = math.remainder(end, math.tau)
        if end >= start:
            return (ang >= start) & (ang <= end)
        return (ang >= start) | (ang <= end)

    def draw_arc(self, center, radius, start_angle, end_angle, color,
                 width: int = 1, mode: DrawMode = DrawMode.FAST):
        cx, cy = _pt(center)
        radius = float(radius)
        half = max(float(width), 1.0) / 2.0
        pad = int(math.ceil(radius + half)) + 1
        bx0, by0 = int(cx) - pad, int(cy) - pad
        bx1, by1 = int(cx) + pad + 1, int(cy) + pad + 1
        xg, yg = self._grid(bx0, by0, bx1, by1)
        dist = np.abs(np.hypot(xg - cx, yg - cy) - radius) - half
        cov = self._coverage(dist, mode)
        cov = cov * self._arc_mask(xg, yg, cx, cy, float(start_angle),
                                   float(end_angle))
        self._composite(cov, color, (bx0, by0))

    def fill_arc(self, center, radius, start_angle, end_angle, color,
                 mode: DrawMode = DrawMode.FAST):
        cx, cy = _pt(center)
        radius = float(radius)
        pad = int(math.ceil(radius)) + 1
        bx0, by0 = int(cx) - pad, int(cy) - pad
        bx1, by1 = int(cx) + pad + 1, int(cy) + pad + 1
        xg, yg = self._grid(bx0, by0, bx1, by1)
        dist = np.hypot(xg - cx, yg - cy) - radius
        cov = self._coverage(dist, mode)
        cov = cov * self._arc_mask(xg, yg, cx, cy, float(start_angle),
                                   float(end_angle))
        self._composite(cov, color, (bx0, by0))

    # -- polygons ------------------------------------------------------------

    def draw_polygon(self, points, color, width: int = 1,
                     mode: DrawMode = DrawMode.FAST):
        pts = [_pt(p) for p in points]
        for i in range(len(pts)):
            self.draw_line(pts[i], pts[(i + 1) % len(pts)], color, width, mode)

    def fill_polygon(self, points, color, mode: DrawMode = DrawMode.FAST):
        pts = np.asarray([_pt(p) for p in points], dtype=np.float64)
        if len(pts) < 3:
            raise ValueError("polygon needs at least 3 points")
        bx0 = int(math.floor(pts[:, 0].min())) - 1
        by0 = int(math.floor(pts[:, 1].min())) - 1
        bx1 = int(math.ceil(pts[:, 0].max())) + 2
        by1 = int(math.ceil(pts[:, 1].max())) + 2
        xg, yg = self._grid(bx0, by0, bx1, by1)
        if DrawMode(mode) == DrawMode.SOFT:
            cov = self._polygon_coverage_ss(pts, bx0, by0, bx1, by1)
        else:
            cov = self._polygon_inside(pts, xg, yg).astype(np.float32)
        self._composite(cov, color, (bx0, by0))

    @staticmethod
    def _polygon_inside(pts, xg, yg):
        """Even-odd crossing test, vectorized over the pixel grid."""
        inside = np.zeros(xg.shape, dtype=bool)
        n = len(pts)
        for i in range(n):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % n]
            crosses = ((y1 > yg) != (y2 > yg))
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = x1 + (yg - y1) * (x2 - x1) / (y2 - y1 + 1e-30)
            inside ^= crosses & (xg < xint)
        return inside

    def _polygon_coverage_ss(self, pts, bx0, by0, bx1, by1, ss=4):
        """Anti-aliased coverage via ss x ss supersampling."""
        xs = (np.arange((bx1 - bx0) * ss) + 0.5) / ss + bx0 - 0.5
        ys = (np.arange((by1 - by0) * ss) + 0.5) / ss + by0 - 0.5
        xg, yg = np.meshgrid(xs.astype(np.float64), ys.astype(np.float64))
        inside = self._polygon_inside(pts, xg, yg)
        h, w = by1 - by0, bx1 - bx0
        return inside.reshape(h, ss, w, ss).mean(axis=(1, 3)).astype(np.float32)

    # -- beziers / splines ---------------------------------------------------

    @staticmethod
    def _flatten_quadratic(p0, p1, p2, tolerance=0.25):
        pts = []
        n = 24
        for i in range(n + 1):
            t = i / n
            mt = 1 - t
            x = mt * mt * p0[0] + 2 * mt * t * p1[0] + t * t * p2[0]
            y = mt * mt * p0[1] + 2 * mt * t * p1[1] + t * t * p2[1]
            pts.append((x, y))
        return pts

    @staticmethod
    def _flatten_cubic(p0, p1, p2, p3, tolerance=0.25):
        pts = []
        n = 32
        for i in range(n + 1):
            t = i / n
            mt = 1 - t
            x = (mt**3 * p0[0] + 3 * mt * mt * t * p1[0]
                 + 3 * mt * t * t * p2[0] + t**3 * p3[0])
            y = (mt**3 * p0[1] + 3 * mt * mt * t * p1[1]
                 + 3 * mt * t * t * p2[1] + t**3 * p3[1])
            pts.append((x, y))
        return pts

    def draw_quadratic_bezier(self, p0, p1, p2, color, width: int = 1,
                              mode: DrawMode = DrawMode.FAST):
        pts = self._flatten_quadratic(_pt(p0), _pt(p1), _pt(p2))
        for a, b in zip(pts, pts[1:]):
            self.draw_line(a, b, color, width, mode)

    def draw_cubic_bezier(self, p0, p1, p2, p3, color, width: int = 1,
                          mode: DrawMode = DrawMode.FAST):
        pts = self._flatten_cubic(_pt(p0), _pt(p1), _pt(p2), _pt(p3))
        for a, b in zip(pts, pts[1:]):
            self.draw_line(a, b, color, width, mode)

    @staticmethod
    def _catmull_rom_points(points, tension=0.5, samples=16, closed=True):
        """Catmull-Rom spline through the points (Canvas.zig spline
        polygons)."""
        pts = [(float(p[0]), float(p[1])) for p in points]
        n = len(pts)
        out = []
        seg_count = n if closed else n - 1
        for i in range(seg_count):
            p0 = pts[(i - 1) % n]
            p1 = pts[i]
            p2 = pts[(i + 1) % n]
            p3 = pts[(i + 2) % n]
            for j in range(samples):
                t = j / samples
                t2, t3 = t * t, t * t * t
                s = tension
                x = (p1[0] + (-s * p0[0] + s * p2[0]) * t
                     + (2 * s * p0[0] + (s - 3) * p1[0] + (3 - 2 * s) * p2[0] - s * p3[0]) * t2
                     + (-s * p0[0] + (2 - s) * p1[0] + (s - 2) * p2[0] + s * p3[0]) * t3)
                y = (p1[1] + (-s * p0[1] + s * p2[1]) * t
                     + (2 * s * p0[1] + (s - 3) * p1[1] + (3 - 2 * s) * p2[1] - s * p3[1]) * t2
                     + (-s * p0[1] + (2 - s) * p1[1] + (s - 2) * p2[1] + s * p3[1]) * t3)
                out.append((x, y))
        if not closed:
            out.append(pts[-1])
        return out

    def draw_spline_polygon(self, points, color, width: int = 1,
                            tension: float = 0.5,
                            mode: DrawMode = DrawMode.FAST):
        curve = self._catmull_rom_points(points, tension)
        for a, b in zip(curve, curve[1:] + curve[:1]):
            self.draw_line(a, b, color, width, mode)

    def fill_spline_polygon(self, points, color, tension: float = 0.5,
                            mode: DrawMode = DrawMode.FAST):
        curve = self._catmull_rom_points(points, tension)
        self.fill_polygon(curve, color, mode)

    # -- text ----------------------------------------------------------------

    def draw_text(self, text, position, color, font=None, scale: float = 1.0,
                  mode: DrawMode = DrawMode.FAST):
        from .font import BitmapFont

        if font is None:
            font = BitmapFont.font8x8()
        if not isinstance(font, BitmapFont):
            raise TypeError("font must be a BitmapFont")
        x0, y0 = _pt(position)
        iscale = max(1, int(round(scale)))
        mask = font.render_mask(str(text), iscale)
        if scale != iscale:
            # fractional scales: nearest-resample the mask
            h = max(1, int(round(mask.shape[0] * scale / iscale)))
            w = max(1, int(round(mask.shape[1] * scale / iscale)))
            ys = np.clip((np.arange(h) / scale * iscale).astype(int), 0,
                         mask.shape[0] - 1)
            xs = np.clip((np.arange(w) / scale * iscale).astype(int), 0,
                         mask.shape[1] - 1)
            mask = mask[ys][:, xs]
        self._composite(mask.astype(np.float32), color,
                        (int(round(x0)), int(round(y0))))

    # -- image compositing ---------------------------------------------------

    def draw_image(self, image, position, source_rect=None,
                   blend_mode: Blending = Blending.NORMAL):
        if not isinstance(image, Image):
            raise TypeError("draw_image expects an Image")
        x0, y0 = _pt(position)
        src = image._host()
        if source_rect is not None:
            r = self._rect(source_rect)
            src = src[int(r.top):int(r.bottom), int(r.left):int(r.right)]
        from .image import _convert_array_u8

        src_rgba = _convert_array_u8(np.ascontiguousarray(src),
                                     image._space, "rgba")
        dst = self._image._host()
        H, W = dst.shape[:2]
        ix, iy = int(round(x0)), int(round(y0))
        h, w = src_rgba.shape[:2]
        sx0, sy0 = max(0, -ix), max(0, -iy)
        sx1, sy1 = min(w, W - ix), min(h, H - iy)
        if sx1 <= sx0 or sy1 <= sy0:
            return
        sub = src_rgba[sy0:sy1, sx0:sx1]
        region = dst[iy + sy0:iy + sy1, ix + sx0:ix + sx1]
        base = _convert_array_u8(np.ascontiguousarray(region),
                                 self._image._space, "rgba")
        mode = Blending(blend_mode) if blend_mode is not None else Blending.NORMAL
        if mode == Blending.NONE:
            out = sub
        else:
            f = np.float32
            blended = blend_arrays(torch.from_numpy(base.astype(f) / f(255.0)),
                                   torch.from_numpy(sub.astype(f) / f(255.0)),
                                   mode, fused=False).numpy()
            out = np.clip(np.floor(blended * 255.0 + 0.5), 0, 255).astype(np.uint8)
        region[:] = _convert_array_u8(out, "rgba", self._image._space)

