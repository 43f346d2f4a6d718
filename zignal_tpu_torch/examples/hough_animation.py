"""Animated Hough transform of a rotating line (reference:
examples/src/hough_animation.zig). Each frame draws a rotating line,
computes the Hough accumulator over a sub-box, finds the strongest line,
overlays it (red) and the box (green), and renders the accumulator
through viridis; the frames are written as an animated GIF."""

import math
import os

import numpy as np

from zignal_tpu_torch.codecs.gif import encode_animated
from zignal_tpu_torch.examples._common import parse, zignal
from zignal_tpu_torch.ops.hough import HoughTransform

SIZE = 200
HOUGH_SIZE = 128
OFFSET = 25


def rotate_point(center, p, angle):
    s, c = math.sin(angle), math.cos(angle)
    x, y = p[0] - center[0], p[1] - center[1]
    return (center[0] + x * c - y * s, center[1] + x * s + y * c)


def render(hough, time_step: float, device):
    angle1 = time_step * math.pi / 13.0
    angle2 = time_step * math.pi / 40.0
    center = (SIZE / 2.0, SIZE / 2.0)
    arc = rotate_point(center, (center[0] + SIZE * 0.22, center[1]), angle1)
    left = rotate_point(arc, (arc[0] + 500.0, arc[1]), angle2)
    right = rotate_point(arc, (arc[0] - 500.0, arc[1]), angle2)

    img = zignal.Image(SIZE, SIZE, 0, dtype=zignal.Gray, device=device)
    img.canvas().draw_line(left, right, 255, 5, mode=zignal.DrawMode.SOFT)
    crop = img.to_numpy()[OFFSET:OFFSET + HOUGH_SIZE,
                          OFFSET:OFFSET + HOUGH_SIZE, 0]
    acc = hough.compute(crop, device=device)
    max_val = int(acc.max())

    out = img.convert(zignal.Rgb)
    canvas = out.canvas()
    if max_val > 0:
        lines = hough.find_lines(acc, threshold=max(1, max_val // 2),
                                 angle_nms_thresh=5.0,
                                 radius_nms_thresh=5.0)
        if lines:
            ln = lines[0]
            canvas.draw_line((ln.p1[0] + OFFSET, ln.p1[1] + OFFSET),
                             (ln.p2[0] + OFFSET, ln.p2[1] + OFFSET),
                             (255, 0, 0), 3, mode=zignal.DrawMode.SOFT)
    canvas.draw_rectangle((OFFSET, OFFSET, OFFSET + HOUGH_SIZE,
                           OFFSET + HOUGH_SIZE), (0, 255, 0), 1)
    norm = np.zeros_like(acc, dtype=np.uint8) if max_val == 0 else \
        (acc.astype(np.float64) * 255.0 / max_val).astype(np.uint8)
    acc_img = zignal.Image.from_numpy(norm[..., None], device=device) \
        .apply_colormap(zignal.Colormap.viridis())
    return out, acc_img


def main(argv=None, n_frames: int = 12):
    args = parse(argv, __doc__)
    hough = HoughTransform(HOUGH_SIZE)
    frames = []
    for i in range(n_frames):
        out, acc_img = render(hough, float(i), args.device)
        h = max(out.rows, acc_img.rows)
        composite = np.zeros((h, out.cols + acc_img.cols, 3), np.uint8)
        composite[:out.rows, :out.cols] = out.to_numpy()
        composite[:acc_img.rows, out.cols:] = acc_img.to_numpy()
        frames.append(composite)
    data = encode_animated(frames, delays_cs=[12] * len(frames),
                           loop_count=0)
    path = os.path.join(args.out, "hough_animation.gif")
    with open(path, "wb") as f:
        f.write(data)
    print(f"wrote {path} ({len(frames)} frames, {len(data)} bytes)")


if __name__ == "__main__":
    main()
