"""Hough line detection (reference: examples/src/hough_animation.zig)."""

import numpy as np

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal
from zignal_tpu_torch.ops.hough import HoughTransform


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    edges = img.canny(sigma=1.4, low=40, high=120)
    ht = HoughTransform(256)
    acc = ht.compute(edges)
    lines = ht.find_lines(acc, threshold=60)
    print(f"found {len(lines)} lines")
    canvas = img.canvas()
    for ln in lines[:12]:
        canvas.draw_line(ln.p1, ln.p2, (255, 0, 0))
    save(args, img, "hough_lines.png")
    norm = (acc * 255 / max(acc.max(), 1)).astype(np.uint8)[..., None]
    save(args, zignal.Image.from_numpy(norm, device=args.device)
         .apply_colormap(zignal.Colormap.inferno()), "hough_accumulator.png")


if __name__ == "__main__":
    main()
