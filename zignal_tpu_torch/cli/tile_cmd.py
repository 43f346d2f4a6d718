"""`zignal-torch tile` (reference: src/cli/tile.zig): grid montage via
insert, copied from zignal_tpu/cli/tile_cmd.py; each insert runs on the
device."""

from __future__ import annotations

import math

from .common import emit_display

description = "Combine multiple images into a single tiled image."


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--mode",
                        choices=["square", "horizontal", "vertical", "grid",
                                 "factors"],
                        default="grid", help="Layout mode")
    parser.add_argument("--rows", type=int, help="Rows (grid mode)")
    parser.add_argument("--cols", type=int, help="Columns (grid mode)")
    parser.add_argument("--width", type=int, help="Force cell width")
    parser.add_argument("--height", type=int, help="Force cell height")
    parser.add_argument("-o", "--output", help="Output file path")
    parser.add_argument("-d", "--display", action="store_true")
    parser.add_argument("--protocol")


def run(args):
    from ..image import Image
    from ..rectangle import Rectangle

    images = [Image.load(p, device=args.device) for p in args.images]
    n = len(images)
    cell_w = args.width or images[0].cols
    cell_h = args.height or images[0].rows

    if args.mode == "horizontal":
        rows, cols = 1, n
    elif args.mode == "vertical":
        rows, cols = n, 1
    elif args.mode == "square":
        cols = math.ceil(math.sqrt(n))
        rows = math.ceil(n / cols)
    elif args.mode == "factors":
        # largest factor pair closest to square (reference: tile.zig:98-109)
        best_r = 1
        i = 1
        while i * i <= n:
            if n % i == 0:
                best_r = i
            i += 1
        rows, cols = best_r, n // best_r
    else:
        if args.rows and args.cols:
            rows, cols = args.rows, args.cols
        elif args.cols:
            cols = args.cols
            rows = math.ceil(n / cols)
        elif args.rows:
            rows = args.rows
            cols = math.ceil(n / rows)
        else:
            cols = math.ceil(math.sqrt(n))
            rows = math.ceil(n / cols)

    canvas = Image(rows * cell_h, cols * cell_w, (0, 0, 0),
                   dtype=images[0].dtype, device=args.device)
    for i, img in enumerate(images[: rows * cols]):
        r, c = divmod(i, cols)
        rect = Rectangle(c * cell_w, r * cell_h,
                         (c + 1) * cell_w, (r + 1) * cell_h)
        canvas.insert(img, rect)
    if args.output:
        canvas.save(args.output)
    if args.display or not args.output:
        emit_display(canvas, args.protocol, None, None)
    return 0
