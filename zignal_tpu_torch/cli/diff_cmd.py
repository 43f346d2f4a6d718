"""`zignal-torch diff` (reference: src/cli/diff.zig; src/image/diff.zig),
copied from zignal_tpu/cli/diff_cmd.py."""

from __future__ import annotations

from .common import emit_display

description = "Compute the visual difference between two images."


def configure(parser):
    parser.add_argument("image1")
    parser.add_argument("image2")
    parser.add_argument("-o", "--output", help="Path to save the difference image")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="Scale factor for difference visibility")
    parser.add_argument("--threshold", type=int, default=0,
                        help="Ignore differences smaller than this (0-255)")
    parser.add_argument("--binary", action="store_true",
                        help="White for difference, black for match")
    parser.add_argument("-d", "--display", action="store_true")
    parser.add_argument("--width", type=int)
    parser.add_argument("--height", type=int)
    parser.add_argument("--protocol")


def run(args):
    from ..image import Image

    a = Image.load(args.image1, device=args.device)
    b = Image.load(args.image2, device=args.device)
    if (a.rows, a.cols) != (b.rows, b.cols):
        raise ValueError("images must have the same dimensions")
    if a.dtype is not b.dtype:
        b = b.convert(a.dtype)
    out, result = a.diff(b, threshold=args.threshold, scale=args.scale,
                         binary=args.binary)
    total = a.rows * a.cols
    print(f"max diff: {result.stats.max:.0f}  "
          f"mean diff: {result.stats.mean:.3f}  "
          f"differing pixels: {result.diff_count / total * 100:.2f}%")
    if args.output:
        out.save(args.output)
    if args.display or not args.output:
        emit_display(out, args.protocol, args.width, args.height)
    return 0
