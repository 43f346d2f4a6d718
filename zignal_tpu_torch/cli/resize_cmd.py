"""`zignal-torch resize` (reference: src/cli/resize.zig), copied from
zignal_tpu/cli/resize_cmd.py. On the card the bilinear filter is the
fused resize kernel (K1), one launch an image; the other filters are
plain PyTorch ops on the device."""

from __future__ import annotations

from .common import (
    INTERPOLATION_NAMES, Timer, log, resolve_output_target, run_batch,
)

description = "Resize images by scale factor or to explicit dimensions."


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--scale", type=float, help="Scale factor")
    parser.add_argument("--width", type=int, help="Target width in pixels")
    parser.add_argument("--height", type=int, help="Target height in pixels")
    parser.add_argument("--filter", choices=sorted(INTERPOLATION_NAMES),
                        default="bilinear", help="Interpolation filter")
    parser.add_argument("-o", "--output", required=True,
                        help="Output file or directory path")


def compute_target_dimensions(rows, cols, scale, width, height):
    """reference: resize.zig computeTargetDimensions:124."""
    import numpy as np

    if scale is not None:
        if not (scale > 0) or not np.isfinite(scale):
            raise ValueError("scale factor must be positive and finite")
        return (max(1, round(rows * scale)), max(1, round(cols * scale)))
    if width is not None and height is not None:
        return (height, width)
    if width is not None:
        return (max(1, round(rows / cols * width)), width)
    if height is not None:
        return (height, max(1, round(cols / rows * height)))
    raise ValueError("must specify at least one of scale, width, or height")


def run(args):
    from ..image import Image

    if args.scale is not None and (args.width or args.height):
        raise ValueError("cannot specify both scale and width/height")

    method = INTERPOLATION_NAMES[args.filter]

    def one(path):
        timer = Timer(f"resize {path}", args.device)
        img = Image.load(path, device=args.device)
        rows, cols = compute_target_dimensions(
            img.rows, img.cols, args.scale, args.width, args.height
        )
        out = img.resize((rows, cols), method)
        target = resolve_output_target(args.output, path, "_resized")
        out.save(target)
        timer.log()
        log.info("%s -> %s (%dx%d)", path, target, out.cols, out.rows)

    return run_batch(args.images, one)
