"""`zignal-torch blur` (reference: src/cli/blur.zig), copied from
zignal_tpu/cli/blur_cmd.py. On the card the gaussian blur is the
separable u8 kernel (K4); the other types are plain PyTorch ops on the
device (the radial blurs at host-built coordinates)."""

from __future__ import annotations

import math

from .common import emit_display, resolve_output_target, run_batch

description = "Apply blur effects: gaussian, box, median, motion (linear/zoom/spin)."

BLUR_TYPES = ("gaussian", "box", "median", "min", "max", "midpoint",
              "linear", "zoom", "spin")


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--type", choices=BLUR_TYPES, default="gaussian",
                        help="Blur type (default: gaussian)")
    parser.add_argument("-o", "--output", help="Output file or directory")
    parser.add_argument("-d", "--display", action="store_true",
                        help="Display the result in the terminal")
    parser.add_argument("--radius", type=int, help="Radius (box/median/...)")
    parser.add_argument("--sigma", type=float, help="Gaussian sigma")
    parser.add_argument("--angle", type=float, help="Motion angle (degrees)")
    parser.add_argument("--distance", type=int, help="Motion distance (pixels)")
    parser.add_argument("--center-x", type=float, default=0.5)
    parser.add_argument("--center-y", type=float, default=0.5)
    parser.add_argument("--strength", type=float, default=0.5)
    parser.add_argument("--width", type=int, help="Display width")
    parser.add_argument("--height", type=int, help="Display height")
    parser.add_argument("--protocol", help="Display protocol")


def apply(img, args):
    from ..motion_blur import MotionBlur

    t = args.type
    if t == "gaussian":
        return img.gaussian_blur(args.sigma or 3.0)
    if t == "box":
        return img.box_blur(args.radius or 3)
    if t == "median":
        return img.median_blur(args.radius or 3)
    if t == "min":
        return img.min_blur(args.radius or 3)
    if t == "max":
        return img.max_blur(args.radius or 3)
    if t == "midpoint":
        return img.midpoint_blur(args.radius or 3)
    if t == "linear":
        return img.motion_blur(MotionBlur.linear(
            math.radians(args.angle or 0.0), args.distance or 15))
    if t == "zoom":
        return img.motion_blur(MotionBlur.radial_zoom(
            (args.center_x, args.center_y), args.strength))
    return img.motion_blur(MotionBlur.radial_spin(
        (args.center_x, args.center_y), args.strength))


def run(args):
    from ..image import Image

    def one(path):
        out = apply(Image.load(path, device=args.device), args)
        target = resolve_output_target(args.output, path, f"_{args.type}")
        if target:
            out.save(target)
        if args.display or not target:
            emit_display(out, args.protocol, args.width, args.height)

    return run_batch(args.images, one)
