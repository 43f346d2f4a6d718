"""`zignal-torch edges` (reference: src/cli/edges.zig), copied from
zignal_tpu/cli/edges_cmd.py."""

from __future__ import annotations

from .common import emit_display, resolve_output_target, run_batch

description = "Detect edges: sobel, canny, or shen_castan."


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--filter", choices=["sobel", "canny", "shen_castan"],
                        default="sobel", help="Filter (default: sobel)")
    parser.add_argument("-o", "--output", help="Output file path")
    parser.add_argument("-d", "--display", action="store_true")
    parser.add_argument("--sigma", type=float,
                        help="Canny sigma (def 1.0) / Shen-Castan smooth (def 0.9)")
    parser.add_argument("--low", type=float,
                        help="Canny low threshold (def 50) / SC low_rel (def 0.5)")
    parser.add_argument("--high", type=float,
                        help="Canny high threshold (def 100) / SC high_ratio (def 0.99)")
    parser.add_argument("--window", type=int, help="Shen-Castan window size")
    parser.add_argument("--nms", action="store_true", help="Shen-Castan NMS")
    parser.add_argument("--width", type=int)
    parser.add_argument("--height", type=int)
    parser.add_argument("--protocol", help="Display protocol")


def apply(img, args):
    if args.filter == "sobel":
        return img.sobel()
    if args.filter == "canny":
        return img.canny(sigma=args.sigma if args.sigma is not None else 1.0,
                         low=args.low if args.low is not None else 50,
                         high=args.high if args.high is not None else 100)
    return img.shen_castan(
        smooth=args.sigma if args.sigma is not None else 0.9,
        window_size=args.window or 7,
        high_ratio=args.high if args.high is not None else 0.99,
        low_rel=args.low if args.low is not None else 0.5,
        use_nms=args.nms,
    )


def run(args):
    from ..image import Image

    def one(path):
        out = apply(Image.load(path, device=args.device), args)
        target = resolve_output_target(args.output, path, f"_{args.filter}")
        if target:
            out.save(target)
        if args.display or not target:
            emit_display(out, args.protocol, args.width, args.height)

    return run_batch(args.images, one)
