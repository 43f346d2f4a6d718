"""`zignal-torch fdm` (reference: src/cli/fdm.zig), copied from
zignal_tpu/cli/fdm_cmd.py."""

from __future__ import annotations

from .common import Timer, emit_display

description = ("Apply Feature Distribution Matching (style transfer) from "
               "target to source image.")


def configure(parser):
    parser.add_argument("source")
    parser.add_argument("target")
    parser.add_argument("output", nargs="?", help="Output path")
    parser.add_argument("-d", "--display", action="store_true")
    parser.add_argument("--width", type=int)
    parser.add_argument("--height", type=int)
    parser.add_argument("--protocol")


def run(args):
    from ..fdm import FeatureDistributionMatching
    from ..image import Image

    src = Image.load(args.source, device=args.device)
    tgt = Image.load(args.target, device=args.device)
    timer = Timer("fdm", args.device)
    FeatureDistributionMatching().match(src, tgt)
    timer.log()
    if args.output:
        src.save(args.output)
    if args.display or not args.output:
        emit_display(src, args.protocol, args.width, args.height)
    return 0
