"""`zignal-torch display` (reference: src/cli/display.zig), copied from
zignal_tpu/cli/display_cmd.py."""

from __future__ import annotations

from .common import emit_display, run_batch

description = "Display an image in the terminal using supported graphics protocols."


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--width", type=int, help="Target width in pixels")
    parser.add_argument("--height", type=int, help="Target height in pixels")
    parser.add_argument("--protocol",
                        choices=["auto", "kitty", "iterm2", "sixel", "sgr", "braille"],
                        help="Graphics protocol")


def run(args):
    from ..image import Image

    def one(path):
        if len(args.images) > 1:
            print(path)
        emit_display(Image.load(path, device=args.device), args.protocol,
                     args.width, args.height)

    return run_batch(args.images, one)
