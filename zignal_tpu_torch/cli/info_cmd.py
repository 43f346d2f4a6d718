"""`zignal-torch info` (reference: src/cli/info.zig), copied from
zignal_tpu/cli/info_cmd.py."""

from __future__ import annotations

import os

from .common import run_batch

description = "Display detailed information about one or more image files."


def configure(parser):
    parser.add_argument("images", nargs="+", metavar="image")
    parser.add_argument("--stats", action="store_true",
                        help="Compute and display image statistics")


def run(args):
    import numpy as np

    from ..codecs import bmp, detect_format, gif, jpeg, png
    from ..image import Image

    def one(path):
        with open(path, "rb") as f:
            data = f.read()
        fmt = detect_format(data)
        if fmt is None:
            raise ValueError("unrecognized image format")
        if fmt.value == "png":
            info = png.get_info(data)
            extra = (f"{info.bit_depth}-bit, color type {info.color_type}"
                     + (", interlaced" if info.interlace else ""))
            w, h = info.width, info.height
        elif fmt.value == "jpeg":
            info = jpeg.get_info(data)
            extra = f"{info.components} component(s)"
            w, h = info.width, info.height
        elif fmt.value == "bmp":
            info = bmp.get_info(data)
            extra = f"{info.bit_count} bpp"
            w, h = info.width, info.height
        else:
            info = gif.get_info(data)
            extra = f"{info.frame_count} frame(s), loop={info.loop_count}"
            w, h = info.width, info.height
        size = os.path.getsize(path)
        print(f"{path}: {fmt.value.upper()} {w}x{h} ({extra}), {size} bytes")
        if args.stats:
            arr = Image.load(path, device=args.device).to_numpy() \
                .astype(np.float64)
            print(f"  min={arr.min():.0f} max={arr.max():.0f} "
                  f"mean={arr.mean():.2f} stddev={arr.std():.2f}")

    return run_batch(args.images, one)
