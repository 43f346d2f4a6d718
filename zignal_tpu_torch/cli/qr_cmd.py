"""`zignal-torch qr` (reference: src/cli/qr.zig), copied from
zignal_tpu/cli/qr_cmd.py."""

from __future__ import annotations

from .common import run_batch

description = "Encode text as a QR code or decode QR codes from images."

_LEVELS = {"l": 0, "m": 1, "q": 2, "h": 3}


def configure(parser):
    sub = parser.add_subparsers(dest="qr_action", metavar="encode|decode",
                                required=True)
    enc = sub.add_parser("encode", help="Encode text as a QR code")
    enc.add_argument("text")
    enc.add_argument("--ec-level", choices=sorted(_LEVELS), default="m",
                     help="Error correction level (default m)")
    enc.add_argument("--symbol-version", type=int,
                     help="Force the QR version 1-40")
    enc.add_argument("--module-size", type=int, default=8,
                     help="Pixels per module when saving (default 8)")
    enc.add_argument("--quiet-zone", type=int, default=4,
                     help="Light border in modules (default 4)")
    enc.add_argument("-o", "--output",
                     help="Save the encoded QR as an image instead of printing")
    dec = sub.add_parser("decode", help="Decode QR codes from images")
    dec.add_argument("images", nargs="+", metavar="image")


def run(args):
    from ..qrcode import EcLevel, decode_image, encode_text

    if args.qr_action == "encode":
        img = encode_text(
            args.text, EcLevel(_LEVELS[args.ec_level]),
            version=args.symbol_version, module_size=args.module_size,
            quiet_zone=args.quiet_zone, device=args.device,
        )
        if args.output:
            img.save(args.output)
            print(f"saved {args.output} ({img.cols}x{img.rows})")
        else:
            # print with half-block characters (dark = block)
            arr = img.to_numpy()[::args.module_size, ::args.module_size, 0]
            for r in range(0, arr.shape[0] - 1, 2):
                line = []
                for c in range(arr.shape[1]):
                    top = arr[r, c] == 0
                    bot = arr[r + 1, c] == 0
                    line.append({(True, True): "█", (True, False): "▀",
                                 (False, True): "▄", (False, False): " "}[
                                     (top, bot)])
                print("".join(line))
        return 0

    # decode
    from ..image import Image

    def one(path):
        results = decode_image(Image.load(path, device=args.device))
        if not results:
            raise ValueError("no QR code found")
        for res in results:
            print(f"{path}: {res.text!r} (version {res.version}, "
                  f"{res.ec_level.name}, {res.corrected_errors} corrected)")

    return run_batch(args.images, one)
