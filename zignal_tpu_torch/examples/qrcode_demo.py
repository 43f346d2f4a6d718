"""QR encode and decode round trip (reference: examples/src/qrcode.zig)."""

from zignal_tpu_torch.examples._common import parse, save
from zignal_tpu_torch.qrcode import EcLevel, decode_image, encode_text


def main(argv=None):
    args = parse(argv, __doc__)
    text = "https://github.com/arrufat/zignal"
    img = encode_text(text, EcLevel.QUARTILE, module_size=6,
                      device=args.device)
    save(args, img, "qrcode.png")
    for r in decode_image(img):
        print(f"decoded: {r.text!r} (version {r.version}, {r.ec_level.name})")


if __name__ == "__main__":
    main()
