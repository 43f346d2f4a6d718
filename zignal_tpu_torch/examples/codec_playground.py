"""Codec playground: encode and decode one image through every codec
(reference: examples/src/codec_playground.zig): PNG, BMP, GIF (quantized)
and JPEG at several qualities and subsamplings, with the encoded size,
the round trip and the PSNR against the source."""

import io

import numpy as np

from zignal_tpu_torch.codecs import bmp, detect_format, gif, jpeg, png
from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    src = img.to_numpy()[..., :3].copy()
    save(args, zignal.Image.from_numpy(src, device=args.device),
         "codec_playground_input.png")
    print(f"input: {img.cols}x{img.rows} RGB")

    def psnr(back):
        return zignal.Image.from_numpy(src.copy(), device=args.device).psnr(
            zignal.Image.from_numpy(np.ascontiguousarray(back),
                                    device=args.device))

    results = []
    for name, codec in (("png (lossless)", png), ("bmp (lossless)", bmp)):
        data = codec.encode(src)
        back, _ = codec.decode(data)
        exact = np.array_equal(back, src)
        results.append((name, len(data), "inf" if exact else "BUG"))
    data = gif.encode(src)
    back = np.asarray(gif.decode(data)[0])[..., :3]
    results.append(("gif (256-color dither)", len(data), f"{psnr(back):.1f}"))
    for quality in (95, 85, 60):
        for sub in ("444", "420"):
            data = jpeg.encode(src, quality=quality, subsampling=sub)
            back = jpeg.load_from_bytes(data)
            results.append((f"jpeg q{quality} {sub}", len(data),
                            f"{psnr(back):.1f}"))
    print(f"{'format':<24} {'size':>9}     quality")
    for fmt, size, quality in results:
        print(f"  {fmt:<22} {size:>9,} B   PSNR {quality:>6}")

    # every decoder agrees with the format sniffer
    buf = io.BytesIO()
    for name, data in (("png", png.encode(src)), ("bmp", bmp.encode(src)),
                       ("gif", gif.encode(src)),
                       ("jpeg", jpeg.encode(src, quality=90))):
        detected = detect_format(data)
        assert detected is not None and detected.name.lower() == name, name
        buf.write(data)
    print(f"sniffer agrees on all 4 formats; total encoded {buf.tell():,} "
          "bytes")


if __name__ == "__main__":
    main()
