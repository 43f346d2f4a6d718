"""Autocontrast and histogram equalization (reference:
examples/src/contrast_enhancement.zig)."""

import numpy as np

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    # flatten the contrast first, so that the enhancement shows
    low = (img.to_numpy().astype(np.float32) * 0.4 + 80).astype(np.uint8)
    img = zignal.Image.from_numpy(low, device=args.device)
    save(args, img, "low_contrast.png")
    save(args, img.autocontrast(cutoff=0.01), "autocontrast.png")
    save(args, img.equalize(), "equalized.png")


if __name__ == "__main__":
    main()
