"""Gray-world white balance (reference: examples/src/whitebalance.zig)."""

import numpy as np

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    # cast the image blue, then correct it
    arr = img.to_numpy().astype(np.float64)
    cast = np.clip(arr * [0.85, 0.95, 1.25], 0, 255).astype(np.uint8)
    save(args, zignal.Image.from_numpy(cast, device=args.device),
         "whitebalance_before.png")
    a = cast.astype(np.float64)
    means = a.reshape(-1, 3).mean(axis=0)
    gains = means.mean() / np.maximum(means, 1e-6)
    balanced = np.clip(a * gains, 0, 255).astype(np.uint8)
    save(args, zignal.Image.from_numpy(balanced, device=args.device),
         "whitebalance_after.png")


if __name__ == "__main__":
    main()
