"""Feature Distribution Matching style transfer (reference:
examples/src/fdm.zig)."""

import numpy as np

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    src = load_input(args, size=(256, 256))
    # a warm "style" target made from the source
    t = src.to_numpy().astype(np.int16)
    tgt = zignal.Image.from_numpy(
        np.clip(t[..., ::-1] * 0.8 + 30, 0, 255).astype(np.uint8),
        device=args.device)
    save(args, tgt, "fdm_target.png")
    zignal.FeatureDistributionMatching().match(src, tgt)
    save(args, src, "fdm_result.png")


if __name__ == "__main__":
    main()
