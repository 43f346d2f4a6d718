"""ORB detection and Hamming matching (reference:
examples/src/feature_matching.zig)."""

import math

from zignal_tpu_torch.examples._common import load_input, parse, save
from zignal_tpu_torch.features import BruteForceMatcher, Orb


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    rotated = img.rotate(math.radians(15))
    orb = Orb(n_features=300, n_levels=4)
    k1, d1 = orb.detect_and_compute(img)
    k2, d2 = orb.detect_and_compute(rotated)
    matches = BruteForceMatcher(cross_check=True, max_distance=48,
                                device=args.device).match(d1, d2)
    print(f"keypoints: {len(k1)} / {len(k2)}, matches: {len(matches)}")
    canvas = img.canvas()
    for kp in k1:
        canvas.draw_circle((kp.x, kp.y), 3, (0, 255, 0))
    save(args, img, "orb_keypoints.png")


if __name__ == "__main__":
    main()
