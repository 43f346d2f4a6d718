"""Motion blur variants (reference: examples/src/motion_blur_demo.zig)."""

import math

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    save(args, img.motion_blur(zignal.MotionBlur.linear(math.radians(30),
                                                        21)),
         "motion_linear.png")
    save(args, img.motion_blur(zignal.MotionBlur.radial_zoom(strength=0.6)),
         "motion_zoom.png")
    save(args, img.motion_blur(zignal.MotionBlur.radial_spin(strength=0.5)),
         "motion_spin.png")


if __name__ == "__main__":
    main()
