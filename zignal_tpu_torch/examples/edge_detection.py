"""Sobel, Canny and Shen-Castan (reference:
examples/src/edge_detection.zig)."""

from zignal_tpu_torch.examples._common import load_input, parse, save


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    save(args, img.sobel(), "edges_sobel.png")
    save(args, img.canny(sigma=1.4, low=40, high=120), "edges_canny.png")
    save(args, img.shen_castan(), "edges_shen_castan.png")


if __name__ == "__main__":
    main()
