"""PSNR, SSIM and mean pixel error under several degradations
(reference: examples/src/metrics.zig)."""

from zignal_tpu_torch.examples._common import load_input, parse


def main(argv=None):
    args = parse(argv, __doc__)
    img = load_input(args, size=(256, 256))
    for name, degraded in [
        ("gaussian blur s=1", img.gaussian_blur(1.0)),
        ("gaussian blur s=3", img.gaussian_blur(3.0)),
        ("box blur r=2", img.box_blur(2)),
        ("median r=2", img.median_blur(2)),
    ]:
        print(f"{name:20s} psnr={img.psnr(degraded):6.2f} dB "
              f"ssim={img.ssim(degraded):.4f} "
              f"mpe={img.mean_pixel_error(degraded):.4f}")


if __name__ == "__main__":
    main()
