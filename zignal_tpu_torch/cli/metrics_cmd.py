"""`zignal-torch metrics` (reference: src/cli/metrics.zig), copied from
zignal_tpu/cli/metrics_cmd.py: SSIM on the device, PSNR and the mean
pixel error on the host, as the port's Image computes them."""

from __future__ import annotations

description = "Compute PSNR / SSIM / mean pixel error between two images."


def configure(parser):
    parser.add_argument("image1")
    parser.add_argument("image2")


def run(args):
    from ..image import Image

    a = Image.load(args.image1, device=args.device)
    b = Image.load(args.image2, device=args.device)
    if (a.rows, a.cols) != (b.rows, b.cols):
        raise ValueError("images must have the same dimensions")
    if a.dtype is not b.dtype:
        b = b.convert(a.dtype)
    psnr = a.psnr(b)
    mpe = a.mean_pixel_error(b)
    print(f"psnr: {psnr:.4f} dB")
    if a.rows >= 11 and a.cols >= 11:
        print(f"ssim: {a.ssim(b):.6f}")
    print(f"mean_pixel_error: {mpe:.6f}")
    return 0
