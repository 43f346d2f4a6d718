"""Perlin noise textures (reference: examples/src/perlin_noise.zig)."""

import numpy as np

from zignal_tpu_torch.examples._common import parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    n = 256
    ys, xs = np.meshgrid(np.linspace(0, 8, n), np.linspace(0, 8, n),
                         indexing="ij")
    noise = zignal.perlin_array(xs, ys, octaves=5, persistence=0.55,
                                device=args.device).cpu().numpy()
    gray = ((noise - noise.min()) / (np.ptp(noise) + 1e-9) * 255) \
        .astype(np.uint8)
    img = zignal.Image.from_numpy(gray[..., None], device=args.device)
    save(args, img, "perlin_gray.png")
    save(args, img.apply_colormap(zignal.Colormap.viridis()),
         "perlin_viridis.png")


if __name__ == "__main__":
    main()
