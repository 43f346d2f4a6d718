"""Sustained image-stream processing: decode -> resize -> encode for a
stream of files, then letterboxed batches from the pinned loader through
the fused filter chain (blur, sharpen, threshold, morphology: one kernel
launch on the card)."""

import os
import tempfile
import time

import numpy as np

from zignal_tpu_torch.codecs import jpeg
from zignal_tpu_torch.examples._common import parse, zignal
from zignal_tpu_torch.io_pipeline import BatchLoader
from zignal_tpu_torch.pipeline import filter_chain


def main(argv=None):
    args = parse(argv, __doc__)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:600, 0:800].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 97) * np.cos(yy / 53),
                     128 + 80 * np.cos(xx / 61 + yy / 41),
                     128 + 70 * np.sin((xx + yy) / 151)], -1)
    photo = np.clip(base + rng.normal(0, 12, (600, 800, 3)),
                    0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k in range(6):
            p = os.path.join(tmp, f"frame{k}.jpg")
            with open(p, "wb") as f:
                f.write(jpeg.encode(photo, quality=90))
            paths.append(p)

        # one-shot stream: decode -> resize on the device -> encode
        t0 = time.perf_counter()
        for p in paths:
            small = zignal.Image.load(p, device=args.device).resize(0.5)
            small.save(os.path.join(args.out, os.path.basename(p)
                                    .replace(".jpg", "_half.png")))
        dt = time.perf_counter() - t0
        print(f"stream: {len(paths)} images in {dt * 1e3:.0f} ms "
              f"({len(paths) * 0.48 / dt:.1f} MPix/s sustained)")

        # batched device work: a letterboxed batch, the fused filter chain
        for batch in BatchLoader(paths, batch_size=6, shape=(512, 512),
                                 device=args.device):
            masks = filter_chain(batch[..., 0].contiguous())
            print("filter_chain batch:", tuple(masks.shape),
                  "foreground fraction:",
                  round(float((masks > 0).float().mean()), 3))


if __name__ == "__main__":
    main()
