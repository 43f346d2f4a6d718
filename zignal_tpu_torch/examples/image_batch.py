"""ImageBatch on a mesh: a set of images as one [B, H, W, C] batch,
placed on a mesh and chained like a single Image; the collectives happen
inside the ops (zignal_tpu_torch/batch.py).

Runs on the ranks of torchrun (``torchrun --nproc-per-node N -m
zignal_tpu_torch.examples.image_batch``), or as a group of this process
alone: a mesh of one device.
"""

import numpy as np
import torch.distributed as dist

from zignal_tpu_torch import Gray, ImageBatch
from zignal_tpu_torch.examples._common import (load_input, parse,
                                               process_group, save)
from zignal_tpu_torch.parallel import _comm, make_mesh


def main(argv=None):
    args = parse(argv, __doc__)
    with process_group(args.device):
        img = load_input(args, size=(256, 256))
        arr = img.to_numpy()[..., :3]
        mesh = make_mesh(device=args.device)
        n = dist.get_world_size()
        # a batch of shifted copies (a stand-in for a dataset)
        batch_np = np.stack([np.roll(arr, i * 11, axis=1)
                             for i in range(2 * n)])

        # 1) batch sharding: every op runs on the rank's images, no
        # collective
        print(f"mesh: {n} x {_comm.mesh_device(mesh).type}")
        b = ImageBatch(batch_np, mesh=mesh)
        print("in: ", b)
        out = (b.resize((128, 128)).gaussian_blur(1.5).autocontrast(0.01)
               .convert(Gray).equalize())
        print("out:", out, "local images:", out.device_array().to_local()
              .shape[0])
        first = out[0]
        if mesh.get_rank() == 0:
            save(args, first, "image_batch_first.png")

        # per-image metrics come back as a [B] vector
        psnr = _comm.full(b.psnr(b.gaussian_blur(3.0))).cpu().numpy()
        print("psnr[b] vs blurred:", np.round(psnr, 2))

        # 2) a 2-D (batch x space) mesh: rows sharded too; the windowed
        # ops trade halo rows with their ring neighbours
        shape = (2, n // 2) if n % 2 == 0 else (1, n)
        mesh2 = make_mesh(shape, ("batch", "space"), device=args.device)
        b2 = ImageBatch(batch_np[:2], mesh=mesh2)
        out2 = b2.gaussian_blur(2.0).box_blur(2).sharpen(1)
        ref = ImageBatch(batch_np[:2], device=args.device).gaussian_blur(2.0) \
            .box_blur(2).sharpen(1)
        print("2-D mesh windowed chain bit-exact:",
              np.array_equal(out2.to_numpy(), ref.to_numpy()))

        # 3) Otsu per image: device histograms, the host sweep -> [B] ints
        binary, thresholds = b.convert(Gray).threshold_otsu()
        print("otsu thresholds:", thresholds.tolist())
        first = binary[0]
        if mesh.get_rank() == 0:
            save(args, first, "image_batch_otsu.png")


if __name__ == "__main__":
    main()
