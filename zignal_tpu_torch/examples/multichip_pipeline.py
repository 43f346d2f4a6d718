"""Scale-out with zignal_tpu_torch.parallel: the batch-sharded pipeline,
a halo-exchange blur of one row-sharded image, and summed statistics.

Runs on the ranks of torchrun (``torchrun --nproc-per-node N -m
zignal_tpu_torch.examples.multichip_pipeline``: NCCL, one card a rank), or
as a group of this process alone.
"""

import numpy as np
import torch.distributed as dist

from zignal_tpu_torch.examples._common import (load_input, parse,
                                               process_group, save, zignal)
from zignal_tpu_torch.parallel import (_comm, make_mesh, shard_batch,
                                       sharded_pipeline, spatial_equalize,
                                       spatial_gaussian_blur,
                                       spatial_histogram)


def main(argv=None):
    args = parse(argv, __doc__)
    with process_group(args.device):
        mesh = make_mesh(device=args.device)
        n = dist.get_world_size()
        print(f"mesh: {n} x {_comm.mesh_device(mesh).type} "
              f"({dist.get_backend()})")
        arr = load_input(args, size=(512, 512)).to_numpy()[..., :3]

        # 1) data parallelism: a batch sharded over the ranks, the whole
        # resize + blur + Oklab chain on each rank's images, no collective
        batch = np.stack([np.roll(arr, i * 7, axis=1) for i in range(2 * n)])
        out = sharded_pipeline(mesh, 256, 256, sigma=2.0)(
            shard_batch(batch, mesh))
        print("sharded pipeline:", tuple(out.shape), out.dtype,
              "local:", tuple(out.to_local().shape))

        # 2) spatial sharding: one image split by rows over the ranks; the
        # blur windows trade halo rows with the ring neighbours
        blurred = _comm.full(spatial_gaussian_blur(mesh, sigma=2.0)(arr))

        # 3) global statistics by summed histograms: equalization of the
        # row-sharded image
        hist = spatial_histogram(mesh)(arr)
        print("global histogram channel sums:",
              hist.sum(dim=1).cpu().numpy())
        eq = _comm.full(spatial_equalize(mesh)(arr))
        if mesh.get_rank() == 0:
            for name, pixels in (("multichip_blur.png", blurred),
                                 ("multichip_equalized.png", eq)):
                save(args, zignal.Image.from_numpy(pixels.cpu().numpy(),
                                                   device=args.device), name)


if __name__ == "__main__":
    main()
