"""Entry points of the port, the twin of the repository's
``__graft_entry__.py``:

- ``entry()``: the north-star step that ``ImageBatch.resize_blur_oklab``
  dispatches (``batch.resize_blur_oklab_fn``), bound for a 2 x 256^2 ->
  128^2 batch at sigma 1.5, with that batch; on a card the callable is one
  launch of the fused resize -> blur -> Oklab kernel;
- ``dryrun_multichip(n, device=)``: the whole multi-device path once on a
  mesh of ``n`` ranks at small shapes, with its checks: the batch-sharded
  pipeline, the halo-exchange blur, the summed statistics, the clamped
  box blur and a crop-lifted Sobel, a 2-D (batch x space) median, and
  ImageBatch on both meshes. ``device="cpu"`` spawns ``n`` gloo CPU ranks
  (the counterpart of JAX's virtual CPU devices); ``device="cuda"`` needs
  ``n`` cards (NCCL), and ``n = 1`` runs in this process.
"""

from __future__ import annotations

import os
import tempfile
from functools import partial

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry():
    from .batch import resize_blur_oklab_fn
    from .enums import Interpolation

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    fn = resize_blur_oklab_fn(128, 128, 1.5, Interpolation.BILINEAR)
    return fn, (batch,)


def _steps(n: int, device) -> None:
    """Steps 1-6 of the dry run on this rank (the group is running)."""
    from . import Gray, ImageBatch
    from .ops.order_stat import median_blur
    from .parallel import (_comm, global_mean_cov, make_mesh, shard_batch,
                           sharded_pipeline, spatial_box_blur,
                           spatial_gaussian_blur, spatial_op_2d,
                           spatial_sobel)

    mesh = make_mesh(n, device=device)
    assert mesh.size() == n
    rng = np.random.default_rng(0)

    # 1) the batch data-parallel pipeline step
    batch = rng.integers(0, 256, (n * 2, 64, 64, 3), dtype=np.uint8)
    sharded = shard_batch(batch, mesh)
    out = sharded_pipeline(mesh, 32, 32, sigma=1.0)(sharded)
    assert out.shape == (n * 2, 32, 32, 3)
    assert out.to_local().shape == (2, 32, 32, 3)

    # 2) one image sharded by rows, blurred with halo exchange
    image = rng.integers(0, 256, (16 * n, 64, 3), dtype=np.uint8)
    blurred = spatial_gaussian_blur(mesh, sigma=1.0)(image)
    assert blurred.shape == image.shape

    # 3) summed global statistics (the FDM covariance path)
    mean, cov = global_mean_cov(mesh)(sharded)
    assert mean.shape == (3,) and cov.shape == (3, 3)

    # 4) the clamped box blur (ZERO halos, global area table) and a
    # crop-lifted stock op (Sobel)
    h_total = 16 * n
    bb = spatial_box_blur(mesh, h_total, 2)(image)
    assert bb.shape == image.shape
    plane = rng.random((h_total, 64), dtype=np.float32)
    assert spatial_sobel(mesh)(plane).shape == plane.shape

    # 5) a 2-D (batch x space) mesh: images over one axis, rows over the
    # other
    mesh2 = None
    if n % 2 == 0:
        mesh2 = make_mesh((2, n // 2), ("batch", "space"), device=device)
        bimg = rng.integers(0, 256, (4, 16 * (n // 2), 32, 3),
                            dtype=np.uint8)
        out2d = spatial_op_2d(mesh2, partial(median_blur, radius=1),
                              radius=1)(bimg)
        assert out2d.shape == bimg.shape

    # 6) ImageBatch on the meshes: a chained batch-sharded pipeline, the
    # fused north-star entry, and windowed and global-statistics ops on the
    # 2-D mesh
    b = ImageBatch(batch, mesh=mesh)
    chained = b.resize((32, 32)).gaussian_blur(1.0).convert(Gray).equalize()
    assert chained.device_array().shape == (n * 2, 32, 32, 1)
    ns = b.resize_blur_oklab((32, 32), sigma=1.0)
    assert ns.shape == (n * 2, 32, 32, 3)
    if mesh2 is not None:
        b2 = ImageBatch(rng.integers(0, 256, (2, 8 * (n // 2), 32, 3),
                                     dtype=np.uint8), mesh=mesh2)
        out2 = b2.gaussian_blur(1.0).box_blur(1).autocontrast(0.01)
        assert out2.device_array().shape == b2.device_array().shape
    if _comm.mesh_device(mesh).type == "cuda":
        torch.cuda.synchronize()


def _rank(rank: int, n: int, init: str, device: str) -> None:
    import torch.distributed as dist

    from .parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(init, n, rank, local_device_ids=[rank], device=device)
    try:
        _steps(n, device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device) -> None:
    """Run the multi-device path once on ``n_devices`` ranks, each on its
    own device, and raise if any step fails."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on cuda but only "
                         f"{torch.cuda.device_count()} card(s)")
    if device.type == "cuda" and n_devices == 1:
        started = not dist.is_initialized()
        from .parallel import make_mesh

        make_mesh(1, device=device)  # a group of this process alone
        try:
            _steps(1, device)
        finally:
            if started:
                dist.destroy_process_group()
        return
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(_rank, args=(n_devices, init, device.type),
                           nprocs=n_devices, join=True,
                           start_method="spawn")
