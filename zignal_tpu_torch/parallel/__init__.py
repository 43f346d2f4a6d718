"""Scale-out on ``torch.distributed``, the counterpart of
zignal_tpu/parallel/: mesh construction, batch sharding, spatial sharding
with halo exchange, and summed global statistics.

JAX drives every device of a mesh from one program; PyTorch runs one
process (rank) a device. So a mesh here is a ``DeviceMesh`` over the ranks
of the running process group, and every rank calls the same functions
with the same global inputs; each computes on its own shard with the
single-device ops (on a card, their CUDA kernels) and sends only what
``parallel._comm`` sends:

- per-image independence -> batch data parallelism: ``[B, H, W, C]``
  sharded over a 1-D mesh axis; every batched op is collective-free;
- large single images -> spatial sharding: H sharded over the ranks,
  ``radius`` halo rows exchanged with the ring neighbours
  (``batch_isend_irecv``) for every convolution window;
- global statistics (FDM covariance, histograms) -> ``all_reduce``.

The backend follows the device: NCCL for ``cuda`` (one card a rank,
``cuda:{LOCAL_RANK}``), gloo for ``cpu``; nothing switches backends when
one fails. A sharded result comes back as a ``DTensor`` over the ranks'
shards (``.full_tensor()`` gathers it); a reduction comes back whole on
every rank.
"""

from __future__ import annotations

import os
from math import prod

import numpy as np
import torch
import torch.distributed as dist

from ..enums import BorderMode
from ..ops.convolution import gaussian_blur
from ..ops.tables import gaussian_kernel
from . import _comm
from .spatial import (  # noqa: F401  (re-exported surface)
    crop_op, halo_extend, spatial_adaptive_mean_threshold, spatial_box_blur,
    spatial_dilate, spatial_erode, spatial_mean_cov_image,
    spatial_median_blur, spatial_op, spatial_op_2d, spatial_sharpen,
    spatial_sobel, spatial_ssim,
)

__all__ = [
    "init_distributed", "make_global_mesh",
    "make_mesh", "shard_batch", "replicate", "sharded_pipeline",
    "spatial_gaussian_blur", "global_mean_cov", "spatial_histogram",
    "spatial_equalize",
    # generic spatial sharding (parallel/spatial.py)
    "halo_extend", "spatial_op", "spatial_box_blur", "spatial_sharpen",
    "spatial_adaptive_mean_threshold", "spatial_sobel", "spatial_dilate",
    "spatial_erode", "spatial_median_blur", "spatial_ssim",
    "spatial_mean_cov_image",
]


def _backend(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs the NCCL backend, and "
                               "this torch has none")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh backend for device {device}")


def _check_running(device) -> None:
    want = _backend(device)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"the running process group is {have}, and a "
                           f"{torch.device(device).type} mesh needs {want}")


def _use_card(device, local_rank: int) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else local_rank)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *, device) -> None:
    """Join this process to the process group of the mesh's ranks (the
    counterpart of ``jax.distributed.initialize``).

    Under ``torchrun`` every argument comes from its environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); elsewhere pass
    ``coordinator_address`` ("host:port", or a ``tcp://`` or ``file://``
    URL), ``num_processes`` and ``process_id``. ``local_device_ids``
    names this rank's card (default: LOCAL_RANK, else 0). The backend is
    NCCL for ``device="cuda"`` and gloo for ``"cpu"``. A second call does
    nothing, if the running group has the device's backend."""
    backend = _backend(device)
    if dist.is_initialized():
        _check_running(device)
        return
    if coordinator_address is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError(
                "no process group to join: run under torchrun, or pass "
                "coordinator_address, num_processes and process_id")
        init, rank = "env://", int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    local = (int(np.ravel(local_device_ids)[0])
             if local_device_ids is not None
             else int(os.environ.get("LOCAL_RANK", 0)))
    _use_card(device, local)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


def _group_of_one(device) -> None:
    """A process group of this process alone (an in-memory store), so a
    plain ``python`` run gets a mesh of its one device."""
    backend = _backend(device)
    _use_card(device, 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _device_mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_global_mesh(axis_name: str = "batch", *, device):
    """1-D mesh over every rank of the running process group (start it
    with ``init_distributed`` on each host first)."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh needs a running process group "
                           "(init_distributed)")
    _check_running(device)
    return _device_mesh(device, (dist.get_world_size(),), (axis_name,))


def make_mesh(n_devices=None, axis_name="batch", *, device):
    """Mesh over the ranks of the running process group: 1-D of
    ``n_devices`` ranks named ``axis_name``, or a tuple shape with a tuple
    of names, e.g. ``make_mesh((2, 2), ("batch", "space"), device=...)``.

    Raises when fewer ranks run than the mesh needs: degrading to a
    smaller mesh would let sharded code pass without ever running on
    several devices. With no group running, a mesh of one (``n_devices``
    of 1 or None) starts a group of this process alone on ``device``."""
    shape = (tuple(int(v) for v in n_devices)
             if isinstance(n_devices, (tuple, list)) else
             (None if n_devices is None else (int(n_devices),)))
    names = (tuple(axis_name) if isinstance(axis_name, (tuple, list))
             else (axis_name,))
    if not dist.is_initialized():
        if shape is not None and prod(shape) != 1:
            raise ValueError(
                f"make_mesh({n_devices}) but only 1 process is running "
                f"({torch.device(device).type}); start the ranks with "
                "torchrun or init_distributed (n gloo CPU ranks for testing)")
        _group_of_one(device)
    _check_running(device)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         "in length")
    if prod(shape) > world:
        raise ValueError(
            f"make_mesh({n_devices}) but only {world} rank(s) are running "
            f"({dist.get_backend()}); start more ranks (torchrun, or n gloo "
            "CPU ranks for testing)")
    if prod(shape) < world:
        raise ValueError(f"make_mesh({n_devices}) must span all {world} "
                         "ranks of the running process group")
    return _device_mesh(device, shape, names)


def shard_batch(arr, mesh, axis_name: str = "batch"):
    """Place ``[B, ...]`` with B sharded across the mesh axis: every rank
    passes the whole array and keeps its slice."""
    dims = {axis_name: 0}
    return _comm.as_global(_comm.local_shard(arr, mesh, dims), mesh, dims)


def replicate(arr, mesh):
    """The whole array on every rank."""
    return _comm.as_global(_comm.local_shard(arr, mesh, {}), mesh, {})


def sharded_pipeline(mesh, out_rows: int, out_cols: int, sigma: float = 2.0):
    """The north-star pipeline on each rank's shard of a batch sharded over
    the mesh's first axis (data parallel; no collectives). On a card each
    shard is one launch of the fused resize -> blur -> Oklab kernel."""
    from ..pipeline import resize_blur_oklab

    dims = {mesh.mesh_dim_names[0]: 0}

    def step(batch):
        local = _comm.local_shard(batch, mesh, dims)
        return _comm.as_global(
            resize_blur_oklab(local, out_rows, out_cols, sigma), mesh, dims)

    return step


def spatial_gaussian_blur(mesh, sigma: float, border=None,
                          axis_name: str = "batch"):
    """Gaussian blur of one ``[H, W, C]`` image with H sharded across the
    mesh, bit-identical to ``ops.convolution.gaussian_blur`` on u8 inputs
    for all four borders (8.8 fixed point: convolution.zig:12-38): the
    kernel-radius halo rows of the input are exchanged with the ring
    neighbours (or synthesized at the global edges), the single-device
    blur runs on the extended block (on a card, the separable kernel on a
    u8 block) and the halo rows are cropped. Float inputs take the same
    route through the float taps. sigma 0 returns the input unchanged."""
    border = BorderMode(border) if border is not None else BorderMode.MIRROR
    if sigma == 0:
        return lambda image: image
    radius = len(gaussian_kernel(sigma)) // 2
    dims = {axis_name: 0}

    def blur(image):
        local = _comm.local_shard(image, mesh, dims)
        h_loc = local.shape[0]
        if radius > h_loc or (border == BorderMode.MIRROR
                              and radius + 1 > h_loc):
            raise ValueError(
                f"shard of {h_loc} rows too small for sigma={sigma} "
                f"(radius {radius}); use fewer chips or smaller sigma")
        out = crop_op(local, lambda ext: gaussian_blur(ext, sigma, border),
                      radius, border, mesh, axis_name)
        return _comm.as_global(out, mesh, dims)

    return blur


def global_mean_cov(mesh, axis_name: str = "batch"):
    """Mean and channel covariance ``E[x x^T] - mean mean^T`` of a
    batch-sharded ``[B, H, W, C]`` image set, as f32 tensors on every rank:
    each rank's sums in f64 (exact for u8: below 2^53), summed over the
    ranks in one ``all_reduce`` (the FDM statistics path on a mesh)."""
    dims = {axis_name: 0}

    def stats(batch):
        local = _comm.local_shard(batch, mesh, dims)
        c = local.shape[-1]
        x = local.reshape(-1, c).to(torch.float64)
        packed = torch.cat([x.new_tensor([x.shape[0]]), x.sum(dim=0),
                            (x.T @ x).reshape(-1)])
        packed = _comm.all_reduce(packed, mesh, axis_name)
        count, s, ss = packed[0], packed[1:1 + c], packed[1 + c:]
        mean = s / count
        cov = ss.reshape(c, c) / count - torch.outer(mean, mean)
        return mean.to(torch.float32), cov.to(torch.float32)

    return stats


def spatial_histogram(mesh, axis_name: str = "batch"):
    """256-bin per-channel histograms ``[C, 256]`` int32 of one H-sharded
    ``[H, W, C]`` u8 image: each rank's counts, summed over the ranks."""
    from ..ops.binary import histogram256_multi

    dims = {axis_name: 0}

    def run(image):
        local = _comm.local_shard(image, mesh, dims)
        return _comm.all_reduce(histogram256_multi(local), mesh, axis_name)

    return run


def spatial_equalize(mesh, axis_name: str = "batch", skip_alpha: bool = True):
    """Histogram equalization of one H-sharded ``[H, W, C]`` u8 image: the
    global CDF from the summed histograms, then each rank maps its rows
    through the shared LUT (the u32 arithmetic of
    ``ops.enhancement.equalize``, whose total is the global H * W); equal
    to the single-device op (enhancement.zig:84-150)."""
    from ..ops.binary import histogram256_multi
    from ..ops.enhancement import equalize_from_hists

    dims = {axis_name: 0}

    def run(image):
        local = _comm.local_shard(image, mesh, dims)
        hists = _comm.all_reduce(histogram256_multi(local), mesh, axis_name)
        total = local.shape[0] * _comm.axis_size(mesh, axis_name) \
            * local.shape[1]
        return _comm.as_global(
            equalize_from_hists(local, hists, total, skip_alpha), mesh, dims)

    return run
