"""The mesh plumbing of ``parallel/`` and of ``ImageBatch`` on a mesh:
one process (rank) a device under ``torch.distributed``, a
``DeviceMesh`` naming the axes, and the port's collectives, counted.

A rank holds its shard of every sharded value as a plain tensor on its
device and computes on it with the single-device ops; the only traffic is
what this module sends: ``exchange`` (point to point, ring neighbours'
halo rows), ``all_reduce`` (SUM) and ``all_gather``. Each adds to
``COLLECTIVES`` under ``ops/_build.COUNT_LOCK``, as a kernel's wrapper adds
to its ``LAUNCHES``; a value leaves the mesh as a ``DTensor`` over its
shards (``as_global``), never through DTensor's operator dispatch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops._build import COUNT_LOCK

__all__ = ["COLLECTIVES", "reset_counts", "mesh_device", "axis_size",
           "axis_rank", "local_shard", "as_global", "full", "all_reduce",
           "all_gather", "peer", "exchange"]

# collectives since import (or the last reset_counts): messages this rank
# sent point to point, all_reduce calls and all_gather calls (a DTensor
# gathered by ``full`` counts one a sharded mesh axis)
COLLECTIVES = {"p2p": 0, "all_reduce": 0, "all_gather": 0}


def _count(kind: str, n: int = 1) -> None:
    with COUNT_LOCK:
        COLLECTIVES[kind] += n


def reset_counts() -> None:
    with COUNT_LOCK:
        for k in COLLECTIVES:
            COLLECTIVES[k] = 0


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its card on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _placements(mesh, dims: dict):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[name]) if name in dims else Replicate()
            for name in mesh.mesh_dim_names]


def local_shard(x, mesh, dims: dict) -> torch.Tensor:
    """This rank's block of ``x`` sharded as ``dims`` ({axis: tensor dim})
    on the mesh's device: a DTensor's local tensor (its replicated axes
    sliced), or the rank's slice of a global numpy array or tensor that
    every rank holds whole."""
    from torch.distributed.tensor import DTensor, Shard

    placed = {}
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("the DTensor lives on another mesh")
        for name, p in zip(mesh.mesh_dim_names, x.placements):
            if isinstance(p, Shard):
                if dims.get(name) != p.dim:
                    raise ValueError(
                        f"input sharded on dim {p.dim} over {name!r}, "
                        f"expected {dims.get(name)}")
                placed[name] = p.dim
        x = x.to_local()
    elif isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not isinstance(x, torch.Tensor):
        raise TypeError("expected a DTensor, a torch tensor or a numpy array")
    x = x.to(mesh_device(mesh))
    for name, d in dims.items():
        if name in placed:
            continue
        n, i = axis_size(mesh, name), axis_rank(mesh, name)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} not divisible "
                             f"by mesh axis {name!r} ({n} ranks)")
        step = x.shape[d] // n
        x = x.narrow(d, i * step, step)
    return x.contiguous()


def as_global(local: torch.Tensor, mesh, dims: dict):
    """The global value whose shard this rank holds: a DTensor over the
    mesh, sharded as ``dims`` and replicated over the other axes (no
    communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, _placements(mesh, dims),
                              run_check=False)


def full(x) -> torch.Tensor:
    """The whole value of a DTensor on every rank (``full_tensor``)."""
    from torch.distributed.tensor import Shard

    _count("all_gather", sum(isinstance(p, Shard) for p in x.placements))
    return x.full_tensor()


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``: the sum of every rank's ``t``, in place."""
    _count("all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on ``dim``."""
    _count("all_gather")
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def peer(mesh, axis: str, offset: int) -> int:
    """Global rank of the rank ``offset`` steps along ``axis``'s ring."""
    n, i = axis_size(mesh, axis), axis_rank(mesh, axis)
    return dist.get_global_rank(mesh.get_group(axis), (i + offset) % n)


def exchange(sends, recvs, mesh, axis: str) -> None:
    """Post every ``(tensor, global peer, tag)`` send and receive as one
    batch and wait. Two messages between one pair of ranks (a ring of 2)
    are told apart by their tags, and, where the backend ignores tags, by
    the fixed order in which both ranks post them."""
    group = mesh.get_group(axis)
    ops = [dist.P2POp(dist.isend, t.contiguous(), p, group, tag)
           for t, p, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, p, group, tag) for t, p, tag in recvs]
    if not ops:
        return
    _count("p2p", len(sends))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
