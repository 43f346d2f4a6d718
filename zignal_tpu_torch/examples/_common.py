"""Shared helpers of the examples: the command line (an input image,
``--device``, ``--out``), the input image, saving, and the ranks' process
group."""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

import zignal_tpu_torch as zignal


def parse(argv=None, doc: str | None = None):
    """The example's arguments; the output directory is created."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("image", nargs="?",
                   help="input image (default: a seeded synthetic one)")
    p.add_argument("--device", default="cuda",
                   help="where the pixels live: cuda (default) or cpu")
    p.add_argument("--out", default="examples_out",
                   help="directory the outputs go to")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    os.makedirs(args.out, exist_ok=True)
    return args


def load_input(args, size=None):
    """The input image on ``args.device``: the file named on the command
    line, else a seeded 256x256 RGB image; resized to ``size``."""
    if args.image:
        img = zignal.Image.load(args.image, device=args.device)
    else:
        arr = np.random.default_rng(0).integers(0, 256, (256, 256, 3),
                                                dtype=np.uint8)
        img = zignal.Image.from_numpy(arr, device=args.device)
    return img.resize(size) if size is not None else img


def save(args, img, name: str) -> str:
    path = os.path.join(args.out, name)
    img.save(path)
    print(f"wrote {path} ({img.cols}x{img.rows})")
    return path


@contextlib.contextmanager
def process_group(device):
    """The ranks' process group for a mesh: torchrun's when it started
    this process, else (through ``make_mesh``) a group of this process
    alone; a group started here is torn down at the end."""
    import torch.distributed as dist

    from zignal_tpu_torch.parallel import init_distributed

    started = not dist.is_initialized()
    if started and "RANK" in os.environ:
        init_distributed(device=device)
    try:
        yield
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
