"""The `zignal-torch` CLI: zignal_tpu/cli/main.py's commands on the port
(reference: src/main.zig + src/cli/).

Subcommands are auto-discovered from the registry below (the reference
discovers them via comptime reflection, main.zig:10-21); each command
module provides `description`, `configure(parser)`, and `run(args)`.
A global `--log-level` flag mirrors the reference's runtime-filtered
logging (main.zig:25-38). A global `--device` names where every command
places its images: `cuda` unless `--device cpu` is given. Without a CUDA
device the default fails (exit code 1, one error line) before the
command runs; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from . import (
    blur_cmd, diff_cmd, display_cmd, edges_cmd, fdm_cmd, info_cmd,
    metrics_cmd, pipeline_cmd, qr_cmd, resize_cmd, tile_cmd, version_cmd,
)

COMMANDS = {
    "blur": blur_cmd,
    "diff": diff_cmd,
    "display": display_cmd,
    "edges": edges_cmd,
    "fdm": fdm_cmd,
    "info": info_cmd,
    "metrics": metrics_cmd,
    "pipeline": pipeline_cmd,
    "qr": qr_cmd,
    "resize": resize_cmd,
    "tile": tile_cmd,
    "version": version_cmd,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zignal-torch",
        description="PyTorch/CUDA image processing (zignal-compatible CLI)",
    )
    parser.add_argument(
        "--log-level", default="info",
        choices=["debug", "info", "warn", "err"],
        help="Log level (default: info)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device the commands run on (default: cuda; "
             "cpu runs the plain PyTorch versions on the host)",
    )
    sub = parser.add_subparsers(dest="command", metavar="<command>")
    for name, mod in COMMANDS.items():
        p = sub.add_parser(name, help=mod.description,
                           description=mod.description)
        mod.configure(p)
        p.set_defaults(_run=mod.run)
    return parser


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch device; raises when it names CUDA and no
    CUDA device is available."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    level = {"debug": logging.DEBUG, "info": logging.INFO,
             "warn": logging.WARNING, "err": logging.ERROR}[args.log_level]
    logging.basicConfig(level=level, format="%(levelname)s: %(message)s")
    if not getattr(args, "_run", None):
        parser.print_help()
        return 0
    try:
        args.device = resolve_device(args.device)
        return args._run(args) or 0
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 - CLI boundary
        logging.getLogger("zignal").error("%s", e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
