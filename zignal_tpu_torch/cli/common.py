"""Shared CLI helpers (reference: src/cli/common.zig): output target
resolution, batch processing with BatchIncomplete semantics, timing.

Copied from zignal_tpu/cli/common.py. ``Timer.log`` waits for the CLI's
device before it reads the clock, and ``emit_display``'s scaling is
``Image.resize`` on the image's device (on the card, one launch of the
fused resize kernel, K1).
"""

from __future__ import annotations

import logging
import os
import sys
import time

import torch

from ..enums import Interpolation

log = logging.getLogger("zignal")

INTERPOLATION_NAMES = {
    "nearest": Interpolation.NEAREST,
    "bilinear": Interpolation.BILINEAR,
    "bicubic": Interpolation.BICUBIC,
    "catmull_rom": Interpolation.CATMULL_ROM,
    "mitchell": Interpolation.MITCHELL,
    "lanczos": Interpolation.LANCZOS,
}


class BatchIncomplete(Exception):
    """At least one input failed (reference: main.zig error.BatchIncomplete)."""


class Timer:
    """Elapsed-ms logger (reference: cli/common.Timer) for work on
    ``device``: on a CUDA device it synchronizes before reading the clock,
    so that the ms include the work still queued there."""

    def __init__(self, label: str, device):
        self.label = label
        self.device = torch.device(device)
        self.start = time.perf_counter()

    def log(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = (time.perf_counter() - self.start) * 1000
        log.info("%s took %.1f ms", self.label, ms)


def resolve_output_target(output: str | None, input_path: str,
                          suffix: str = "") -> str | None:
    """Map --output (file or directory) to a concrete path
    (reference: common.resolveOutputTarget)."""
    if output is None:
        return None
    if os.path.isdir(output) or output.endswith(os.sep):
        base = os.path.basename(input_path)
        stem, ext = os.path.splitext(base)
        os.makedirs(output, exist_ok=True)
        return os.path.join(output, f"{stem}{suffix}{ext or '.png'}")
    return output


def run_batch(paths, fn) -> int:
    """Run fn(path) over all inputs, continuing past failures.
    Returns a non-zero exit code if any failed."""
    failed = 0
    for path in paths:
        try:
            fn(path)
        except Exception as e:  # noqa: BLE001 - CLI surfaces all errors
            log.error("%s: %s", path, e)
            failed += 1
    return 1 if failed else 0


def emit_display(img, protocol: str | None, width, height, out=None):
    """Render an image to the terminal, scaled on its device first when
    ``width`` or ``height`` is given."""
    from ..terminal.display import format_image

    if width or height:
        w = width or round(img.cols * (height / img.rows))
        h = height or round(img.rows * (width / img.cols))
        img = img.resize((int(h), int(w)))
    (out or sys.stdout).write(format_image(img, protocol or "auto"))
    (out or sys.stdout).write("\n")
