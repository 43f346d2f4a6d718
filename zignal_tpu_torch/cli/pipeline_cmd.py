"""`zignal-torch pipeline` (reference: src/cli/pipeline.zig), copied from
zignal_tpu/cli/pipeline_cmd.py.

Applies an ordered list of steps from a .zon (or .json) recipe file;
each step's payload mirrors the matching CLI command's options. The
steps chain on the device: each takes the Image the previous one left
there (on the card a bilinear resize is K1, a gaussian blur K4)."""

from __future__ import annotations

import argparse
import json
import os

from .common import emit_display, log, resolve_output_target, run_batch

description = "Apply a sequence of operations described by a .zon recipe file."


def configure(parser):
    parser.add_argument("recipe", help="Recipe file (.zon or .json)")
    parser.add_argument("inputs", nargs="*", metavar="input",
                        help="Input image(s) (override recipe .input; "
                             "multiple inputs need a directory --output)")
    parser.add_argument("-o", "--output",
                        help="Output file (overrides recipe .output)")
    parser.add_argument("-d", "--display", action="store_true")
    parser.add_argument("--width", type=int)
    parser.add_argument("--height", type=int)
    parser.add_argument("--protocol")


def _load_recipe(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    from .zon import parse_zon

    recipe = parse_zon(text)
    if not isinstance(recipe, dict):
        raise ValueError("recipe must be a ZON struct with .input/.output/.steps")
    return recipe


def _apply_step(img, name: str, options: dict):
    from . import blur_cmd, edges_cmd, resize_cmd

    ns = argparse.Namespace(**{k.replace("-", "_"): v for k, v in options.items()})
    if name == "resize":
        rows, cols = resize_cmd.compute_target_dimensions(
            img.rows, img.cols, getattr(ns, "scale", None),
            getattr(ns, "width", None), getattr(ns, "height", None),
        )
        from .common import INTERPOLATION_NAMES

        method = INTERPOLATION_NAMES[getattr(ns, "filter", None) or "bilinear"]
        return img.resize((rows, cols), method)
    if name == "blur":
        defaults = dict(type="gaussian", radius=None, sigma=None, angle=None,
                        distance=None, center_x=0.5, center_y=0.5, strength=0.5)
        defaults.update(vars(ns))
        return blur_cmd.apply(img, argparse.Namespace(**defaults))
    if name == "edges":
        defaults = dict(filter="sobel", sigma=None, low=None, high=None,
                        window=None, nms=False)
        defaults.update(vars(ns))
        return edges_cmd.apply(img, argparse.Namespace(**defaults))
    raise ValueError(f"unknown pipeline step {name!r}")


def run(args):
    from ..image import Image

    recipe = _load_recipe(args.recipe)
    inputs = args.inputs or ([recipe["input"]] if recipe.get("input") else [])
    if not inputs:
        raise ValueError("no input image (recipe .input or positional)")
    output = args.output or recipe.get("output")
    steps = recipe.get("steps", [])
    if not steps:
        log.warning("recipe %s has no steps; output will equal input",
                    args.recipe)
    is_batch = len(inputs) > 1
    if is_batch and output and not (
            os.path.isdir(output) or output.endswith(os.sep)):
        raise ValueError(
            f"output path {output!r} is a file, but multiple input files "
            "were provided. batch output requires a directory."
        )

    def process(input_path):
        img = Image.load(input_path, device=args.device)
        for i, step in enumerate(steps):
            if not isinstance(step, dict) or len(step) != 1:
                raise ValueError(
                    f"step {i} must be a single {{name: options}} struct")
            (name, options), = step.items()
            img = _apply_step(img, name, options or {})
            log.info("step %d: %s -> %dx%d", i + 1, name, img.cols, img.rows)
        target = resolve_output_target(output, input_path, "_processed")
        if target:
            img.save(target)
        if args.display or not target:
            emit_display(img, args.protocol, args.width, args.height)

    return run_batch(inputs, process)
