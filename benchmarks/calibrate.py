"""Readings that the benchmark's limits and warm-up are set from, taken
in one process so that set-up is paid once; never part of a benchmark
run.

    python3 -m benchmarks.calibrate --workload CELL --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2 [--warmup 1.0] [--out FILE]

For each seed: a run of the program (``run.measure``) and the numbers it
compared; for each control seed: the same run with the reference in the
precision below the configuration's in the program's place, which must
come out not correct. ``--warmup`` overrides ``run.WARMUP_S``; with
``--timeline`` each program run also gives the mean latency of its first
100 requests against the rest, for choosing the warm-up.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmarks import run


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmarks.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--warmup", type=float, default=None)
    p.add_argument("--timeline", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if args.warmup is not None:
        run.WARMUP_S = args.warmup
    manifest = run.read_json(run.ROOT / "BENCHMARK.json")
    rows = []
    for kind, seeds in (("program", _seeds(args.seeds)),
                        ("control", _seeds(args.control_seeds))):
        for seed in seeds:
            a = run.parse(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--device",
                           args.device])
            result, record = run.measure(a, manifest, torch,
                                         control=kind == "control")
            row = {"kind": kind, "seed": seed, "correct": result["correct"],
                   "attempted": result["attempted"],
                   "checks": {k: v["value"]
                              for k, v in result["checks"].items()},
                   "metrics": {k: v["value"]
                               for k, v in result["metrics"].items()}}
            if args.timeline and kind == "program":
                lat = record.latency_ms
                row["timeline"] = {
                    "first_100_mean_ms": float(lat[:100].mean()),
                    "rest_mean_ms": float(lat[100:].mean()),
                    "first_10_ms": lat[:10].tolist()}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(dict(row, workload=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
