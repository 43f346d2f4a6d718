"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. device facts: torch/CUDA versions, the card's name and power limit,
   the time nvcc took to build the kernels from csrc/;
2. kernel vs plain PyTorch on the card over the oracle shapes of
   tests/test_pallas_pipeline.py (C in {1, 3, 4}, upscales, odd outputs,
   sigma in {0, 0.5, 1, 1.5, 2, 3.5}, Oklab on and off, a 1-px axis):
   u8 must be equal, Oklab within 5e-6 max-abs;
3. the main path: ImageBatch(..., device="cuda").resize_blur_oklab and
   ImageBatch.resize on B in {16, 4, 1} of 1024^2 RGB -> 512^2, sigma 2,
   with the kernel's launch count read around each call and the output
   checked against the plain version;
4. kernel and plain times at B=16 with CUDA events.
The last two lines are a JSON summary of the kernels and the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

OKLAB_TOL = 5e-6  # max-abs, kernel vs plain; the bound of the JAX tests
MAIN = dict(size=1024, out=512, sigma=2.0)
BATCHES = (16, 4, 1)
ORACLE = [  # (shape, out_rows, out_cols, sigma, oklab)
    ((2, 256, 256, 3), 128, 128, 2.0, False),
    ((2, 256, 256, 3), 128, 128, 2.0, True),
    ((1, 384, 512, 3), 192, 256, 2.0, False),
    ((1, 500, 400, 3), 128, 128, 2.0, False),
    ((1, 192, 256, 3), 128, 128, 0.5, False),
    ((1, 192, 256, 3), 128, 128, 1.0, False),
    ((1, 192, 256, 3), 128, 128, 3.5, False),
    ((1, 1080, 960, 3), 360, 640, 1.5, False),
    ((1, 300, 512, 3), 150, 300, 1.5, False),
    ((2, 256, 256, 4), 100, 100, 1.5, False),
    ((2, 256, 256, 1), 100, 190, 1.5, False),
    ((1, 256, 256, 3), 320, 288, 1.5, False),
    ((1, 256, 320, 3), 100, 150, 2.0, True),
    ((2, 300, 400, 3), 128, 128, 0.0, False),
    ((2, 300, 400, 3), 128, 128, 0.0, True),
    ((1, 37, 53, 3), 100, 9, 3.5, False),
    ((1, 37, 53, 3), 100, 9, 3.5, True),
    ((2, 1, 64, 3), 3, 32, 1.0, False),
    ((2, 64, 1, 4), 31, 1, 2.0, False),
]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from zignal_tpu_torch import ImageBatch
    from zignal_tpu_torch.ops import _build, fused_pipeline as fp

    # 1. device facts and the build
    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(card)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)

    # 2. kernel vs plain on the oracle shapes
    worst = 0.0
    for shape, oh, ow, sigma, oklab in ORACLE:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).cuda()
        got = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab)
        want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma, oklab)
        torch.cuda.synchronize()
        if oklab:
            err = float((got - want).abs().max())
            worst = max(worst, err)
            ok = err <= OKLAB_TOL and bool(torch.isfinite(got).all())
        else:
            err = int((got.int() - want.int()).abs().max())
            ok = err == 0
        print(f"oracle {shape}->{oh}x{ow} sigma={sigma} oklab={oklab}: "
              f"max_abs_err={err} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel != plain at {shape}->{oh}x{ow}")

    # 3. the main path through the user's entry points
    n, o, sigma = MAIN["size"], MAIN["out"], MAIN["sigma"]
    batches = {b: rng.integers(0, 256, (b, n, n, 3), np.uint8)
               for b in BATCHES}
    fp.LAUNCHES = 0
    outs = {}
    for b in BATCHES:
        for _ in range(3):
            before = fp.LAUNCHES
            ib = ImageBatch(batches[b], device="cuda")
            lab = ib.resize_blur_oklab((o, o), sigma=sigma)
            small = ib.resize((o, o))
            if fp.LAUNCHES != before + 2:
                raise AssertionError("the main path did not launch the "
                                     "kernel once per call")
        outs[b] = (ib, lab, small)
    torch.cuda.synchronize()
    launches = fp.LAUNCHES
    print(f"main path: {launches} kernel launches over "
          f"{3 * len(BATCHES)} resize_blur_oklab + resize calls")
    main_err = 0.0
    for b, (ib, lab, small) in outs.items():
        x = ib.device_array()
        want = fp.fused_resize_blur_oklab_reference(x, o, o, sigma)
        want_small = fp.fused_resize_blur_oklab_reference(x, o, o, 0.0,
                                                          oklab=False)
        if tuple(lab.shape) != (b, o, o, 3) or lab.dtype != torch.float32:
            raise AssertionError(f"bad output {lab.shape} {lab.dtype}")
        if not bool(torch.isfinite(lab).all()):
            raise AssertionError("non-finite Oklab output")
        err = float((lab - want).abs().max())
        main_err = max(main_err, err)
        if err > OKLAB_TOL or not torch.equal(small.device_array(),
                                              want_small):
            raise AssertionError(f"main path B={b} disagrees with plain")
        print(f"main path B={b}: resize_blur_oklab max_abs_err={err}, "
              "resize equal")
    worst = max(worst, main_err)

    # 4. times at B=16: plain, kernel, kernel, plain in one process
    x = outs[16][0].device_array()
    kern = lambda: fp.fused_resize_blur_oklab(x, o, o, sigma)  # noqa: E731
    plain = lambda: fp.fused_resize_blur_oklab_reference(x, o, o, sigma)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), \
        _time_ms(plain)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    gpix = 16 * n * n / 1e9  # input pixels, as bench.py counts them
    print(f"[{card}] B=16 {n}^2->{o}^2 sigma={sigma} kernel: "
          f"{k1:.4f} / {k2:.4f} ms ({gpix / (ms / 1e3):.2f} GPix/s)")
    print(f"[{card}] B=16 {n}^2->{o}^2 sigma={sigma} plain: "
          f"{p1:.4f} / {p2:.4f} ms ({gpix / (plain_ms / 1e3):.2f} GPix/s)")

    print(json.dumps({"kernels": [{
        "name": "fused_resize_blur_oklab",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/fused_resize_blur_oklab.cu",
        "replaces": "zignal_tpu/ops/pallas_pipeline.py:322",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
