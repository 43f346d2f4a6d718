"""bench.py's six configs on the port, each checked before it is timed.

    python -m zignal_tpu_torch.bench [--device cuda|cpu] [--smoke]
                                     [--only NAME[,NAME]]

The configs, their order, their metric strings and their geometry, seeds
and repetitions are bench.py's (bench.py:685-699): ``north_star``,
``codec_roundtrip``, ``colorspace``, ``filter_fusion``, ``features``,
``fdm``. All run in this process, in that order. Each prints one JSON
line in bench.py's shape (``metric``, ``value``, ``unit``,
``vs_baseline``; the value unrounded) plus ``device`` (nvidia-smi's card
name and power limit, or ``cpu``), ``launches`` (K1, K2, K3, K3p, K4,
and DET and DESC, ORB's detect and describe kernels, read around the
config) and ``k1_streamed`` (those of K1's that took its streamed
kernel). The last line is a compact summary: the headline's fields and
``values``, each config's value.

Timing. Device configs go through ``profiling.measure`` (CUDA events on
the card, two chain lengths differenced), after the card has been kept
busy for a while: on a card that has idled the first chains read too
fast. Host-to-host configs read the host clock around work that ends in a
synchronize. As in bench.py the calls are chained on one input, so the
L2 cache is not flushed between them (``"l2_flushed": false``). No
profiler trace is taken here: a trace belongs early in a process of its
own (``chip_smoke.py --trace``).

Checks. Each config's output is held to its plain version on the same
inputs before it is timed: the north star's Oklab within 5e-6; the colour
chain's f32 values within 1e-4 (u8 alone would pass a copy of the input:
every chain the kernel accepts is the identity on u8) and its u8,
``equalize`` and ``autocontrast`` equal; the filter mask equal; config
1's PNG bytes, the ORB keypoints, descriptors and matches, the Hough
accumulator and lines and the canvas equal to the CPU's; FDM within 1 u8
step of the CPU at no more than 0.1 % of the values. A config that fails
prints an error line under its metric name, the others still run, and
the process exits 1.

``--device`` defaults to ``cuda`` and never falls back: without a card it
exits 1 with one error line and prints no number. ``--device cpu`` runs
the plain versions on the CPU (how the tests ask for it); ``--smoke``
takes bench.py's toy shapes (its ``ZT_BENCH_SMOKE=1``: 128^2, chains of 1
and 3).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _bounds
from .profiling import measure

__all__ = ["main", "synth_photo", "geometry", "input_shapes"]

_CONFIGS = ("north_star", "codec_roundtrip", "colorspace",
            "filter_fusion", "features", "fdm")

_METRIC_NAMES = {
    "north_star": "resize+blur+oklab pipeline throughput (single chip)",
    "codec_roundtrip": "end-to-end resize stream (JPEG decode -> resize"
                       " -> PNG encode, sustained)",
    "colorspace": "batched colorspace chain (rgb<->lab/oklch/xyb)"
                  " + equalize + autocontrast",
    "filter_fusion": "fused blur+sharpen+morphology+threshold",
    "fdm": "fdm style transfer (1 MPix, end-to-end)",
    "features": "ORB+match / Hough / Canvas stretch (512^2)",
}

OKLAB_TOL = 5e-6  # max-abs, kernel vs plain; the bound of the JAX tests
# f32 max-abs, K3 vs plain: K3's cube root is the card's cbrtf (1 ulp), the
# plain version's sign(x) * |x|^(1/3f), and the chains amplify that ulp
# where a channel is dark: 9.24e-5 over all 2^24 triples of the six chains
# (NVIDIA H100 80GB HBM3), rounded up; the u8 outputs are equal
CHAIN_UNIT = 1e-4
FDM_SHARE = 1e-3  # the CPU tests' bound: <= 1 u8 step at <= 0.1 % of values
SPACES = ("rgb", "lab", "rgb", "oklch", "rgb", "xyb", "rgb")
FILTER_BATCH = 16   # config 3's batch beside bench.py's one plane


def synth_photo(h, w, seed=0):
    """Deterministic photo-like test image (smooth structure + grain) so
    the bench is self-contained — no asset files needed.

    A byte-for-byte copy of bench.py:46-59 (the bench's input; the port
    imports nothing of the JAX tree)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    yy = yy.astype(np.float32)
    xx = xx.astype(np.float32)
    base = np.stack([
        128 + 90 * np.sin(xx / 97.0) * np.cos(yy / 53.0),
        128 + 80 * np.cos(xx / 61.0 + yy / 41.0),
        128 + 70 * np.sin((xx + yy) / 151.0),
    ], axis=-1)
    noise = rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def emit(lines, metric, value, unit, vs_baseline, **extra):
    """Print one JSON line and keep it in ``lines`` (bench.py:65-70)."""
    line = {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline}
    line.update(extra)
    lines.append(line)
    print(json.dumps(line), flush=True)


def geometry(smoke: bool) -> dict:
    """bench.py's sizes and repetitions, or its ZT_BENCH_SMOKE=1 ones."""
    return dict(
        dim=128 if smoke else 1024,
        # (B, n_small, n_large) of bench.py:150-151, two passes kept best
        north_star=((2, 1, 3), (1, 1, 3)) if smoke else
        ((16, 2, 12), (4, 3, 43), (1, 5, 165)),
        passes=1 if smoke else 2,
        codec_shape=(150, 200) if smoke else (1200, 1600),
        codec_count=2 if smoke else 12,
        colorspace_loops=(1, 3) if smoke else (2, 14),
        stage_loops=(1, 3) if smoke else (2, 30),
        filter_loops=(1, 3) if smoke else (5, 505),
        features_dim=128 if smoke else 512,
        orb_batch=4 if smoke else 8,
        fdm_dim=128 if smoke else 1024,
        fdm_loops=(1, 3) if smoke else (2, 42),
    )


def input_shapes(smoke: bool) -> dict:
    """Each config's input arrays' shapes, as bench.py makes them."""
    g = geometry(smoke)
    d, f, n = g["dim"], g["features_dim"], g["fdm_dim"]
    h, w = g["codec_shape"]
    return {
        "north_star": [(b, d, d, 3) for b, _, _ in g["north_star"]],
        "codec_roundtrip": [(h, w, 3)] * g["codec_count"],
        "colorspace": [(4, d, d, 3)],
        "filter_fusion": [(d, d, 1)],
        "features": [(f, f, 3)] * (g["orb_batch"] - 1) + [(512, 512, 3)],
        "fdm": [(n, n, 3), (n, n, 3)],
    }


class CheckFailed(Exception):
    """An output disagreed with its plain version: no number for it."""


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


@dataclass
class Run:
    """One bench process: where it runs, at which sizes, what it printed."""
    device: torch.device
    smoke: bool
    label: str   # nvidia-smi's "name, power limit", or "cpu"
    lines: list = field(default_factory=list)

    @property
    def geo(self) -> dict:
        return geometry(self.smoke)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def u8(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def host_s(self, fn) -> float:
        """Seconds of one call on the host clock, ended by a synchronize."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0

    def share(self, bound_ms: float, ms: float):
        """% of the card's bound a time reaches; None off the card."""
        return 100 * bound_ms / ms if self.device.type == "cuda" else None


def launch_counts() -> dict:
    """Kernel launches since import, by kernel."""
    from .ops import color_chain as cc
    from .ops import filter_chain as fc
    from .ops import fused_pipeline as fp
    from .ops import orb_describe, orb_detect
    from .ops import separable_conv as sc

    return {"K1": fp.LAUNCHES, "K2": fc.LAUNCHES, "K3": cc.LAUNCHES,
            "K3p": cc.PROBE_LAUNCHES, "K4": sc.LAUNCHES,
            "DET": orb_detect.LAUNCHES, "DESC": orb_describe.LAUNCHES}


def k1_streamed() -> int:
    """K1's launches since import that took its streamed kernel."""
    from .ops import fused_pipeline as fp

    return fp.STREAMED


def _timer(run: Run) -> str:
    return ("profiling.measure, CUDA events" if run.device.type == "cuda"
            else "profiling.measure, host clock")


# -- the six configs: each checks its outputs, then times them ---------------

def north_star_fn(dim: int):
    """bench.py:142-143's callable: the ImageBatch container's fused
    entry."""
    from .batch import resize_blur_oklab_fn
    from .enums import Interpolation

    return resize_blur_oklab_fn(dim // 2, dim // 2, 2.0,
                                Interpolation.BILINEAR)


def north_star_inputs(smoke: bool) -> list:
    """The B = 16, 4, 1 (smoke 2, 1) batches of bench.py:144-154."""
    rng = np.random.default_rng(0)
    d = geometry(smoke)["dim"]
    return [rng.integers(0, 256, (b, d, d, 3), dtype=np.uint8)
            for b, _, _ in geometry(smoke)["north_star"]]


def bench_north_star(run: Run):
    from .ops.fused_pipeline import fused_resize_blur_oklab_reference

    g = run.geo
    d, o = g["dim"], g["dim"] // 2
    chain = north_star_fn(d)
    results, err = {}, 0.0
    for (b, n_small, n_large), arr in zip(g["north_star"],
                                          north_star_inputs(run.smoke)):
        x = run.u8(arr)
        got = chain(x)
        want = fused_resize_blur_oklab_reference(x, o, o, 2.0)
        _require(tuple(got.shape) == (b, o, o, 3)
                 and got.dtype == torch.float32
                 and bool(torch.isfinite(got).all()),
                 f"B={b}: output {tuple(got.shape)} {got.dtype}")
        e = float((got - want).abs().max())
        _require(e <= OKLAB_TOL, f"B={b}: Oklab max_abs_err {e} > "
                 f"{OKLAB_TOL}")
        err = max(err, e)
        per = min(measure(chain, x, n_small=n_small, n_large=n_large)
                  for _ in range(g["passes"]))
        results[b] = b * d * d / per / 1e9
    # bench.py:162 reports the largest batch, not the fastest
    b_best = max(results)
    gpix = results[b_best]
    t_ms = 1e3 * b_best * d * d / gpix / 1e9
    nbytes = b_best * d * d * 3 + b_best * o * o * 3 * 4
    bound_ms, bound_by = _bounds.k1_bound(b_best, d, o)
    return gpix, "GPix/s", round(gpix / 0.1, 1), dict(
        scaling={f"{b}_mpix": round(v, 3) for b, v in results.items()},
        hbm_bytes_per_iter=nbytes,
        hbm_gb_s=round(nbytes / t_ms / 1e6, 1),
        ms_per_call=t_ms, k1_bound_ms=bound_ms,
        pct_of_k1_bound=run.share(bound_ms, t_ms), bound_by=bound_by,
        check=f"Oklab max_abs_err {err} <= {OKLAB_TOL} vs plain",
        timer=_timer(run))


def codec_corpus(smoke: bool) -> list:
    """bench.py:229-231's JPEGs (its synthetic corpus: no asset files)."""
    from .codecs import jpeg

    g = geometry(smoke)
    return [jpeg.encode(synth_photo(*g["codec_shape"], seed=100 + k),
                        quality=90) for k in range(g["codec_count"])]


def codec_once(jpg: bytes, device) -> bytes:
    """bench.py:233-237: JPEG decode -> Image.resize to half -> PNG."""
    from .codecs import jpeg, png
    from .image import Image

    arr, _ = jpeg.decode(jpg)
    out = Image.from_numpy(arr, device=device).resize(
        (arr.shape[0] // 2, arr.shape[1] // 2))
    return png.encode(out.to_numpy())


def bench_codec_roundtrip(run: Run):
    from .codecs import jpeg, png
    from .image import Image

    corpus = codec_corpus(run.smoke)
    h, w = run.geo["codec_shape"]
    mpix = h * w / 1e6
    for k, jpg in enumerate(corpus):
        _require(codec_once(jpg, run.device) == codec_once(jpg, "cpu"),
                 f"image {k}: PNG bytes differ from the CPU's")

    def once():
        return codec_once(corpus[0], run.device)

    t_lat = min(run.host_s(once) for _ in range(3))
    t_stream = min(run.host_s(lambda: [codec_once(j, run.device)
                                       for j in corpus]) for _ in range(2))
    sustained = len(corpus) * mpix / t_stream
    t_dec = run.host_s(lambda: [jpeg.decode(corpus[0]) for _ in range(3)]) / 3
    arr, _ = jpeg.decode(corpus[0])
    t_resize = min(run.host_s(lambda: Image.from_numpy(
        arr, device=run.device).resize((h // 2, w // 2)).to_numpy())
        for _ in range(3))
    out = Image.from_numpy(arr, device=run.device).resize(
        (h // 2, w // 2)).to_numpy()
    t_enc = run.host_s(lambda: [png.encode(out) for _ in range(3)]) / 3
    return sustained, "MPix/s", round(sustained / 100.0, 2), dict(
        single_image_latency_ms=round(t_lat * 1e3, 2),
        jpeg_decode_mpix_s=round(mpix / t_dec, 1),
        resize_with_h2d_d2h_ms=round(t_resize * 1e3, 3),
        png_encode_mpix_s=round(mpix / 4 / t_enc, 1),
        check=f"{len(corpus)} PNGs byte-equal to --device cpu",
        timer="host clock, ended by a synchronize")


def colorspace_step(x):
    """bench.py:358-366: the chain, then equalize(u8[0]) and
    autocontrast(u8[1])."""
    from .ops.enhancement import autocontrast, equalize
    from .pipeline import color_chain_u8

    u8 = color_chain_u8(x, SPACES)
    eq = equalize(u8[0])
    ac = autocontrast(u8[1] if u8.shape[0] > 1 else u8[0])
    return eq.to(torch.float32) + ac.to(torch.float32)


def colorspace_input(smoke: bool) -> np.ndarray:
    d = geometry(smoke)["dim"]
    return np.random.default_rng(1).integers(0, 256, (4, d, d, 3),
                                             dtype=np.uint8)


def bench_colorspace(run: Run):
    from .ops import color_chain as cc
    from .ops.enhancement import autocontrast, equalize
    from .pipeline import color_chain_u8

    x = run.u8(colorspace_input(run.smoke))
    u8 = color_chain_u8(x, SPACES)
    _require(torch.equal(u8, cc.fused_color_chain_u8_reference(x, SPACES)),
             "the chain's u8 differs from plain")
    f = cc.fused_color_chain_u8(x, SPACES, quantize=False)
    want = cc.fused_color_chain_u8_reference(x, SPACES, quantize=False)
    _require(f.shape == x.shape and f.dtype == torch.float32,
             f"the chain's f32 output {tuple(f.shape)} {f.dtype}")
    err = float((f - want).abs().max())
    _require(err <= CHAIN_UNIT, f"the chain's f32 values: max_abs_err "
             f"{err} > {CHAIN_UNIT}")
    for name, op, img in (("equalize", equalize, u8[0]),
                          ("autocontrast", autocontrast, u8[1])):
        _require(torch.equal(op(img).cpu(), op(img.cpu())),
                 f"{name} differs from plain on the CPU")

    npix = x.numel() // 3
    per = measure(colorspace_step, x, n_small=run.geo["colorspace_loops"][0],
                  n_large=run.geo["colorspace_loops"][1])
    # the stages in turns, in this process (timed apart, a stage once
    # read as -0.03 ms in bench.py's own record)
    stages = {"color_chain": (lambda v: color_chain_u8(v, SPACES), x,
                              run.geo["colorspace_loops"]),
              "equalize": (equalize, u8[0], run.geo["stage_loops"]),
              "autocontrast": (autocontrast, u8[1], run.geo["stage_loops"])}
    reads = {name: [] for name in stages}
    for _ in range(3):
        for name, (fn, arg, (n_small, n_large)) in stages.items():
            reads[name].append(measure(fn, arg, n_small=n_small,
                                       n_large=n_large))
    stage_s = {name: float(np.median(v)) for name, v in reads.items()}
    # one step alone, synchronized: what a caller who waits for each step
    # sees (in measure's chains the host enqueues a step while the card
    # runs the one before)
    host = min(run.host_s(lambda: colorspace_step(x)) for _ in range(3))
    floor_s = sum(stage_s.values())
    bound_ms, bound_by = _bounds.k3_bound(x)
    chain_ms = 1e3 * stage_s["color_chain"]
    gpix = npix / per / 1e9
    return gpix, "GPix/s", None, dict(
        ms_per_step=1e3 * per, host_clock_ms_per_step=1e3 * host,
        stage_ms={k: round(1e3 * v, 4) for k, v in stage_s.items()},
        stagewise_floor_gpix_s=round(npix / floor_s / 1e9, 3),
        pct_of_stagewise_floor=round(100 * floor_s / per, 1),
        k3_bound_ms=bound_ms, pct_of_k3_bound=run.share(bound_ms, chain_ms),
        bound_by=bound_by,
        check=f"f32 before quantization max_abs_err {err} <= {CHAIN_UNIT}; "
              "u8, equalize, autocontrast equal plain",
        timer=_timer(run))


def filter_inputs(smoke: bool):
    """bench.py:454-456's plane, then a batch of FILTER_BATCH planes."""
    d = geometry(smoke)["dim"]
    rng = np.random.default_rng(2)
    return (rng.integers(0, 256, (d, d, 1), dtype=np.uint8),
            rng.integers(0, 256, (FILTER_BATCH, d, d, 1), dtype=np.uint8))


def filter_step(x):
    """bench.py:451-452."""
    from .pipeline import filter_chain

    return filter_chain(x[..., 0], 2.0, 2, 128.0)


def bench_filter_fusion(run: Run):
    from .ops.filter_chain import fused_blur_sharpen_morph_reference

    d = run.geo["dim"]
    times = {}
    for arr, (n_small, n_large) in zip(filter_inputs(run.smoke),
                                       (run.geo["filter_loops"], (2, 12))):
        x = run.u8(arr)
        want = fused_blur_sharpen_morph_reference(
            x[..., 0].contiguous(), 2.0, 2, 128.0)
        _require(torch.equal(filter_step(x), want),
                 f"{tuple(x.shape)}: the mask differs from plain")
        b = x.numel() // (d * d)
        times[b] = measure(filter_step, x, n_small=n_small, n_large=n_large)
    gpix = {b: b * d * d / t / 1e9 for b, t in times.items()}
    bound_ms, bound_by = _bounds.k2_bound(1, d)
    return gpix[1], "GPix/s", None, dict(
        scaling={f"{b}_mpix": round(v, 3) for b, v in gpix.items()},
        hbm_bytes_per_iter=2 * d * d,
        ms_per_call=1e3 * times[1], k2_bound_ms=bound_ms,
        pct_of_k2_bound=run.share(bound_ms, 1e3 * times[1]),
        bound_by=bound_by,
        check="masks equal plain (1 plane and B=16)", timer=_timer(run))


def features_corpus(smoke: bool, device) -> list:
    """bench.py:565-581: the image, its view rotated by 0.2, seeds 50+i."""
    from .image import Image

    g = geometry(smoke)
    dim = g["features_dim"]
    img = Image.from_numpy(synth_photo(dim, dim, seed=5), device=device)
    rot = img.extract(img.get_rectangle(), angle=0.2)
    return [img, rot] + [Image.from_numpy(synth_photo(dim, dim, seed=50 + i),
                                          device=device)
                         for i in range(g["orb_batch"] - 2)]


def hough_lines(img):
    """bench.py:640-645: HoughTransform(256) of the Sobel edges and its
    lines at threshold 120."""
    from .ops.hough import HoughTransform

    hough = HoughTransform(256)
    acc = hough.compute(img.sobel())
    return acc, hough.find_lines(acc, threshold=120)


def draw_canvas(device):
    """bench.py:648-653: 50 lines and 50 circles on 512^2."""
    from .canvas import Canvas
    from .image import Image

    canvas = Canvas(Image.from_numpy(np.zeros((512, 512, 3), np.uint8),
                                     device=device))
    for i in range(50):
        canvas.draw_line((10 + i * 9, 20), (500 - i * 9, 490), (255, 128, 0))
        canvas.draw_circle((256, 256), 40 + i * 2, (0, 255, 128))
    return canvas.image


def _orb_rows(results) -> list:
    return [([(k.x, k.y, k.octave, k.size, k.response, k.angle) for k in kps],
             [d.bits.tobytes() for d in descs]) for kps, descs in results]


def _match_rows(matches) -> list:
    return [(m.query_idx, m.train_idx, m.distance) for m in matches]


def bench_features(run: Run):
    from .features.matcher import BruteForceMatcher
    from .features.orb import Orb
    from .image import Image
    from .ops.hough import HoughTransform

    corpus = features_corpus(run.smoke, run.device)
    k_batch, dim = len(corpus), run.geo["features_dim"]
    orb = Orb()
    matcher = BruteForceMatcher(cross_check=True, device=run.device)
    results = orb.detect_and_compute_batch(corpus)
    matches = matcher.match(results[0][1], results[1][1])
    acc, lines = hough_lines(corpus[0])
    canvas = draw_canvas(run.device)
    # the same workload on the CPU
    cpu = [Image.from_numpy(im.to_numpy().copy(), device="cpu")
           for im in corpus]
    cpu_results = orb.detect_and_compute_batch(cpu)
    _require(_orb_rows(results) == _orb_rows(cpu_results),
             "ORB keypoints or descriptors differ from the CPU's")
    _require(_match_rows(matches) == _match_rows(BruteForceMatcher(
        cross_check=True, device="cpu").match(cpu_results[0][1],
                                              cpu_results[1][1])),
             "the matches differ from the CPU's")
    cpu_acc, cpu_lines = hough_lines(cpu[0])
    _require(np.array_equal(acc, cpu_acc) and lines == cpu_lines,
             "the Hough accumulator or lines differ from the CPU's")
    _require(np.array_equal(canvas.to_numpy(), draw_canvas("cpu").to_numpy()),
             "the canvas differs from the CPU's")

    t_batch = run.host_s(lambda: orb.detect_and_compute_batch(corpus))
    t_match = run.host_s(lambda: matcher.match(results[0][1],
                                               results[1][1]))
    t_orb = 2 * t_batch / k_batch + t_match   # bench.py:594
    # the device part of one image's ORB (pyramid, FAST, NMS, Harris,
    # top-k, angle, BRIEF), bench.py's loops of 1 and 6
    plane = run.u8(orb._plane_host_np(corpus[0])[None])
    t_dev = measure(lambda p: orb.detect_and_compute_tensors(p)[1], plane,
                    n_small=1, n_large=6)
    edges = corpus[0].sobel()
    hough = HoughTransform(256)
    hough.compute(edges)
    t_hough = run.host_s(lambda: hough.find_lines(hough.compute(edges),
                                                  threshold=120))
    t_canvas = run.host_s(lambda: draw_canvas(run.device))
    total = t_orb + t_hough + t_canvas   # bench.py:664
    return total * 1000, "ms", None, dict(
        orb_ms=round(t_orb * 1000, 2), orb_batch=k_batch,
        orb_wall_ms_per_image=round(t_batch / k_batch * 1000, 2),
        orb_match_ms=round(t_match * 1000, 3),
        orb_device_ms_per_image=round(t_dev * 1000, 3),
        device_mpix_s=round(dim * dim / 1e6 / t_dev, 1),
        n_matches=len(matches), hough_ms=round(t_hough * 1000, 2),
        n_lines=len(lines), canvas_ms=round(t_canvas * 1000, 2),
        check="ORB, matches, Hough accumulator and lines, canvas equal the "
              "CPU's",
        timer="host clock, ended by a synchronize; the device ORB part by "
              + _timer(run))


def cast_target(h, w, seed=4):
    """bench.py:490-494's FDM target: crushed shadows, a warm cast."""
    t = synth_photo(h, w, seed).astype(np.float32) / 255.0
    t = t ** 2.2 * np.array([230.0, 180.0, 120.0]) + 20.0
    return np.clip(t, 0, 255).astype(np.uint8)


def fdm_inputs(smoke: bool):
    """bench.py:489-494: the source (seed 3) and its cast target."""
    n = geometry(smoke)["fdm_dim"]
    return synth_photo(n, n, seed=3), cast_target(n, n)


def fdm_transfer(src, tgt, device):
    """set_target, set_source, update as bench.py:496-506; returns the
    matched source Image."""
    from .fdm import FeatureDistributionMatching
    from .image import Image

    fdm = FeatureDistributionMatching()
    fdm.set_target(Image.from_numpy(tgt.copy(), device=device))
    work = Image.from_numpy(src.copy(), device=device)
    fdm.set_source(work)
    fdm.update()
    return work


def bench_fdm(run: Run):
    from . import fdm as fdm_mod
    from .fdm import FeatureDistributionMatching
    from .image import Image

    src_np, tgt_np = fdm_inputs(run.smoke)
    n = src_np.shape[0]
    got = fdm_transfer(src_np, tgt_np, run.device).to_numpy()
    want = fdm_transfer(src_np, tgt_np, "cpu").to_numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d != 0).mean())
    _require(d.max() <= 1 and share <= FDM_SHARE,
             f"{share:.2%} of values differ from the CPU's, max "
             f"{int(d.max())}")

    src = Image.from_numpy(src_np, device=run.device)
    fdm = FeatureDistributionMatching()
    fdm.set_target(Image.from_numpy(tgt_np, device=run.device))
    fdm.set_source(src.copy())
    fdm.update()   # warm
    times = []
    for _ in range(3):
        work = src.copy()
        times.append(run.host_s(lambda: (fdm.set_source(work),
                                         fdm.update())))
    t = min(times)
    psnr, ssim = src.psnr(work), src.ssim(work)
    # the device part of an update (bench.py:519-545): the statistics,
    # with their one copy to the host as update() makes it, and the pixel
    # map under an identity transform
    w, bias = np.eye(3), np.zeros(3)

    def device_step(dev):
        x = fdm_mod._unit(dev).reshape(-1, 3)
        fdm_mod._mean_cov(x)
        return fdm_mod._apply_map(x, w, bias)

    t_dev = measure(device_step, src._device()[..., :3],
                    n_small=run.geo["fdm_loops"][0],
                    n_large=run.geo["fdm_loops"][1])
    return n * n / 1e6 / t, "MPix/s", None, dict(
        device_mpix_s=round(n * n / 1e6 / t_dev, 1),
        psnr_vs_source=round(float(psnr), 2),
        ssim_vs_source=round(float(ssim), 4),
        check=f"{share:.4%} of values 1 step off the CPU's (<= "
              f"{FDM_SHARE:.1%})",
        timer="host clock, ended by a synchronize; device_mpix_s by "
              + _timer(run))


_BENCHES = {"north_star": bench_north_star,
            "codec_roundtrip": bench_codec_roundtrip,
            "colorspace": bench_colorspace,
            "filter_fusion": bench_filter_fusion,
            "features": bench_features, "fdm": bench_fdm}


# -- the process: arguments, the configs in turn, the summary ----------------

def _card_label(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def _warm(device: torch.device, seconds: float = 2.0) -> None:
    """Keep the card busy before the first timing: on a card that has idled
    ``measure``'s first chains read below the kernels' own time."""
    a = torch.rand(4096, 4096, device=device)
    b = torch.empty_like(a)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            torch.mm(a, a, out=b)
        torch.cuda.synchronize(device)


def run_config(run: Run, name: str) -> bool:
    """One config: its line, an error line if anything failed; True when
    it passed."""
    run.sync()
    before, streamed = launch_counts(), k1_streamed()
    try:
        value, unit, vs_baseline, extra = _BENCHES[name](run)
        extra["l2_flushed"] = False
        ok = True
    except Exception as e:  # noqa: BLE001 - the others still run
        traceback.print_exc(file=sys.stderr)
        kind = "check failed" if isinstance(e, CheckFailed) else repr(e)
        value, unit, vs_baseline = None, "error", None
        extra = {"error": f"{kind}: {e}"[:300]}
        ok = False
    run.sync()
    after = launch_counts()
    emit(run.lines, _METRIC_NAMES[name], value, unit, vs_baseline,
         device=run.label,
         launches={k: after[k] - before[k] for k in after},
         k1_streamed=k1_streamed() - streamed, **extra)
    return ok


def summary(lines) -> dict:
    """The closing line: the headline's fields (the north star, else
    config 1, as bench.py:993-1008) and every config's value."""
    values = {name: None for name in _CONFIGS}
    by_metric = {v: k for k, v in _METRIC_NAMES.items()}
    head = None
    for line in lines:
        name = by_metric[line["metric"]]
        values[name] = line["value"]
        if line["value"] is not None and name in ("north_star",
                                                  "codec_roundtrip"):
            if head is None or name == "north_star":
                head = line
    out = {k: head[k] for k in ("metric", "value", "unit", "vs_baseline",
                                "device")} if head else {}
    out.update(summary=True, values=values)
    return out


def _names(text: str) -> tuple:
    names = tuple(n for n in text.split(",") if n)
    bad = [n for n in names if n not in _CONFIGS]
    if bad or not names:
        raise argparse.ArgumentTypeError(
            f"unknown config(s) {bad}; expected names from {_CONFIGS}")
    return names


def main(argv=None) -> int:
    from .cli.main import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m zignal_tpu_torch.bench",
        description="bench.py's six configs on the port, checked before "
                    "they are timed.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; no fallback)")
    parser.add_argument("--smoke", action="store_true",
                        help="bench.py's toy shapes (ZT_BENCH_SMOKE=1)")
    parser.add_argument("--only", type=_names, default=_CONFIGS,
                        help="comma-separated configs to run")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"zignal_tpu_torch.bench: {e}", file=sys.stderr)
        return 1
    run = Run(device, args.smoke, _card_label(device))
    if device.type == "cuda":
        _warm(device)
    names = [n for n in _CONFIGS if n in args.only]
    passed = [run_config(run, name) for name in names]
    print(json.dumps(summary(run.lines), separators=(",", ":")), flush=True)
    return 0 if all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
