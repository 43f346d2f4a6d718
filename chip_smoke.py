"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --times [TREE]   # every kernel's times alone
    python3 chip_smoke.py --ops            # cbrtf's and powf's costs
    python3 chip_smoke.py --profile        # phases 20 and 26, profiled
    python3 chip_smoke.py --trace DIR      # phase 34's calls, traced
    python3 chip_smoke.py --lane           # phase 36 alone

``--times`` runs on the package found first on TREE (a checkout of another
commit, e.g. the parent's ``git archive``) or on this one: K1 at B 16, 4
and 1 (and, where the tree has both, its tile and its streamed kernel at
each shape of K1_PAIRS) and its plain resize, K3 at B 4 and 16, K2
(sigma 2 r 2, sigma 1 r 1 and sigma 1.5 r 3, at B 16 and 1) and K4
(with K4's library call), K3's chains of 1, 5 and 9 hops with what a
cube root costs inside the kernel (a diagnostic), and each tile of K1, K2
and K4 alone at B=16.
``--ops`` builds csrc/measure/transcendental_rate.cu and prints what a
cbrtf and a powf cost with every SM busy, the basis of CBRTF_OPS and
POWF_OPS in the bounds.
``--profile`` runs each phase-20 call (the geometric ops, motion blurs and
metrics at B=16 of 1024^2) and each of phase 26's device calls but the QR
decode (colormaps, flood fill, Perlin noise, kitty) under torch.profiler
and prints its device time a call and the five kernels or copies that
take the most.

Phases (any failure raises and exits non-zero):
1. device facts: torch/CUDA versions, the card's name and power limit,
   the time nvcc took to build the kernels from csrc/ and g++ the host
   codec library from csrc/host/ (it must load);
2. K1 (fused resize -> blur -> Oklab) vs plain PyTorch on the card over
   the oracle shapes of tests/test_pallas_pipeline.py (C in {1, 3, 4},
   upscales, odd outputs, sigma in {0, 0.5, 1, 1.5, 2, 3.5}, Oklab on and
   off, a 1-px axis): u8 must be equal, Oklab within 5e-6 max-abs; then
   K1 at the edges of its tile plans (outputs of 1-130 px around each
   tile side, B 1 and 16, sigma 0-3.5, C 1-5);
3. K1's main path: ImageBatch(..., device="cuda").resize_blur_oklab and
   ImageBatch.resize on B in {16, 4, 1} of 1024^2 RGB -> 512^2, sigma 2,
   with the kernel's launch count and fused_pipeline.STREAMED read around
   each call (resize_blur_oklab streams at each B, the plain resize takes
   the tile kernel) and the output checked against the plain
   version; at B=16 the streamed kernel against the tile kernel (bitwise,
   u8 and Oklab) and the plain version; then the repaired faults, each
   with its kernel's launch count read around it: F1, filter_chain and
   resize_blur_oklab on strided views (K2, K1), F2, u8 bilinear resize of
   2, 5 and 8 channels (K1 in channel groups), F3, gaussian_blur of 5 and 8
   channels and a 6-channel resize band (K4 in channel groups);
4. K1 and plain times at B=16 with CUDA events;
5. K2 (the filter chain) vs plain on the card over the shapes of
   tests/test_pallas_filter.py, tiny planes and thresholds of 127.5, -1
   and 300, then at the edges of its tile plans (planes of 63-129 px at
   B=1 and B=16, sigma 0-3.5, r 1-3): outputs must be equal;
6. K4 (the separable u8 convolution) vs plain on the card: every border
   at sigma 1 and 2, a signed 5-tap kernel (the int32 route), C in 1-4,
   planes of 63-129 px, 1-px axes and a 2:1 bilinear band: outputs must
   be equal;
7. the filter main paths: pipeline.filter_chain on [16, 1024, 1024] and
   [1, 1024, 1024] u8 (K2), and ImageBatch of [16, 1024, 1024, 3] RGB
   with .gaussian_blur and .convolve_separable (K4) and .sharpen,
   .box_blur and .dilate_binary (plain ops on the card), with the launch
   counts zeroed just before and read just after, and every output
   checked against its plain version;
8. K2 times at B=16 and B=1 and K4 times at sigma 2 and 1 (B=16 RGB)
   against plain, with CUDA events and the profiler's device time, and
   K4's library call (depthwise F.conv2d on the reflect-padded batch)
   timed and checked beside it;
9. the colour main paths, each with the launch counts zeroed just before
   and read just after, and every output checked against its plain version
   on the card: pipeline.color_chain_u8 on [4, 1024, 1024, 3] and
   [16, 1024, 1024, 3] (K3, and K3p once, before K3's first launch), the
   config-2 step of bench.py (color_chain_u8 -> equalize(u8[0]) ->
   autocontrast(u8[1])), the colorspace step (equalize of four photo-like
   camera frames of 4608x3456 made on the card: the histogram, tables and
   lookup kernels once each, HIST_LAUNCHES, TABLE_LAUNCHES and
   LUT_LAUNCHES printed beside K3's count, the histograms and the
   equalized bytes equal to the plain version's on the card and the bytes
   to the CPU's, most of them moved; then pipeline.color_chain_values(...,
   ("rgb", "lab")): K3 once, counted by VALUES, the Lab values within
   CHAIN_UNIT of the plain version on the card),
   and ImageBatch of [16, 1024, 1024, 3] RGB through
   .resize((512, 512)).gaussian_blur(1.5).autocontrast(0.01)
   .convert(Gray).equalize() (K1, K4) and .convert(Gray)
   .threshold_otsu();
10. K3p (the transcendental probe) vs plain on (8, 128), on 1M values in
   [0, 2], on n in {1, 3, 5, 1023, 2^20 + 3} and on views offset by 4
   bytes (its scalar head and scalar stores): max relative error <= 1e-6;
11. K3 (the fused colour chain) vs plain on all 2^24 RGB triples for each of
   the six chains of tests/test_pallas_color.py: u8 equal, and f32 before
   the quantization within 1e-4 max-abs (CHAIN_UNIT; every such chain is
   the identity on u8, so the u8 check alone would pass a copy); then
   small and odd shapes and the extreme-values plane;
12. K3 and plain times at B=4 and B=16 of 1024^2 on the bench chain, and
   equalize, autocontrast and the config-2 step at the same B, timed in
   turns in this one process, and K3's bound on this batch; then the
   colorspace step, its equalize and K3's values route alone; then the
   equalize passes alone on its frames (the histogram, the tables, the
   lookup; profiler device time) beside their bounds, and the kernels
   together beside the plain equalize and the library's histc + gather;
13. the resize, convolution, order-statistic, edge and pyramid paths, each
   through the user's entry point and with the launch counts zeroed just
   before and read just after: ImageBatch of [16, 1024, 1024, 3] RGB
   through .resize to 512^2 with each of the six methods and to
   1536x1280, .letterbox((512, 768)), .convolve (a 3x3 sharpen; a 5x5
   kernel under ZERO), the six order-statistic blurs, .sobel, .canny,
   .shen_castan and .threshold_adaptive_mean, and ImagePyramid.build of
   one 1024^2 gray plane with 8 levels; K1 must launch once for the
   bilinear resize, once for the letterbox and 7 times for the pyramid,
   K4 once for the pyramid;
14. each phase-13 output on image 0 against the same call on the CPU: u8
   equal (canny and shen_castan print the count of differing pixels),
   the float resize, Sobel gradients, the float Gaussian and the ISEF
   within 1e-4 max-abs on 0-255 data (the CPU tests' bound); and a
   [2, 3, H, W, 3] resize on the card against the CPU;
15. each phase-13 call timed with CUDA events after a warm-up;
16. BASELINE config 1 (bench.py:199-260): 12 seeded JPEGs of 1200x1600
   through Image.load_from_bytes(..., device="cuda").resize((600, 800))
   and PNG encode, K1 read around each image, every PNG equal to the same
   flow on the CPU; single-image latency, sustained MPix/s and the split
   into decode, H2D, resize, D2H and encode; Image.gaussian_blur (K4);
17. the north star from files: 16 files of 1024^2 RGB (PNG and JPEG) ->
   ImageBatch.from_paths(..., device="cuda") -> .resize_blur_oklab((512,
   512), sigma=2), K1 once a call, Oklab within 5e-6 of the same call on
   the CPU (first 4 files) and the saved u8 resize equal to the CPU's;
   host-to-host ms from the pinned loader and from a pageable
   ImageBatch(np_array, device="cuda"), in turns;
18. BatchLoader over 64 files of mixed sizes (36 letterboxed on the card),
   batch 16, shape (1024, 1024), each batch through resize_blur_oklab:
   every batch equal to the CPU's; ms a batch with one batch in flight and
   loaded one after another, in turns;
19. ImageBatch's item-10 members on [16, 1024, 1024, 3] (invert, the
   flips, fill, set_border, convert(Gray), blend in every mode) against
   the same calls on the CPU on image 0, to_images / from_images on the
   whole batch, and their times.
20. the geometric sampling, motion blur and metrics through ImageBatch of
   [16, 1024, 1024, 3] RGB on the card: .rotate(0.5), .rotate(pi / 2),
   .extract(rect, 0.3, (512, 512)), .crop (partly outside), .warp of a
   ProjectiveTransform with BILINEAR and BICUBIC, .insert of an RGBA Image
   with OVERLAY, .motion_blur of linear(0, 9), linear(0.7, 9),
   radial_zoom() and radial_spin() (with the seconds their coordinates
   take to build), then .psnr, .ssim, .mean_pixel_error and .diff against
   the linear(0, 9) copy; the launch counts are read around each call:
   K4 launches once for linear(0, 9) and nowhere else, K1-K3 never;
21. each phase-20 output on image 0 against the same call on the CPU: u8
   equal, the diff equal, the f32 metrics within 1e-5 relative (the CPU
   tests' bound);
22. each phase-20 call timed with CUDA events after a warm-up;
23. BASELINE config 4 (bench.py:483-554): FDM of a 1024^2 synth_photo
   (seed 3) to the cast target of bench.py:490-494 (seed 4) through
   FeatureDistributionMatching.set_target, .update and .match_batch of
   B=4 on the card (no kernel may launch), PSNR and SSIM against the
   source, and image 0 of each against the same calls on the CPU: at
   most 1 u8 step at no more than 0.1 % of the values (the CPU tests'
   bound; the same bits are expected);
24. BASELINE config 5 (bench.py:556-680): Orb().detect_and_compute_batch
   of 8 images of 512^2 (image 0, its view rotated by 0.2 rad, 6 more),
   with the launch counts zeroed just before and read just after (K4
   once, K1 n_levels - 1 = 7 times: one pyramid for the stack; ORB's
   detect kernel once: one atlas of the kept levels), a
   cross-checked BruteForceMatcher of images 0 and 1, HoughTransform(256)
   of Image.sobel() with find_lines(threshold=120), 50 lines and 50
   circles on a Canvas; ORB of images 0 and 1, the matches, Sobel, the
   accumulator and the canvas equal to the same calls on the CPU;
25. each stage of configs 4 and 5 timed with CUDA events and the host
   clock, then one update split into upload, statistics, host SVD, map
   and D2H, and one ORB batch into pyramid and atlas, the detect kernel
   (FAST, NMS and Harris) with the plain route's detect beside it, the
   top-k sorts and the whole device path with its D2H;
25b. ORB's detect kernel at the orb_stereo cell's shape (8 frames of
   376 x 1241, ORB-SLAM2's KITTI settings, their 8-level atlas) equal bit
   for bit to its plain route, with Harris's response and with the FAST
   score, then timed (plain, kernel, kernel, plain by CUDA events, the
   kernel's profiler device time) beside its bound;
25c. ORB's describe kernel at the same shape, on the keypoints the detect
   and select stages choose: rows, descriptors and validity equal bit for
   bit to its plain route, then timed the same way beside its bound; one
   ORB request with the detect and describe launch counters set to 0
   just before it (one launch each); the request's stages by CUDA events
   (pyramid and atlas, detect, select, describe, the match), the plain
   describe beside the kernel (``--orb`` runs phases 25b and 25c alone).
26. the tenth slice's device paths on the card, each output on the card
   and equal to the same call on the CPU: ImageBatch.apply_colormap of
   [16, 1024, 1024, 3] with each of the five maps at the auto range (image
   1 narrowed to 0..51) and at (13, 200) (images 0, 1 and 15 checked),
   Image.apply_colormap at (0, 50); Image.flood_fill of a 1024^2 spiral
   (corridor 16 wide) in SEED and NEIGHBOR mode at connectivity 4 and 8,
   equal to the corridor, with the iterations printed, and
   ImageBatch.flood_fill of 16 spirals (image 0 checked); perlin_array of
   a 1024^2 grid, 4 octaves; qrcode_decode of a version-10 qrcode_encode
   pasted into a 1024^2 synth_photo (the text must come back); kitty of a
   1024^2 CUDA Image scaled to 512, the launch counts zeroed just before
   and read just after: K1 once and no other kernel;
27. the host paths on this machine's build of the native library, with
   every Python fallback made to raise: GIF encode and decode of a
   1200x1600 synth_photo in each dither mode (the decoded frame must be
   the quantized image), an 8-frame animated GIF of 512^2 and the sixel of
   a 512^2 image (its bands equal to the Python emitter's, run after);
28. each call of phases 26-27 timed: CUDA events after a warm-up for the
   device paths, the best host clock of 3 for the host paths.
29. the zignal-torch CLI on the card through cli.main.main, each command
   also run with --device cpu on the same files (outputs and stdout
   equal; FDM within phase 23's bound, the metrics within 1e-5
   relative), the launch counts read around each: resize --scale 0.5 of
   phase 16's 12 JPEGs (written without an extension, so the outputs are
   config 1's 600x800 PNGs; K1 12 times) and with --filter lanczos (no
   kernel), blur --type gaussian --sigma 2 (K4 12 times), pipeline of a
   .zon recipe (resize 0.5 -> gaussian 2 -> sobel; K1 and K4 12 times
   each), fdm of phase 23's 1024^2 source to its cast target, tile of 4
   of the resized PNGs in each of the five modes, display --protocol
   kitty --width 512 of the 1024^2 source (K1 once), blur of that source
   (K4 once), diff and metrics of the source and its blurred copy, qr
   encode -o and decode (the text must come back), info --stats and
   version; then python3 -m zignal_tpu_torch.cli --device cuda resize in
   a subprocess (its PNG equal to the CLI's); GlobalOptimizer(seed=7):
   15 rounds of ask(8) told CUDA tensors, equal to the same rounds told
   numpy; solve_assignment_problem of a seeded 256x256 Matrix equal to
   scipy's linear_sum_assignment;
30. each phase-29 command on the card timed, the best host clock of 3;
   resize in ms an image and MPix/s beside phase 16's config 1, and its
   split into Image.load, resize and save.
31. the mesh on the card: a process group of this process alone on NCCL
   (the backend is checked), a 1-D and a 1x1 (batch, space) mesh, and
   with every launch count and the collective counts zeroed just before
   and read just after: parallel.sharded_pipeline of B=16 1024^2 ->
   512^2 sigma 2 (K1), ImageBatch(..., mesh=).resize_blur_oklab (K1),
   the dry run's chains (resize -> gaussian_blur -> Gray -> equalize on
   the 1-D mesh, K1 and K4; gaussian_blur -> box_blur -> autocontrast on
   the 1x1 mesh, K4), every spatial function on one 4096^2 RGB
   synth_photo (spatial_gaussian_blur sigma 2 in all four borders, K4
   each; spatial_op, box blur, sharpen, the adaptive threshold, Sobel,
   dilate, erode, median, histogram, equalize, SSIM and the image's mean
   and covariance), global_mean_cov of the batch and match_sharded of a
   1024^2 source to phase 23's cast target; then each output against
   the same call without a mesh: u8 and the Oklab equal, SSIM within
   1e-5, the statistics within the CPU tests' bounds of f64, FDM within
   1 u8 step at under 2 % of values;
32. dryrun_multichip(1, device="cuda") in this process (NCCL) and
   dryrun_multichip(4, device="cpu") on 4 spawned gloo CPU ranks;
33. each phase-31 call timed with CUDA events after a warm-up, beside the
   same call without a mesh (what the halo exchange and the crop cost on
   one card);
34. zignal_tpu_torch.profiling on the card, the launch counts zeroed just
   before and read just after: (a) measure of ImageBatch.resize_blur_oklab
   (B=16 of 1024^2 -> 512^2, sigma 2: K1) and of pipeline.filter_chain
   (B=16 of 1024^2 gray, sigma 2, r 2, thr 128: K2) with their input
   pixels, seconds a call and GPix/s beside _time_ms of the same call,
   each output against its plain version (Oklab within 5e-6, the mask
   equal); (b) trace of one call of each into a temporary directory, in
   a fresh process (``--trace DIR``), whose JSON must hold a K1 and a K2
   kernel event on the card (path and durations printed); (c) Profile of config 1's three stages for one of
   its JPEGs (Image.load, the K1 resize with a synchronize inside the
   stage, the PNG save), its report printed;
35. entry() once on the card (its batch a tensor there, K1 once, Oklab
   within 5e-6 of plain), then ``python -m zignal_tpu_torch.bench`` at
   full size in a subprocess: bench.py's six configs, each checked before
   it is timed; the phase requires exit 0, the six metric names in order
   with a positive value, a passed check and this card's name on each,
   a summary under 2000 bytes whose values hold all six, and K1, K2, K3,
   K4 launched (K3p once); the bench's lines are printed and its launches
   join the kernels line;
36. the lane_hough cell's request (8 road frames of 1241 x 376 from
   benchmarks/sources/device_road.py): Canny and HoughTransform.lines_batch
   on the card against the CPU route, bit for bit (edges, accumulators,
   line rows, validity); the Canny front, hysteresis and vote kernels
   each against its plain route on the card, the lines kernel against
   find_lines' own on the host; a request's host waits after the first
   (none, by torch's sync debug mode); the request's split by CUDA events
   on the kernels and on the plain route, and each kernel's time against
   its bound, the vote's from the request's own edges and votes
   (``--lane`` runs this phase alone).
The last two lines are a JSON summary of the kernels (K3's with the
launches of its values route, ``values``; the ORB detect and describe
kernels' and the lane_hough kernels', with the launches of one request,
its counters set to 0 before it, in phases 25c and 36; each with its
bound: the larger of its bytes over 3.35 TB/s and its operations over 67
TFLOP/s, the H100's published peaks, a cube root and a gamma curve
counted at CBRTF_OPS and POWF_OPS) and the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from zignal_tpu_torch._bounds import CBRTF_OPS, F32_OPS_S, describe_bound, \
    detect_bound, front_bound, hist_bound, hysteresis_bound, k1_bound, \
    k2_bound, k3_bound, k3p_bound, k4_bound, lut_bound, vote_bound
from zignal_tpu_torch.bench import CHAIN_UNIT, FDM_SHARE, OKLAB_TOL, \
    cast_target, synth_photo
from zignal_tpu_torch.bench import SPACES as BENCH_CHAIN

# the kernels' names in the profiler's rows (this tree's and the parent's)
K1_NAMES = ("fused_kernel", "resize_blur_kernel")
K2_NAME = "filter_kernel"
K3_NAMES = "color_chain_kernel"
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
FILTER_BATCH = 16
FILTER_ORACLE = [  # (shape, sigma, sharpen_radius, thr)
    ((256, 256), 2.0, 2, 128.0),
    ((128, 384), 1.0, 1, 90.0),
    ((192, 128), 3.5, 3, 200.0),
    ((1000, 1000), 2.0, 2, 128.0),
    ((1080, 500), 2.0, 2, 128.0),
    ((100, 130), 2.0, 2, 128.0),
    ((3, 128, 256), 1.5, 2, 128.0),
    ((1, 64), 2.0, 2, 128.0),
    ((64, 1), 2.0, 2, 128.0),
    ((5, 7), 2.0, 2, 128.0),
    ((1, 1), 2.0, 2, 128.0),
    ((256, 256), 2.0, 2, 127.5),
    ((256, 256), 2.0, 2, -1.0),
    ((256, 256), 2.0, 2, 300.0),
]
_SIGNED = (-0.25, 0.5, 1.5, 0.5, -0.25)
# K2 and K4 at the edges of their tile plans: planes just below, at and
# above the tile sides, B=1 and B=16, the blur widths of the main paths;
# then K2's streamed plan: one and two strip widths (120 columns), one and
# two segments (9 rows), heights under its 20-row warm-up
EDGE_PLANES = ((16, 63, 129), (1, 64, 65), (1, 127, 63), (16, 129, 127),
               (1, 65, 64), (16, 9, 120), (1, 19, 121), (16, 21, 241),
               (1, 18, 240), (16, 75, 1024))
EDGE_SIGMAS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.5)
EDGE_THRESHOLDS = (127.5, -1.0, 300.0)
CONV_EDGE_SHAPES = ((2, 63, 129), (1, 65, 64), (1, 1, 64), (1, 64, 1))
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


def _u8(rng, shape):
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).cuda()


def _max_err(got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"bad output {got.shape} {got.dtype}")
    return int((got.int() - want.int()).abs().max())


def _check_equal(label, got, want) -> int:
    torch.cuda.synchronize()
    err = _max_err(got, want)
    print(f"{label}: max_abs_err={err} {'ok' if err == 0 else 'FAIL'}")
    if err:
        raise AssertionError(f"kernel != plain: {label}")
    return err


def _check_all(label, pairs) -> int:
    """Every (kernel, plain) pair equal; one line for the lot."""
    torch.cuda.synchronize()
    worst = max(_max_err(got, want) for got, want in pairs)
    print(f"{label}: {len(pairs)} cases, max_abs_err={worst} "
          f"{'ok' if worst == 0 else 'FAIL'}")
    if worst:
        raise AssertionError(f"kernel != plain: {label}")
    return worst


def _device_ms(fn, kernel_name, reps: int = 20) -> float:
    """ms of device time a call of the kernels whose name holds
    ``kernel_name`` (or one of a tuple of names), from torch.profiler over
    ``reps`` calls. The profiler now and then records no kernel row for a
    window; such a window is taken again, up to 3 times, and then it
    raises."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                 for e in prof.key_averages()
                 if any(name in e.key for name in names))
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"the profiler recorded no {names} kernel")


def _library_conv(x, k):
    """One PyTorch call per axis for the same function as K4 (the port
    never calls it): depthwise ``F.conv2d`` in f32, TF32 off, of the u8
    batch cast to f32 and padded with ``reflect`` (MIRROR while the
    radius is below the axis length), the 8.8 integer taps as weights.
    Returns (call, its int32 output in [B, H, W, C])."""
    import torch.nn.functional as F
    from zignal_tpu_torch.ops.tables import _kernel_to_int

    torch.backends.cudnn.allow_tf32 = False
    c, r = x.shape[-1], len(k) // 2
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (r, r, r, r), mode="reflect")
    t = torch.from_numpy(_kernel_to_int(k).astype(np.float32)).cuda()
    wx = t.view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    wy = t.view(1, 1, -1, 1).repeat(c, 1, 1, 1)

    def call():
        return F.conv2d(F.conv2d(xp, wx, groups=c), wy, groups=c)

    return call, call().permute(0, 2, 3, 1).to(torch.int32)


def _filter_phases(card, rng):
    """Phases 5-8: K2 and K4. Returns their entries of the kernels line."""
    from zignal_tpu_torch import BorderMode, ImageBatch, pipeline
    from zignal_tpu_torch.ops import binary, integral, tables
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import separable_conv as sc
    from zignal_tpu_torch.ops.convolution import _div_clamp_u8, \
        convolve_separable, convolve_separable_reference
    from zignal_tpu_torch.ops.tables import SCALE

    # 5. K2 vs plain: the TPU tests' shapes, then the tile-plan edges
    for shape, sigma, r, thr in FILTER_ORACLE:
        x = _u8(rng, shape)
        _check_equal(f"K2 {shape} sigma={sigma} r={r} thr={thr}",
                     fc.fused_blur_sharpen_morph(x, sigma, r, thr),
                     fc.fused_blur_sharpen_morph_reference(x, sigma, r, thr))
    cases = []
    for shape in EDGE_PLANES:
        x = _u8(rng, shape)
        cases += [(x, sigma, r, 128.0) for sigma in EDGE_SIGMAS
                  for r in (1, 2, 3)]
        cases += [(x, 2.0, 2, thr) for thr in EDGE_THRESHOLDS]
    _check_all("K2 tile-plan edges (planes of 63-129 px, B 1 and 16, "
               f"sigma {EDGE_SIGMAS}, r 1-3, thr {EDGE_THRESHOLDS})",
               [(fc.fused_blur_sharpen_morph(*c),
                 fc.fused_blur_sharpen_morph_reference(*c)) for c in cases])

    # 6. K4 vs plain
    conv_oracle = [((2, 40, 56, 3), tables.gaussian_kernel(sigma), border)
                   for sigma in (1.0, 2.0) for border in BorderMode]
    conv_oracle += [((2, 40, 56, 3), _SIGNED, BorderMode.ZERO),
                    ((2, 40, 56, 3), _SIGNED, BorderMode.REPLICATE),
                    ((2, 40, 56, 1), tables.gaussian_kernel(2.0),
                     BorderMode.WRAP),
                    ((2, 40, 56, 4), _SIGNED, BorderMode.MIRROR),
                    ((2, 1, 64, 3), tables.gaussian_kernel(2.0),
                     BorderMode.MIRROR),
                    ((1, 9, 1, 1), _SIGNED, BorderMode.ZERO)]
    for shape, kernel, border in conv_oracle:
        x = _u8(rng, shape)
        _check_equal(f"K4 {shape} taps={len(kernel)} {border.name}",
                     convolve_separable(x, kernel, kernel, border),
                     convolve_separable_reference(x, kernel, kernel, border))
    pairs = []
    for shape in CONV_EDGE_SHAPES:
        for c in range(1, 5):
            x = _u8(rng, (*shape, c))
            for kernel in (tables.gaussian_kernel(2.0),
                           tables.gaussian_kernel(1.0), _SIGNED):
                for border in BorderMode:
                    pairs.append((convolve_separable(x, kernel, kernel,
                                                     border),
                                  convolve_separable_reference(
                                      x, kernel, kernel, border)))
    _check_all("K4 tile-plan edges (C 1-4, every border, sigma 2 and 1 "
               "on the f32 route, the signed 5-tap kernel on the int32 "
               "route, WRAP edges, 1-px axes)", pairs)
    x = _u8(rng, (2, 1024, 768, 3))
    bands = []
    for n in (768, 1024):
        a, b, f = tables.bilinear_axis_table(n, n // 2)
        bands.append(tables.build_tap_matrix(
            np.stack([a, b], 1), np.stack([256 - f, f], 1), n, n // 2))
    _check_equal("K4 (2, 1024, 768, 3) bilinear band -> 512x384",
                 sc.separable_u8(x, *bands),
                 sc.separable_u8_reference(x, *bands))

    # 7. the main paths through the user's entry points
    n, b = MAIN["size"], FILTER_BATCH
    planes = {bb: _u8(rng, (bb, n, n)) for bb in (b, 1)}
    rgb = rng.integers(0, 256, (b, n, n, 3), np.uint8)
    k = tables.gaussian_kernel(2.0)
    torch.cuda.synchronize()
    fc.LAUNCHES = fc.STREAMED = sc.LAUNCHES = 0
    masks = {b: pipeline.filter_chain(planes[b])}
    k2_streamed = fc.STREAMED
    print(f"filter main path [{b}, {n}, {n}]: K2 {fc.LAUNCHES} launch, "
          f"{k2_streamed} streamed")
    if (fc.LAUNCHES, k2_streamed) != (1, 1):
        raise AssertionError("the B=16 main path did not take the streamed "
                             "K2 once")
    masks[1] = pipeline.filter_chain(planes[1])
    ib = ImageBatch(rgb, device="cuda")
    outs = {
        "gaussian_blur": ib.gaussian_blur(2.0),
        "convolve_separable": ib.convolve_separable(k, k,
                                                    BorderMode.REPLICATE),
        "sharpen": ib.sharpen(2),
        "box_blur": ib.box_blur(2),
        "dilate_binary": ib.dilate_binary(),
    }
    torch.cuda.synchronize()
    k2_launches, k4_launches = fc.LAUNCHES, sc.LAUNCHES
    print(f"filter main path: K2 {k2_launches} launches over "
          f"{len(masks)} filter_chain calls, K4 {k4_launches} launches "
          "over gaussian_blur + convolve_separable")
    if k2_launches != len(masks) or k4_launches != 2:
        raise AssertionError("the filter main path did not launch K2 once "
                             "per filter_chain and K4 once per blur")
    k2_err = k4_err = 0
    for bb, p in planes.items():
        k2_err = max(k2_err, _check_equal(
            f"main path filter_chain [{bb}, {n}, {n}]", masks[bb],
            fc.fused_blur_sharpen_morph_reference(p)))
        frac = float((masks[bb] == 255).float().mean())
        print(f"  mask foreground share {frac:.4f}")
    x = ib.device_array()
    k4_err = max(_check_equal(
        "main path ImageBatch.gaussian_blur(2.0)",
        outs["gaussian_blur"].device_array(),
        convolve_separable_reference(x, k, k)), _check_equal(
        "main path ImageBatch.convolve_separable(REPLICATE)",
        outs["convolve_separable"].device_array(),
        convolve_separable_reference(x, k, k, BorderMode.REPLICATE)))
    # the plain ops on the card against the same ops on the CPU, image 0
    x0 = torch.from_numpy(rgb[:1])
    gray0 = ImageBatch(rgb[:1], device="cpu")._gray_plane()
    for name, want in (("sharpen", integral.sharpen(x0, 2)),
                       ("box_blur", integral.box_blur(x0, 2)),
                       ("dilate_binary", binary.dilate(gray0)[..., None])):
        got = outs[name].device_array()[:1].cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"ImageBatch.{name} on the card != CPU")
        print(f"main path ImageBatch.{name}: equal to the CPU on image 0")

    # 8. times: plain, kernel, kernel, plain in one process, with the
    #    profiler's device time beside the events; K4's library call
    k2_ms = {}
    for bb, p in planes.items():
        kern = lambda p=p: fc.fused_blur_sharpen_morph(p)  # noqa: E731
        plain = lambda p=p: \
            fc.fused_blur_sharpen_morph_reference(p)  # noqa: E731
        p1, t1, t2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        dev = _device_ms(kern, "filter_kernel")
        k2_ms[bb] = (min(t1, t2), min(p1, p2), dev)
        print(f"[{card}] K2 B={bb} {n}^2 gray sigma=2 r=2 kernel: {t1:.4f} / "
              f"{t2:.4f} ms (events), {dev:.4f} ms (profiler, device); "
              f"plain: {p1:.4f} / {p2:.4f} ms; bound "
              f"{k2_bound(bb, n)[0]:.4f} ms")
    k4_ms = {}
    for sigma in (2.0, 1.0):
        ks = tables.gaussian_kernel(sigma)
        kern = lambda ks=ks: convolve_separable(x, ks, ks)  # noqa: E731
        plain = lambda ks=ks: \
            convolve_separable_reference(x, ks, ks)  # noqa: E731
        lib, lib_out = _library_conv(x, ks)
        lib_equal = torch.equal(_div_clamp_u8(lib_out, SCALE * SCALE),
                                kern())
        p1, t1, t2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        l1, l2 = _time_ms(lib), _time_ms(lib)
        dev = _device_ms(kern, "conv_kernel")
        k4_ms[sigma] = (min(t1, t2), min(p1, p2), min(l1, l2), lib_equal)
        print(f"[{card}] K4 B={b} {n}^2 RGB sigma={sigma} kernel: "
              f"{t1:.4f} / {t2:.4f} ms (events), {dev:.4f} ms (profiler, "
              f"device); plain: {p1:.4f} / {p2:.4f} ms; library (depthwise "
              f"F.conv2d, two 1-D f32 calls on the reflect-padded batch, "
              f"TF32 off): {l1:.4f} / {l2:.4f} ms, array_equal after "
              f"divClampU8: {lib_equal}; bound {k4_bound(x, ks)[0]:.4f} ms")

    k2 = {
        "name": "fused_blur_sharpen_morph",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/fused_blur_sharpen_morph.cu",
        "replaces": "zignal_tpu/ops/pallas_filter.py:197",
        "launches": k2_launches,
        "streamed": k2_streamed,  # of the B=16 main path's launch
        "max_abs_err": k2_err,
        "ms": k2_ms[b][0],
        "plain_ms": k2_ms[b][1],
        "bound_ms": k2_bound(b, n)[0],
        "bound_by": k2_bound(b, n)[1],
        "library_ms": None,  # five stages; no one PyTorch call
    }
    k4 = {
        "name": "separable_u8",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/separable_u8.cu",
        "replaces": "zignal_tpu/ops/pallas_conv.py:135",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4_ms[2.0][0],
        "plain_ms": k4_ms[2.0][1],
        "bound_ms": k4_bound(x, k)[0],
        "bound_by": k4_bound(x, k)[1],
        "library_ms": k4_ms[2.0][2] if k4_ms[2.0][3] else None,
    }
    return k2, k4


KERNEL_CHAINS = [BENCH_CHAIN, ("rgb", "oklab", "rgb"),
                 ("rgb", "lab", "lch", "lab", "rgb"), ("rgb", "xyz", "rgb"),
                 ("rgb", "xyb", "rgb"), ("rgb", "oklch", "rgb")]
COLOR_BATCHES = (4, 16)


def _all_triples():
    v = torch.arange(1 << 24, device="cuda", dtype=torch.int64)
    return torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1) \
        .to(torch.uint8).reshape(1, 4096, 4096, 3)


def _extremes():
    x = np.zeros((1, 32, 128, 3), np.uint8)
    x[0, :8] = 255
    x[0, 8:16] = 1
    x[0, 16:24, :, 0] = 255
    return torch.from_numpy(x).cuda()


# the colorspace step's batch (4 camera frames of 4608 x 3456) and chain
CAMERA = (4, 3456, 4608, 3)
VALUES_CHAIN = ("rgb", "lab")


def _camera_frames(shape, seed: int = 19):
    """Photo-like u8 frames made on the card: a smooth 28 x 37 grid
    upsampled, under a 1.8 gamma from 16 to 144, with grain of +-6. The
    histogram is peaked and the highlights empty, so equalize moves most
    values."""
    import torch.nn.functional as F

    b, h, w, c = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    grid = torch.rand((b, c, 28, 37), generator=gen, device="cuda")
    s = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)
    grain = torch.randint(-6, 7, (b, c, h, w), generator=gen, device="cuda")
    v = torch.round(16 + 128 * s.clamp(0, 1) ** 1.8) + grain
    return v.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _check_chain(label, x, spaces):
    """K3 vs plain on ``x`` in u8 and in f32; returns (f32 max-abs, max
    distance of f*255 from an integer)."""
    from zignal_tpu_torch.ops import color_chain as cc

    _check_equal(f"K3 u8 {label}", cc.fused_color_chain_u8(x, spaces),
                 cc.fused_color_chain_u8_reference(x, spaces))
    f = cc.fused_color_chain_u8(x, spaces, quantize=False)
    want = cc.fused_color_chain_u8_reference(x, spaces, quantize=False)
    torch.cuda.synchronize()
    if f.shape != x.shape or f.dtype != torch.float32:
        raise AssertionError(f"bad f32 output {f.shape} {f.dtype}")
    err = float((f - want).abs().max())
    margin = float((f * 255 - torch.round(f * 255)).abs().max())
    ok = err <= CHAIN_UNIT and bool(torch.isfinite(f).all())
    print(f"K3 f32 {label}: max_abs_err={err} max|f*255-round|={margin} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K3 f32 != plain: {label}")
    return err, margin


def _color_phases(card, rng):
    """Phases 9-12: K3, K3p and the equalize kernels. Returns their entries
    of the kernels line."""
    from zignal_tpu_torch import Gray, ImageBatch, pipeline
    from zignal_tpu_torch.ops import binary as eb
    from zignal_tpu_torch.ops import color_chain as cc
    from zignal_tpu_torch.ops import enhancement
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc
    from zignal_tpu_torch.ops.convolution import \
        convolve_separable_reference
    from zignal_tpu_torch.ops.tables import gaussian_kernel

    n = MAIN["size"]
    batches = {b: _u8(rng, (b, n, n, 3)) for b in COLOR_BATCHES}

    # 9. the colour main paths; K3's first launch in this process runs K3p
    torch.cuda.synchronize()
    cc.LAUNCHES = cc.PROBE_LAUNCHES = 0
    chained = {b: pipeline.color_chain_u8(x, BENCH_CHAIN)
               for b, x in batches.items()}
    torch.cuda.synchronize()
    k3_launches, k3p_launches = cc.LAUNCHES, cc.PROBE_LAUNCHES
    print(f"colour main path: K3 {k3_launches} launches over "
          f"{len(chained)} color_chain_u8 calls, K3p {k3p_launches}")
    if k3_launches != len(chained) or k3p_launches != 1:
        raise AssertionError("color_chain_u8 did not launch K3 once per "
                             "call and K3p once before it")
    for b, x in batches.items():
        _check_equal(f"main path color_chain_u8 [{b}, {n}, {n}, 3]",
                     chained[b], cc.fused_color_chain_u8_reference(
                         x, BENCH_CHAIN))

    x4 = batches[4]

    def config2(x):
        u8 = pipeline.color_chain_u8(x, BENCH_CHAIN)
        return u8, enhancement.equalize(u8[0]), \
            enhancement.autocontrast(u8[1])

    torch.cuda.synchronize()
    cc.LAUNCHES = 0
    u8, eq, ac = config2(x4)
    torch.cuda.synchronize()
    step_launches = cc.LAUNCHES
    print(f"config-2 step: K3 {step_launches} launch")
    if step_launches != 1:
        raise AssertionError("the config-2 step did not launch K3")
    ref = cc.fused_color_chain_u8_reference(x4, BENCH_CHAIN)
    _check_equal("config-2 step chain", u8, ref)
    _check_equal("config-2 step equalize(u8[0]) vs the CPU", eq.cpu(),
                 enhancement.equalize(ref[0].cpu()))
    _check_equal("config-2 step autocontrast(u8[1]) vs the CPU", ac.cpu(),
                 enhancement.autocontrast(ref[1].cpu()))
    k3_launches += step_launches

    # the colorspace step: four 16-MP camera frames equalized (the
    # histogram, tables and lookup kernels), then to CIELAB f32 on K3's
    # values route
    frames = _camera_frames(CAMERA)
    torch.cuda.synchronize()
    cc.LAUNCHES = cc.VALUES = 0
    eb.HIST_LAUNCHES = eb.LUT_LAUNCHES = 0
    enhancement.TABLE_LAUNCHES = 0
    cs_eq = enhancement.equalize(frames)
    cs_lab = pipeline.color_chain_values(cs_eq, VALUES_CHAIN)
    torch.cuda.synchronize()
    k3_values = cc.VALUES
    eq_launches = (eb.HIST_LAUNCHES, enhancement.TABLE_LAUNCHES,
                   eb.LUT_LAUNCHES)
    print(f"colorspace step {list(frames.shape)}: K3 {cc.LAUNCHES} launch, "
          f"VALUES {k3_values}, HIST_LAUNCHES {eq_launches[0]}, "
          f"TABLE_LAUNCHES {eq_launches[1]}, LUT_LAUNCHES {eq_launches[2]}, "
          f"equalized output contiguous {cs_eq.is_contiguous()}")
    if (cc.LAUNCHES, k3_values) != (1, 1) or not cs_eq.is_contiguous():
        raise AssertionError("color_chain_values did not launch K3 once on "
                             "its values route, or equalize's output needs "
                             "a copy first")
    if eq_launches != (1, 1, 1):
        raise AssertionError("equalize did not launch the histogram, "
                             "tables and lookup kernels once each")
    _check_equal("colorspace step histograms vs plain",
                 eb.histogram256_batch(frames),
                 eb.histogram256_batch_reference(frames))
    _check_equal("colorspace step equalize vs plain", cs_eq,
                 enhancement.equalize_reference(frames))
    if not torch.equal(cs_eq.cpu(), enhancement.equalize(frames.cpu())):
        raise AssertionError("the colorspace step's equalize differs from "
                             "the CPU")
    moved = float((cs_eq != frames).to(torch.float32).mean())
    want = cc.fused_color_chain_u8_reference(cs_eq, VALUES_CHAIN,
                                             quantize=False)
    if cs_lab.shape != frames.shape or cs_lab.dtype != torch.float32:
        raise AssertionError(f"bad Lab output {cs_lab.shape} {cs_lab.dtype}")
    lab_err = float((cs_lab - want).abs().max())
    ok = lab_err <= CHAIN_UNIT and bool(torch.isfinite(cs_lab).all())
    print(f"colorspace step: equalize equal to the CPU ({moved:.3f} of the "
          f"values moved), Lab max_abs_err={lab_err} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or moved < 0.5:
        raise AssertionError("the colorspace step disagrees with plain")
    k3_launches += 1
    del want

    x16 = batches[16]
    torch.cuda.synchronize()
    fp.LAUNCHES = sc.LAUNCHES = 0
    since = _streamed()
    ib = ImageBatch(x16, device="cuda")
    out = (ib.resize((512, 512)).gaussian_blur(1.5).autocontrast(0.01)
           .convert(Gray).equalize())
    binary, thresholds = ib.convert(Gray).threshold_otsu()
    torch.cuda.synchronize()
    k1_ex, k4_ex = fp.LAUNCHES, sc.LAUNCHES
    _keep_streamed("example chain", since)
    print(f"ImageBatch example chain: K1 {k1_ex} launches, K4 {k4_ex}")
    if k1_ex != 1 or k4_ex != 1:
        raise AssertionError("the ImageBatch example chain did not launch "
                             "K1 and K4")
    k = gaussian_kernel(1.5)
    small = fp.fused_resize_blur_oklab_reference(x16, 512, 512, 0.0,
                                                 oklab=False)
    plain = ImageBatch(convolve_separable_reference(small, k, k).cpu(),
                       device="cpu")
    want = plain.autocontrast(0.01).convert(Gray).equalize()
    _check_equal("ImageBatch example chain vs plain",
                 out.device_array().cpu(), want.device_array())
    want_bin, want_t = ImageBatch(x16.cpu(), device="cpu") \
        .convert(Gray).threshold_otsu()
    if not np.array_equal(thresholds, want_t):
        raise AssertionError("threshold_otsu thresholds differ from the CPU")
    _check_equal(f"ImageBatch.threshold_otsu (thresholds {thresholds[:4]}"
                 "...) vs the CPU", binary.device_array().cpu(),
                 want_bin.device_array())

    # 10. K3p vs plain: the TPU's tile, 1M values, sizes around its 4-value
    #     groups and a view 4 bytes past a 16-byte boundary (scalar head,
    #     scalar stores)
    probe_rel = probe_abs = 0.0
    big = torch.from_numpy(rng.uniform(0, 2, (1 << 20) + 4).astype(
        np.float32)).cuda()
    cases = [("(8, 128) linspace",
              torch.linspace(0.0, 2.0, 1024, device="cuda").reshape(8, 128)),
             ("1M values", big[:1 << 20])]
    cases += [(f"n={n}", big[:n]) for n in (1, 3, 5, 1023, (1 << 20) + 3)]
    cases += [("1M values, a view offset by 4 bytes", big[1:(1 << 20) + 1]),
              ("n=5, a view offset by 4 bytes", big[1:6])]
    for label, x in cases:
        got = cc.transcendentals_probe(x)
        want = cc.transcendentals_probe_reference(x)
        torch.cuda.synchronize()
        rel = cc.probe_error(got, want)
        probe_rel = max(probe_rel, rel)
        probe_abs = max(probe_abs, float((got - want).abs().max()))
        print(f"K3p {label} (x at {x.data_ptr() % 16} mod 16): "
              f"max_rel_err={rel} {'ok' if rel <= cc.PROBE_TOL else 'FAIL'}")
        if not rel <= cc.PROBE_TOL or got.shape != x.shape:
            raise AssertionError(f"K3p != plain: {label}")

    # 11. K3 vs plain on every RGB triple, then odd shapes
    allx = _all_triples()
    k3_err = margin = 0.0
    for spaces in KERNEL_CHAINS:
        e, m = _check_chain(f"2^24 triples {'-'.join(spaces)}", allx, spaces)
        k3_err, margin = max(k3_err, e), max(margin, m)
    del allx
    for shape in ((2, 64, 128, 3), (1, 1, 1, 3), (3, 5, 7, 3),
                  (2, 1, 1000, 3)):
        e, _ = _check_chain(f"{shape}", _u8(rng, shape), BENCH_CHAIN)
        k3_err = max(k3_err, e)
    for spaces in KERNEL_CHAINS:
        e, _ = _check_chain(f"extremes {'-'.join(spaces)}", _extremes(),
                            spaces)
        k3_err = max(k3_err, e)
    print(f"K3 over all checks: f32 max_abs_err={k3_err}, largest distance "
          f"of f*255 from an integer {margin} (u8 margin {0.5 - margin})")

    # 12. times: plain, kernel, kernel, plain; then the plain histogram ops
    rows = {}
    for b, x in batches.items():
        kern = lambda: cc.fused_color_chain_u8(x, BENCH_CHAIN)  # noqa: E731
        plain = lambda: cc.fused_color_chain_u8_reference(  # noqa: E731
            x, BENCH_CHAIN)
        p1, t1, t2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        rows[b] = (min(t1, t2), min(p1, p2))
        gpix = b * n * n / 1e9
        print(f"[{card}] K3 B={b} {n}^2 bench chain kernel: {t1:.4f} / "
              f"{t2:.4f} ms ({gpix / (rows[b][0] / 1e3):.2f} GPix/s); "
              f"plain: {p1:.4f} / {p2:.4f} ms")
        u8 = chained[b]
        eq = lambda: enhancement.equalize(u8)  # noqa: E731
        ac = lambda: enhancement.autocontrast(u8, 0.01)  # noqa: E731
        step = lambda: config2(x)  # noqa: E731
        e1, a1, s1, s2, a2, e2 = (_time_ms(eq, 5), _time_ms(ac, 5),
                                  _time_ms(step, 5), _time_ms(step, 5),
                                  _time_ms(ac, 5), _time_ms(eq, 5))
        print(f"[{card}] B={b} {n}^2 equalize: {e1:.4f} / {e2:.4f} ms; "
              f"autocontrast(0.01): {a1:.4f} / {a2:.4f} ms; config-2 "
              f"step (K3 + equalize(u8[0]) + autocontrast(u8[1])): "
              f"{s1:.4f} / {s2:.4f} ms ({gpix / (min(s1, s2) / 1e3):.2f} "
              "GPix/s)")
    pb = torch.from_numpy(rng.uniform(0, 2, 1 << 20).astype(np.float32)) \
        .cuda()
    kern = lambda: cc.transcendentals_probe(pb)  # noqa: E731
    plain = lambda: cc.transcendentals_probe_reference(pb)  # noqa: E731
    p1, t1, t2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                      _time_ms(plain))
    # a 1M-value launch is host-bound under CUDA events: its device time
    # is the kernel's
    k3p_dev = _device_ms(kern, "probe_kernel")
    print(f"[{card}] K3p 1M values: kernel {t1:.4f} / {t2:.4f} ms (events), "
          f"{k3p_dev:.4f} ms (profiler, device); plain {p1:.4f} / {p2:.4f} "
          f"ms; bound {k3p_bound(pb.numel())[0]:.4f} ms")

    colorspace = lambda: pipeline.color_chain_values(  # noqa: E731
        enhancement.equalize(frames), VALUES_CHAIN)
    values = lambda: cc.fused_color_chain_u8(  # noqa: E731
        cs_eq, VALUES_CHAIN, quantize=False)
    eq_only = lambda: enhancement.equalize(frames)  # noqa: E731
    s1, v1, q1, q2, v2, s2 = (_time_ms(colorspace, 5), _time_ms(values, 5),
                              _time_ms(eq_only, 5), _time_ms(eq_only, 5),
                              _time_ms(values, 5), _time_ms(colorspace, 5))
    print(f"[{card}] colorspace step {list(frames.shape)}: {s1:.4f} / "
          f"{s2:.4f} ms ({frames[..., 0].numel() / 1e3 / min(s1, s2):.1f} "
          f"MPix/s); equalize {q1:.4f} / {q2:.4f} ms; K3 values route "
          f"rgb->lab {v1:.4f} / {v2:.4f} ms")

    # the equalize passes alone on the same frames (device time, profiler)
    # beside their bounds, the plain version and the library's yardstick,
    # histc + gather, which the port never calls on the card
    values_n = frames.numel()
    hists = eb.histogram256_batch(frames)
    tables = enhancement.equalize_tables(hists, CAMERA[1] * CAMERA[2])
    passes = (("histogram", lambda: eb.histogram256_batch(frames),
               "hist_kernel", hist_bound(values_n)),
              ("tables", lambda: enhancement.equalize_tables(
                  hists, CAMERA[1] * CAMERA[2]), "tables_kernel", None),
              ("lookup", lambda: eb.lut_apply_u8_per_channel(frames, tables),
               "lut_kernel", lut_bound(values_n)))
    for label, fn, kernel, bnd in passes:
        dev = _device_ms(fn, kernel, 10)
        share = f", {100 * bnd[0] / dev:.1f} % of its bound " \
            f"{bnd[0]:.4f} ms ({bnd[1]})" if bnd else ""
        print(f"[{card}] equalize {label} {list(frames.shape)}: {dev:.4f} "
              f"ms (profiler, device){share}; {_time_ms(fn, 5):.4f} ms "
              "(events)")
    eq_names = ("hist_kernel", "tables_kernel", "lut_kernel")
    eq_dev = _device_ms(eq_only, eq_names, 10)
    plain_eq = lambda: enhancement.equalize_reference(frames)  # noqa: E731
    library = lambda: eb.lut_apply_u8_per_channel_reference(  # noqa: E731
        frames, eb.histogram256_batch_reference(frames))
    pq1, lb1, lb2, pq2 = (_time_ms(plain_eq, 3), _time_ms(library, 3),
                          _time_ms(library, 3), _time_ms(plain_eq, 3))
    eq_bound = hist_bound(values_n)[0] + lut_bound(values_n)[0]
    print(f"[{card}] equalize {list(frames.shape)}: kernels {eq_dev:.4f} "
          f"ms (profiler, device), {100 * eq_bound / eq_dev:.1f} % of the "
          f"passes' bound {eq_bound:.4f} ms; plain {pq1:.4f} / {pq2:.4f} "
          f"ms; library (histc + gather) {lb1:.4f} / {lb2:.4f} ms")
    eqk = {
        "name": "equalize",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/equalize_u8.cu",
        "replaces": None,  # the JAX package's equalize is plain jnp
        "launches": eq_launches[0],
        "max_abs_err": 0,
        "ms": eq_dev,
        "plain_ms": min(pq1, pq2),
        "bound_ms": eq_bound,
        "bound_by": "bytes",
        "library_ms": min(lb1, lb2),
    }
    del frames, cs_eq, cs_lab, hists, tables

    k3b = k3_bound(x4)
    print(f"K3 bound at B=4 on the bench chain: {k3b[0]:.4f} ms "
          f"({k3b[1]})")
    k3 = {
        "name": "fused_color_chain_u8",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/fused_color_chain_u8.cu",
        "replaces": "zignal_tpu/ops/pallas_color.py:367",
        "launches": k3_launches,
        "values": k3_values,
        "max_abs_err": max(k3_err, lab_err),
        "ms": rows[4][0],
        "plain_ms": rows[4][1],
        "bound_ms": k3b[0],
        "bound_by": k3b[1],
        "library_ms": None,  # no one PyTorch call runs a colour chain
    }
    k3p = {
        "name": "transcendentals_probe",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/fused_color_chain_u8.cu",
        "replaces": "zignal_tpu/ops/pallas_color.py:110",
        "launches": k3p_launches,
        "max_abs_err": probe_abs,
        "ms": k3p_dev,
        "plain_ms": min(p1, p2),
        "bound_ms": k3p_bound(pb.numel())[0],
        "bound_by": k3p_bound(pb.numel())[1],
        "library_ms": None,  # the probe is a where() of two sums of powers
    }
    return k3, k3p, eqk, (k1_ex, k4_ex)


FLOAT_TOL = 1e-4  # max-abs on 0-255 data, the bound of the CPU tests
SHARPEN3 = ((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0))
_B5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
BINOMIAL5 = tuple(tuple(float(v) for v in row) for row in np.outer(_B5, _B5))


def _slice4_calls():
    """(name, call, expected (K1, K4) launches) of every phase-13 path;
    a call takes the ImageBatch and one gray plane of it."""
    from zignal_tpu_torch import BorderMode, Interpolation
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    calls = [(f"resize 512^2 {m.name}",
              lambda ib, g, m=m: ib.resize((512, 512), m),
              (1, 0) if m == Interpolation.BILINEAR else (0, 0))
             for m in Interpolation]
    calls += [
        ("resize 1536x1280 BICUBIC",
         lambda ib, g: ib.resize((1536, 1280), Interpolation.BICUBIC),
         (0, 0)),
        ("letterbox (512, 768)", lambda ib, g: ib.letterbox((512, 768)),
         (1, 0)),
        ("convolve 3x3 sharpen", lambda ib, g: ib.convolve(SHARPEN3), (0, 0)),
        ("convolve 5x5 ZERO",
         lambda ib, g: ib.convolve(BINOMIAL5, BorderMode.ZERO), (0, 0)),
        ("median_blur(2)", lambda ib, g: ib.median_blur(2), (0, 0)),
        ("percentile_blur(3, 0.9, WRAP)",
         lambda ib, g: ib.percentile_blur(3, 0.9, BorderMode.WRAP), (0, 0)),
        ("min_blur(2)", lambda ib, g: ib.min_blur(2), (0, 0)),
        ("max_blur(2)", lambda ib, g: ib.max_blur(2), (0, 0)),
        ("midpoint_blur(2)", lambda ib, g: ib.midpoint_blur(2), (0, 0)),
        ("alpha_trimmed_mean_blur(2, 0.2)",
         lambda ib, g: ib.alpha_trimmed_mean_blur(2, 0.2), (0, 0)),
        ("sobel", lambda ib, g: ib.sobel(), (0, 0)),
        ("canny", lambda ib, g: ib.canny(), (0, 0)),
        ("shen_castan", lambda ib, g: ib.shen_castan(), (0, 0)),
        ("threshold_adaptive_mean",
         lambda ib, g: ib.threshold_adaptive_mean(), (0, 0)),
        ("ImagePyramid.build of one 1024^2 gray plane, 8 levels",
         lambda ib, g: ImagePyramid.build(g, 8).levels, (7, 1)),
    ]
    return calls


def _planes(out):
    """An ImageBatch's tensor, or a pyramid's levels."""
    return out if isinstance(out, list) else [out.device_array()]


def _time_events(fn) -> float:
    """ms a call: CUDA events around back-to-back calls after one
    warm-up, as many as fit in about half a second."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(500.0 / max(start.elapsed_time(stop), 1e-3))))
    return _time_ms(fn, reps)


def _slice4_phases(card, rng):
    """Phases 13-15. Returns the K1 and K4 launches of phase 13."""
    from zignal_tpu_torch import Gray, ImageBatch, Interpolation
    from zignal_tpu_torch.ops import color_chain as cc
    from zignal_tpu_torch.ops import edges
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc
    from zignal_tpu_torch.ops.convolution import convolve_separable, \
        sobel_gradients
    from zignal_tpu_torch.ops.interpolation import resize
    from zignal_tpu_torch.ops.tables import gaussian_kernel

    n, b = MAIN["size"], FILTER_BATCH
    # piecewise-flat images (16-px blocks) with noise, so the edge
    # detectors have edges to find
    blocks = rng.integers(0, 256, (b, n // 16, n // 16, 3)).repeat(
        16, 1).repeat(16, 2)
    x = np.clip(blocks + rng.integers(-12, 13, (b, n, n, 3)), 0, 255) \
        .astype(np.uint8)
    ib = ImageBatch(x, device="cuda")
    gray = ib.convert(Gray).device_array()[0, ..., 0]
    calls = _slice4_calls()

    # 13. every path once, launch counts zeroed just before
    torch.cuda.synchronize()
    fp.LAUNCHES = sc.LAUNCHES = fc.LAUNCHES = cc.LAUNCHES = 0
    since = _streamed()
    outs = {}
    for name, fn, want in calls:
        k1, k4 = fp.LAUNCHES, sc.LAUNCHES
        t0 = time.perf_counter()
        outs[name] = fn(ib, gray)
        torch.cuda.synchronize()
        got = (fp.LAUNCHES - k1, sc.LAUNCHES - k4)
        print(f"phase 13 {name}: K1 {got[0]}, K4 {got[1]} launches "
              f"({time.perf_counter() - t0:.2f} s first call)")
        if got != want:
            raise AssertionError(f"{name} launched K1, K4 {got}, not {want}")
    k1_launches, k4_launches = fp.LAUNCHES, sc.LAUNCHES
    _keep_streamed("13", since)
    if fc.LAUNCHES or cc.LAUNCHES:
        raise AssertionError("phase 13 launched K2 or K3")
    print(f"phase 13: K1 {k1_launches} launches, K4 {k4_launches}")

    # 14. image 0 against the same calls on the CPU
    cpu = ImageBatch(x[:1], device="cpu")
    cpu_gray = cpu.convert(Gray).device_array()[0, ..., 0]
    for name, fn, _ in calls:
        t0 = time.perf_counter()
        want = _planes(fn(cpu, cpu_gray))
        got = _planes(outs[name])
        if name.startswith("ImagePyramid"):
            got = [g.cpu() for g in got]
        else:
            got = [got[0][:1].cpu()]
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape} {g.dtype} on the "
                                     f"card, {w.shape} {w.dtype} on the CPU")
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}: {bad} values differ from "
                                     "the CPU")
        extra = ""
        if name in ("canny", "shen_castan"):
            extra = f", {int((want[0] > 0).sum())} edge pixels"
        print(f"phase 14 {name}: equal to the CPU on image 0{extra} "
              f"({time.perf_counter() - t0:.2f} s)")
    x0 = ib.device_array()[:1].float()
    g0 = ib.convert(Gray).device_array()[:1, ..., 0].float()
    k = gaussian_kernel(1.4)
    floats = [(f"float resize 512^2 {m.name}",
               lambda a, m=m: resize(a[0], 512, 512, m))
              for m in Interpolation]
    floats += [("float Gaussian sigma 1.4",
                lambda a: convolve_separable(a[1][..., None], k, k)),
               ("Sobel gx", lambda a: sobel_gradients(a[1])[0]),
               ("Sobel gy", lambda a: sobel_gradients(a[1])[1]),
               ("ISEF b=0.9", lambda a: edges.isef_filter(a[1], 0.9))]
    for name, fn in floats:
        got = fn((x0, g0)).cpu()
        want = fn((x0.cpu(), g0.cpu()))
        err = float((got - want).abs().max())
        ok = err <= FLOAT_TOL and bool(torch.isfinite(got).all())
        print(f"phase 14 {name}: max_abs_err={err} vs the CPU "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} on the card differs from the CPU")
    five = ib.device_array()[:6].reshape(2, 3, n, n, 3)
    got = resize(five, 300, 200)
    if got.shape != (2, 3, 300, 200, 3) or not torch.equal(
            got.cpu(), resize(five.cpu(), 300, 200)):
        raise AssertionError("resize of [2, 3, H, W, 3] on the card != CPU")
    print("phase 14 resize of [2, 3, 1024, 1024, 3] to 300x200: equal to "
          "the CPU")

    # 15. times
    print(f"phase 15: ImageBatch of [{b}, {n}, {n}, 3] u8 unless named")
    for name, fn, _ in calls:
        ms = _time_events(lambda: fn(ib, gray))
        print(f"[{card}] phase 15 {name}: {ms:.4f} ms")
    return k1_launches, k4_launches


# -- the file paths: the Image container, the host codecs, the loader ---------

CONFIG1 = dict(count=12, rows=1200, cols=1600)  # bench.py:199-260
FILES = dict(count=16, side=1024)               # the north star from files
LOADER = dict(count=64, batch=16, side=1024)
# the loader's inputs: the north star's 1024^2 files and three other
# sizes, so that 3 of 4 files take the letterbox, each through one K1
# resize (no size here letterboxes to itself, which resizes nothing)
LOADER_SIZES = ((1024, 1024), (900, 1200), (1200, 900), (640, 960))


def _launched(fn, mod, label: str, times: int = 1):
    """``fn()`` with ``mod.LAUNCHES`` read around it; raises unless the
    kernel launched ``times`` times."""
    torch.cuda.synchronize()
    before = mod.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    if mod.LAUNCHES - before != times:
        raise AssertionError(f"{label}: {mod.LAUNCHES - before} launches, "
                             f"not {times}")
    return out


def _config1(card):
    """Phase 16: BASELINE config 1 on the card. Returns K1's and K4's
    launches, the corpus (JPEG bytes) and its single-image latency and
    sustained MPix/s."""
    from zignal_tpu_torch import Image
    from zignal_tpu_torch.codecs import jpeg, png
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc

    n, h, w = CONFIG1["count"], CONFIG1["rows"], CONFIG1["cols"]
    corpus = [jpeg.encode(synth_photo(h, w, seed=100 + k), quality=90)
              for k in range(n)]

    def once(jpg, device):
        img = Image.load_from_bytes(jpg, device=device)
        return png.encode(img.resize((img.rows // 2, img.cols // 2))
                          .to_numpy())

    torch.cuda.synchronize()
    fp.LAUNCHES = sc.LAUNCHES = 0
    since = _streamed()
    outs = [_launched(lambda j=jpg: once(j, "cuda"), fp,
                      f"config 1 image {k}") for k, jpg in enumerate(corpus)]
    img = Image.load_from_bytes(corpus[0], device="cuda")
    blurred = _launched(lambda: img.gaussian_blur(2.0), sc,
                        "Image.gaussian_blur")
    k1, k4 = fp.LAUNCHES, sc.LAUNCHES
    _keep_streamed("16", since)
    for k, (jpg, out) in enumerate(zip(corpus, outs)):
        if out != once(jpg, "cpu"):
            raise AssertionError(f"config 1 image {k}: PNG bytes differ "
                                 "from the same flow on the CPU")
    cpu = Image.load_from_bytes(corpus[0], device="cpu").gaussian_blur(2.0)
    if not np.array_equal(blurred.to_numpy(), cpu.to_numpy()):
        raise AssertionError("Image.gaussian_blur on the card != the CPU")
    print(f"config 1: {n} JPEGs of {h}x{w} -> Image.load_from_bytes(..., "
          f"device='cuda').resize(({h // 2}, {w // 2})) -> PNG: K1 {k1} "
          f"launches (1 an image), every PNG equal to the CPU's "
          f"({sum(map(len, outs)) / n / 1e3:.0f} KB each); "
          f"Image.gaussian_blur(2.0): K4 1 launch, equal to the CPU")

    once(corpus[0], "cuda")  # warm
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        once(corpus[0], "cuda")
        lat.append(time.perf_counter() - t0)
    stream = []
    for _ in range(2):
        t0 = time.perf_counter()
        for jpg in corpus:
            once(jpg, "cuda")
        stream.append(time.perf_counter() - t0)
    mpix = h * w / 1e6
    numbers = dict(latency_ms=1e3 * min(lat),
                   mpix_s=n * mpix / min(stream))
    print(f"[{card}] config 1: single-image latency {1e3 * min(lat):.2f} ms "
          f"(best of 3: {', '.join(f'{1e3 * t:.2f}' for t in lat)}); "
          f"sustained {n * mpix / min(stream):.2f} MPix/s over {n} images "
          f"(passes {', '.join(f'{n * mpix / t:.2f}' for t in stream)})")

    # the split, each stage alone with a synchronize after it
    split = {k: [] for k in ("decode", "H2D", "resize", "D2H", "encode")}
    for jpg in corpus:
        t0 = time.perf_counter()
        arr = jpeg.load_from_bytes(jpg)
        t1 = time.perf_counter()
        dev = torch.from_numpy(arr).to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = Image._from_device(dev, "rgb").resize((h // 2, w // 2))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = out.to_numpy()
        t4 = time.perf_counter()
        png.encode(host)
        t5 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4)):
            split[key].append(1e3 * dt)
    print(f"[{card}] config 1 split, median ms an image: " + ", ".join(
        f"{k} {np.median(v):.3f}" for k, v in split.items())
        + f" (sum {sum(np.median(v) for v in split.values()):.2f})")
    return k1, k4, corpus, numbers


def _host_to_host(fn, reps: int = 3):
    """ms of each of ``reps`` calls of ``fn`` on the host clock."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _files(card, tmp):
    """Phases 17-18: the north star from files and the loader. Returns
    K1's launches."""
    from zignal_tpu_torch import BatchLoader, ImageBatch, load_image_batch
    from zignal_tpu_torch.codecs import save_array
    from zignal_tpu_torch.ops import fused_pipeline as fp

    side, n = FILES["side"], FILES["count"]
    paths = []
    for i in range(LOADER["count"]):
        h, w = LOADER_SIZES[0] if i < n else LOADER_SIZES[i % 4]
        paths.append(f"{tmp}/in{i:02d}.{('png', 'jpg')[i % 2]}")
        save_array(paths[-1], synth_photo(h, w, seed=300 + i))
    ns_paths = paths[:n]

    # 17. the north star from files
    torch.cuda.synchronize()
    fp.LAUNCHES = 0
    since = _streamed()
    ib = _launched(lambda: ImageBatch.from_paths(ns_paths, device="cuda"),
                   fp, "from_paths of 1024^2 files", 0)
    lab = _launched(lambda: ib.resize_blur_oklab((512, 512), sigma=2.0), fp,
                    "resize_blur_oklab")
    small = _launched(lambda: ib.resize((512, 512)), fp, "resize")
    k1 = fp.LAUNCHES
    _keep_streamed("17", since)
    out_gpu = [f"{tmp}/gpu{i:02d}.png" for i in range(n)]
    small.save(out_gpu)
    m = 4  # the same call on the CPU, on the first 4 files
    cpu = ImageBatch.from_paths(ns_paths[:m], device="cpu")
    want = cpu.resize_blur_oklab((512, 512), sigma=2.0)
    if tuple(lab.shape) != (n, 512, 512, 3) or not bool(
            torch.isfinite(lab).all()):
        raise AssertionError(f"bad north-star output {tuple(lab.shape)}")
    err = float((lab[:m].cpu() - want).abs().max())
    out_cpu = [f"{tmp}/cpu{i:02d}.png" for i in range(m)]
    cpu.resize((512, 512)).save(out_cpu)
    same = all(open(a, "rb").read() == open(b, "rb").read()
               for a, b in zip(out_gpu, out_cpu))
    print(f"north star from files: {n} files of {side}^2 RGB (PNG, JPEG) "
          f"-> ImageBatch.from_paths(..., device='cuda') -> "
          f".resize_blur_oklab((512, 512), sigma=2): K1 {k1} launches "
          f"(rbo + resize); Oklab vs the CPU on images 0-{m - 1}: "
          f"max_abs_err={err} {'ok' if err <= OKLAB_TOL else 'FAIL'}; "
          f"saved PNGs equal to the CPU's: {same}")
    if err > OKLAB_TOL or not same:
        raise AssertionError("the north star from files != the CPU")

    def pinned():
        return ImageBatch.from_paths(ns_paths, device="cuda") \
            .resize_blur_oklab((512, 512), sigma=2.0).cpu()

    def pageable():
        arr = load_image_batch(ns_paths, device="cpu").numpy()
        return ImageBatch(arr, device="cuda") \
            .resize_blur_oklab((512, 512), sigma=2.0).cpu()

    pinned()
    pageable()
    a, b, c, d = (_host_to_host(pinned), _host_to_host(pageable),
                  _host_to_host(pageable), _host_to_host(pinned))
    arr = load_image_batch(ns_paths, device="cpu").numpy()
    e = _host_to_host(lambda: ImageBatch(arr, device="cuda")
                      .resize_blur_oklab((512, 512), sigma=2.0).cpu())
    host = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = arr
    f = _host_to_host(lambda: ImageBatch(host.to("cuda", non_blocking=True),
                                         device="cuda")
                      .resize_blur_oklab((512, 512), sigma=2.0).cpu())
    print(f"[{card}] north star from files, host to host at B={n}: "
          f"from_paths (pinned, copy stream) -> rbo -> .cpu() "
          f"{min(a + d):.2f} ms (runs {', '.join(f'{t:.2f}' for t in a + d)}"
          f"); decode then ImageBatch(np_array, device='cuda') (pageable) "
          f"{min(b + c):.2f} ms (runs {', '.join(f'{t:.2f}' for t in b + c)}"
          f"); from the decoded array: pageable {min(e):.2f} ms, pinned "
          f"{min(f):.2f} ms")

    # 18. the loader: 64 files of mixed sizes, batch 16, letterboxed
    bs, shape = LOADER["batch"], (LOADER["side"], LOADER["side"])
    chunks = [paths[i:i + bs] for i in range(0, len(paths), bs)]
    lettered = sum(1 for i in range(len(paths))
                   if i >= n and LOADER_SIZES[i % 4] != shape)
    torch.cuda.synchronize()
    before, since = fp.LAUNCHES, _streamed()
    got = []
    for batch in BatchLoader(paths, batch_size=bs, shape=shape,
                             device="cuda"):
        got.append(batch)
        ImageBatch(batch, device="cuda").resize_blur_oklab((512, 512), 2.0)
    torch.cuda.synchronize()
    loader_k1 = fp.LAUNCHES - before
    _keep_streamed("18", since)
    if loader_k1 != lettered + len(chunks):
        raise AssertionError(f"the loader launched K1 {loader_k1} times, "
                             f"not {lettered} letterboxes + {len(chunks)}")
    k1 += loader_k1
    want = list(BatchLoader(paths, batch_size=bs, shape=shape,
                            device="cpu"))
    if len(got) != len(want) or not all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("the loader's batches on the card != the CPU's")
    print(f"BatchLoader: {len(paths)} files ({lettered} letterboxed), "
          f"batch {bs}, shape {shape} -> resize_blur_oklab each batch: K1 "
          f"{loader_k1} launches; every batch equal to the CPU's")
    del got, want

    def prefetched():
        for batch in BatchLoader(paths, batch_size=bs, shape=shape,
                                 device="cuda"):
            ImageBatch(batch, device="cuda").resize_blur_oklab((512, 512),
                                                               2.0)

    def sequential():
        for chunk in chunks:
            batch = load_image_batch(chunk, shape=shape, device="cuda")
            ImageBatch(batch, device="cuda").resize_blur_oklab((512, 512),
                                                               2.0)
            torch.cuda.synchronize()

    a, b, c, d = (_host_to_host(prefetched, 1), _host_to_host(sequential, 1),
                  _host_to_host(sequential, 1), _host_to_host(prefetched, 1))
    a, b, c, d = a[0], b[0], c[0], d[0]
    nb = len(chunks)
    print(f"[{card}] BatchLoader ms a batch: one batch in flight "
          f"{min(a, d) / nb:.2f} (runs {a / nb:.2f}, {d / nb:.2f}); loaded "
          f"one after another {min(b, c) / nb:.2f} (runs {b / nb:.2f}, "
          f"{c / nb:.2f})")
    return k1


def _batch_members(card, rng):
    """Phase 19: ImageBatch's item-10 members on [16, 1024, 1024, 3]
    against the same calls on the CPU (image 0; to_images / from_images
    on the whole batch)."""
    from zignal_tpu_torch import Blending, Gray, ImageBatch

    n, b = MAIN["size"], FILTER_BATCH
    x = rng.integers(0, 256, (b, n, n, 3), np.uint8)
    over = rng.integers(0, 256, (b, n, n, 4), np.uint8)
    ib, ov = ImageBatch(x, device="cuda"), ImageBatch(over, device="cuda")
    cpu = ImageBatch(x[:1], device="cpu")
    cov = ImageBatch(over[:1], device="cpu")
    calls = [("invert", lambda t, o: t.invert()),
             ("flip_left_right", lambda t, o: t.flip_left_right()),
             ("flip_top_bottom", lambda t, o: t.flip_top_bottom()),
             ("fill", lambda t, o: t.fill((12, 34, 56))),
             ("set_border", lambda t, o: t.set_border((100, 50, 900, 1000),
                                                      (9, 8, 7))),
             ("convert(Gray)", lambda t, o: t.convert(Gray))]
    calls += [(f"blend {m.name}", lambda t, o, m=m: t.blend(o, m))
              for m in Blending]
    for name, fn in calls:
        got = fn(ib, ov)
        torch.cuda.synchronize()
        want = fn(cpu, cov)
        if got.dtype is not want.dtype or got.batch_size != b or \
                not torch.equal(got.device_array()[:1].cpu(),
                                want.device_array()):
            raise AssertionError(f"ImageBatch.{name} on the card != CPU")
    images = ib.to_images()
    back = ImageBatch.from_images(images, device="cuda")
    if len(images) != b or not torch.equal(back.device_array(),
                                           ib.device_array()) \
            or not np.array_equal(images[-1].to_numpy(), x[-1]):
        raise AssertionError("to_images / from_images do not round-trip")
    print(f"ImageBatch members on [{b}, {n}, {n}, 3]: {len(calls)} calls "
          "(invert, the flips, fill, set_border, convert(Gray), blend in "
          "every mode) equal to the CPU on image 0; to_images -> "
          "from_images round-trips")
    for name, fn in calls[:6] + [calls[7]]:
        ms = _time_events(lambda: fn(ib, ov))
        print(f"[{card}] phase 19 ImageBatch.{name}: {ms:.4f} ms")


def _file_phases(card, rng):
    """Phases 16-19. Returns (K1, K4) launches, config 1's corpus and its
    numbers."""
    import tempfile

    from zignal_tpu_torch import native

    t0 = time.perf_counter()
    k1, k4, corpus, numbers = _config1(card)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        k1 += _files(card, tmp)
    t2 = time.perf_counter()
    _batch_members(card, rng)
    t3 = time.perf_counter()
    print(f"phases 16-19: config 1 {t1 - t0:.1f} s, files and loader "
          f"{t2 - t1:.1f} s, ImageBatch members {t3 - t2:.1f} s; the codec "
          f"library built in {native.BUILD_SECONDS:.1f} s")
    return k1, k4, corpus, numbers


# -- geometric sampling, motion blur and the metrics (phases 20-22) ----------

GEO = dict(batch=16, side=1024)
METRIC_REL = 1e-5  # the CPU tests' bound on the f32 metrics (and SSIM abs)


def _geometry_calls(n):
    """(name, call, K4 launches) of every phase-20 path on an ImageBatch of
    n x n RGB images; the RGBA source of the insert is an Image on the
    card."""
    import math

    from zignal_tpu_torch import (Blending, Image, Interpolation,
                                  MotionBlur, ProjectiveTransform)

    c = n - 1
    proj = ProjectiveTransform(
        [(0, 0), (c, 0), (0, c), (c, c)],
        [(0.05 * n, 0.02 * n), (0.93 * n, 0.04 * n), (-0.03 * n, 0.95 * n),
         (1.02 * n, 0.9 * n)])
    src = Image.from_numpy(np.random.default_rng(20).integers(
        0, 256, (n // 4, n // 3, 4), np.uint8), device="cuda")
    rect = (0.1 * n, 0.15 * n, 0.88 * n, 0.83 * n)
    return [
        ("rotate(0.5)", lambda ib: ib.rotate(0.5), 0),
        ("rotate(pi / 2)", lambda ib: ib.rotate(math.pi / 2), 0),
        (f"extract(rect, 0.3, ({n // 2}, {n // 2}))",
         lambda ib: ib.extract(rect, 0.3, (n // 2, n // 2)), 0),
        ("crop (partly outside)",
         lambda ib: ib.crop((-n // 16, n // 5, 0.7 * n, 1.07 * n)), 0),
        ("warp(ProjectiveTransform) BILINEAR", lambda ib: ib.warp(proj), 0),
        ("warp(ProjectiveTransform) BICUBIC",
         lambda ib: ib.warp(proj, None, Interpolation.BICUBIC), 0),
        ("insert(RGBA Image, OVERLAY)",
         lambda ib: ib.insert(src, (0.2 * n, 0.3 * n, 0.8 * n, 0.7 * n),
                              0.25, Interpolation.BILINEAR, Blending.OVERLAY),
         0),
        ("motion_blur(linear(0, 9))",
         lambda ib: ib.motion_blur(MotionBlur.linear(0.0, 9)), 1),
        ("motion_blur(linear(0.7, 9))",
         lambda ib: ib.motion_blur(MotionBlur.linear(0.7, 9)), 0),
        ("motion_blur(radial_zoom())",
         lambda ib: ib.motion_blur(MotionBlur.radial_zoom()), 0),
        ("motion_blur(radial_spin())",
         lambda ib: ib.motion_blur(MotionBlur.radial_spin()), 0),
    ]


def _metric_calls(blurred):
    return [("psnr", lambda ib: ib.psnr(blurred)),
            ("ssim", lambda ib: ib.ssim(blurred)),
            ("mean_pixel_error", lambda ib: ib.mean_pixel_error(blurred)),
            ("diff", lambda ib: ib.diff(blurred, threshold=2, scale=1.7))]


def _counted_modules():
    """The modules of K1, K2, K3 and K4, whose LAUNCHES count launches."""
    from zignal_tpu_torch.ops import color_chain as cc
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc

    return fp, fc, cc, sc


def _counts():
    return tuple(m.LAUNCHES for m in _counted_modules())


# K1's streamed launches (fused_pipeline.STREAMED) of each phase after 3,
# read over the same calls as the K1 launches the phase returns: the
# kernels line's "streamed" counts the runs its "launches" counts
K1_STREAMED = {}


def _streamed() -> int:
    from zignal_tpu_torch.ops import fused_pipeline as fp

    return fp.STREAMED


def _keep_streamed(phase: str, since: int) -> None:
    """Adds K1's streamed launches since ``since`` to ``phase``'s."""
    K1_STREAMED[phase] = K1_STREAMED.get(phase, 0) + _streamed() - since


def _geometry_phases(card, rng) -> int:
    """Phases 20-22. Returns K4's launches of phase 20."""
    from zignal_tpu_torch import ImageBatch
    from zignal_tpu_torch.ops import motion_blur_ops

    n, b = GEO["side"], GEO["batch"]
    x = rng.integers(0, 256, (b, n, n, 3), np.uint8)
    ib = ImageBatch(x, device="cuda")
    calls = _geometry_calls(n)

    # 20. every path once, each with the launch counts read around it
    torch.cuda.synchronize()
    for m in _counted_modules():
        m.LAUNCHES = 0
    outs = {}
    for name, fn, k4 in calls:
        before = _counts()
        extra = ""
        if "radial" in name:
            t0 = time.perf_counter()
            motion_blur_ops.radial_coords(n, n, 0.5, 0.5, 0.5,
                                          "zoom" in name, ib.device)
            extra = (f", coordinates built in "
                     f"{time.perf_counter() - t0:.2f} s before it")
        t0 = time.perf_counter()
        outs[name] = fn(ib)
        torch.cuda.synchronize()
        got = tuple(a - c for a, c in zip(_counts(), before))
        print(f"phase 20 {name}: K1-K3 {got[:3]}, K4 {got[3]} launches, "
              f"{tuple(outs[name].device_array().shape)} "
              f"({time.perf_counter() - t0:.2f} s first call{extra})")
        if got != (0, 0, 0, k4):
            raise AssertionError(f"{name} launched (K1, K2, K3, K4) {got}, "
                                 f"not (0, 0, 0, {k4})")
    blurred = outs["motion_blur(linear(0, 9))"]
    metrics = _metric_calls(blurred)
    before = _counts()
    for name, fn in metrics:
        outs[name] = fn(ib)
    torch.cuda.synchronize()
    if _counts() != before:
        raise AssertionError("the metrics launched a kernel")
    for name in ("psnr", "ssim", "mean_pixel_error"):
        v = outs[name]
        if tuple(v.shape) != (b,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: {v.shape} {v}")
    print(f"phase 20 metrics against the blurred copy, image 0: psnr "
          f"{float(outs['psnr'][0]):.4f} dB, ssim "
          f"{float(outs['ssim'][0]):.6f}, mean_pixel_error "
          f"{float(outs['mean_pixel_error'][0]):.6f}, diff counts "
          f"{outs['diff'][1][:4].tolist()}...")
    k4_launches = _counts()[3]
    print(f"phase 20: K4 {k4_launches} launches, K1-K3 none")

    # 21. image 0 against the same calls on the CPU
    cpu = ImageBatch(x[:1], device="cpu")
    for name, fn, _ in calls:
        t0 = time.perf_counter()
        want = fn(cpu).device_array()
        got = outs[name].device_array()[:1].cpu()
        if got.shape != want.shape or not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape \
                else f"shape {tuple(got.shape)} vs {tuple(want.shape)}"
            raise AssertionError(f"{name}: {bad} values differ from the CPU")
        print(f"phase 21 {name}: equal to the CPU on image 0 "
              f"({time.perf_counter() - t0:.2f} s)")
    cpu_ib = ImageBatch(x[:1], device="cpu")
    cpu_blurred = ImageBatch(blurred.device_array()[:1].cpu(), device="cpu")
    for name, fn in _metric_calls(cpu_blurred):
        want = fn(cpu_ib)
        if name == "diff":
            ok = torch.equal(outs[name][0].device_array()[:1].cpu(),
                             want[0].device_array()) and \
                torch.equal(outs[name][1][:1].cpu(), want[1])
            print(f"phase 21 diff: visualisation and count equal to the "
                  f"CPU on image 0 {'ok' if ok else 'FAIL'}")
        else:
            got, ref = float(outs[name][0]), float(want[0])
            err = abs(got - ref)
            ok = err <= METRIC_REL * max(abs(ref), 1.0)
            print(f"phase 21 {name}: {got} on the card, {ref} on the CPU, "
                  f"err {err:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} on the card differs from the CPU")

    # 22. times
    print(f"phase 22: ImageBatch of [{b}, {n}, {n}, 3] u8")
    for name, fn, _ in calls:
        ms = _time_events(lambda: fn(ib))
        print(f"[{card}] phase 22 {name}: {ms:.4f} ms")
    for name, fn in metrics:
        ms = _time_events(lambda: fn(ib))
        print(f"[{card}] phase 22 {name} against the blurred copy: "
              f"{ms:.4f} ms")
    return k4_launches


# -- BASELINE configs 4 and 5 (phases 23-25) ---------------------------------

CONFIG4 = dict(side=1024, batch=4)   # bench.py:483-554
CONFIG5 = dict(side=512, batch=8, hough=256, hough_threshold=120,
               shapes=50)            # bench.py:556-680


def _fdm_close(label, got, want, phase: int = 23) -> int:
    """<= 1 u8 step at no more than FDM_SHARE of the values; returns the
    count of values that differ."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    n = int((d != 0).sum())
    ok = d.max() <= 1 and n <= FDM_SHARE * d.size
    print(f"phase {phase} {label}: {n} of {d.size} values differ from the "
          f"CPU, max {int(d.max())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} on the card differs from the CPU")
    return n


def _host_ms(fn, reps: int = 3) -> float:
    """Best host-clock ms of ``reps`` synchronized calls."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _stage_ms(stages):
    """One synchronized pass through ``stages`` ((name, fn) in order, each
    taking the previous output): CUDA-event ms of each."""
    out, times = None, []
    for name, fn in stages:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn(out)
        stop.record()
        torch.cuda.synchronize()
        times.append((name, start.elapsed_time(stop)))
    return times


def _orb_keys(result):
    kps, descs = result
    return ([(k.x, k.y, k.octave, k.size, k.response, k.angle)
             for k in kps], [d.bits.tobytes() for d in descs])


def _config4(card):
    """Phase 23: BASELINE config 4, FDM style transfer, on the card."""
    from zignal_tpu_torch import FeatureDistributionMatching, Image, \
        ImageBatch

    n, b = CONFIG4["side"], CONFIG4["batch"]
    src_np = synth_photo(n, n, seed=3)
    tgt_np = cast_target(n, n)
    batch_np = np.stack([src_np] + [synth_photo(n, n, seed=50 + i)
                                    for i in range(b - 1)])
    counts = _counts()
    fdm = FeatureDistributionMatching()
    tgt = Image.from_numpy(tgt_np.copy(), device="cuda")
    fdm.set_target(tgt)
    work = Image.from_numpy(src_np.copy(), device="cuda")
    fdm.set_source(work)
    fdm.update()
    batch = ImageBatch(batch_np, device="cuda")
    out = fdm.match_batch(batch, tgt)
    torch.cuda.synchronize()
    if _counts() != counts:
        raise AssertionError("config 4 launched a kernel")
    if tuple(out.shape) != (b, n, n, 3) or out.device.type != "cuda":
        raise AssertionError(f"match_batch gave {tuple(out.shape)} on "
                             f"{out.device}")
    src = Image.from_numpy(src_np.copy(), device="cuda")
    psnr, ssim = src.psnr(work), src.ssim(work)
    if not (np.isfinite(psnr) and -1.0 <= ssim <= 1.0):
        raise AssertionError(f"config 4 scores {psnr} {ssim}")
    print(f"phase 23 config 4, {n}^2: update() and match_batch(B={b}) ran, "
          f"no kernel launched; PSNR vs the source {psnr:.4f} dB, SSIM "
          f"{ssim:.6f}")
    # image 0 against the same port calls on the CPU
    cpu = FeatureDistributionMatching()
    cpu_work = Image.from_numpy(src_np.copy(), device="cpu")
    cpu.match(cpu_work, Image.from_numpy(tgt_np.copy(), device="cpu"))
    _fdm_close("update() image", work.to_numpy(), cpu_work.to_numpy())
    cpu_out = cpu.match_batch(batch_np[:1], Image.from_numpy(
        tgt_np.copy(), device="cpu"), device="cpu")
    _fdm_close("match_batch image 0", out[0].cpu().numpy(),
               cpu_out[0].numpy())
    cpu_src = Image.from_numpy(src_np.copy(), device="cpu")
    print(f"phase 23 CPU: PSNR {cpu_src.psnr(cpu_work):.4f} dB, SSIM "
          f"{cpu_src.ssim(cpu_work):.6f}")
    return fdm, tgt, src_np, batch


def _config5(card):
    """Phase 24: BASELINE config 5, ORB + matching + Hough + Canvas, on
    the card. Returns the (K1, K4) launches and what phase 25 times."""
    from zignal_tpu_torch import Canvas, Image
    from zignal_tpu_torch.features import BruteForceMatcher, Orb
    from zignal_tpu_torch.ops import orb_detect
    from zignal_tpu_torch.ops.hough import HoughTransform

    n, b = CONFIG5["side"], CONFIG5["batch"]
    img = Image.from_numpy(synth_photo(n, n, seed=5), device="cuda")
    rot = img.extract(img.get_rectangle(), angle=0.2)
    corpus = [img, rot] + [Image.from_numpy(synth_photo(n, n, seed=50 + i),
                                            device="cuda")
                           for i in range(b - 2)]
    orb = Orb()
    torch.cuda.synchronize()
    for m in _counted_modules():
        m.LAUNCHES = 0
    since, det = _streamed(), orb_detect.LAUNCHES
    results = orb.detect_and_compute_batch(corpus)
    torch.cuda.synchronize()
    k1, _, _, k4 = _counts()
    det = orb_detect.LAUNCHES - det
    _keep_streamed("24", since)
    want = (orb.n_levels - 1, 1, 1)
    print(f"phase 24 Orb().detect_and_compute_batch of {b} {n}^2 images: "
          f"K1 {k1} launches, K4 {k4}, DET {det} (want {want}); "
          f"keypoints {[len(r[0]) for r in results]}")
    if (k1, k4, det) != want or _counts()[1:3] != (0, 0):
        raise AssertionError(f"the ORB batch launched {_counts()}, DET "
                             f"{det}")
    matcher = BruteForceMatcher(cross_check=True, device="cuda")
    matches = matcher.match(results[0][1], results[1][1])
    edges = img.sobel()
    hough = HoughTransform(CONFIG5["hough"])
    acc = hough.compute(edges)
    lines = hough.find_lines(acc, threshold=CONFIG5["hough_threshold"])
    canvas_img = Image.from_numpy(np.zeros((n, n, 3), np.uint8),
                                  device="cuda")
    canvas = Canvas(canvas_img)

    def draw(c):
        for i in range(CONFIG5["shapes"]):
            c.draw_line((10 + i * 9, 20), (500 - i * 9, 490), (255, 128, 0))
            c.draw_circle((256, 256), 40 + i * 2, (0, 255, 128))

    draw(canvas)
    if not matches or acc.shape != (CONFIG5["hough"],) * 2 or \
            not canvas_img.to_numpy().any():
        raise AssertionError("config 5 produced nothing")
    print(f"phase 24: {len(matches)} cross-checked matches of image 0 to "
          f"its rotated view, {len(lines)} Hough lines "
          f"(accumulator max {int(acc.max())}), "
          f"{2 * CONFIG5['shapes']} shapes drawn")
    # image 0, the match and the accumulator against the CPU
    cpu_img = Image.from_numpy(img.to_numpy().copy(), device="cpu")
    cpu_rot = Image.from_numpy(rot.to_numpy().copy(), device="cpu")
    cpu_res = [orb.detect_and_compute(cpu_img),
               orb.detect_and_compute(cpu_rot)]
    for i in range(2):
        if _orb_keys(results[i]) != _orb_keys(cpu_res[i]):
            raise AssertionError(f"ORB of image {i} differs from the CPU")
    cpu_matches = BruteForceMatcher(cross_check=True, device="cpu").match(
        cpu_res[0][1], cpu_res[1][1])
    if [(m.query_idx, m.train_idx, m.distance) for m in matches] != \
            [(m.query_idx, m.train_idx, m.distance) for m in cpu_matches]:
        raise AssertionError("the matches differ from the CPU")
    cpu_edges = cpu_img.sobel()
    if not np.array_equal(edges.to_numpy(), cpu_edges.to_numpy()) or \
            not np.array_equal(acc, hough.compute(cpu_edges)):
        raise AssertionError("Sobel or the Hough accumulator differs from "
                             "the CPU")
    cpu_canvas = Image.from_numpy(np.zeros((n, n, 3), np.uint8),
                                  device="cpu")
    draw(Canvas(cpu_canvas))
    if not np.array_equal(canvas_img.to_numpy(), cpu_canvas.to_numpy()):
        raise AssertionError("the canvas differs from the CPU")
    print("phase 24: ORB of images 0 and 1 (keypoints, angles, "
          "descriptors), the matches, Sobel, the Hough accumulator and "
          "the canvas equal the CPU")
    return (k1, k4), (orb, corpus, results, matcher, img, edges,
                           hough, acc, draw)


def _config_times(card, c4, c5):
    """Phase 25: each stage of configs 4 and 5 with CUDA events and the
    host clock, and where the time of the two device paths goes."""
    from zignal_tpu_torch import Canvas, Image
    from zignal_tpu_torch import fdm as fdm_mod
    from zignal_tpu_torch.features import orb as orb_mod
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    fdm, tgt, src_np, batch = c4
    orb, corpus, results, matcher, img, edges, hough, acc, draw = c5
    work = Image.from_numpy(src_np.copy(), device="cuda")

    def update():
        work._np[:] = src_np
        fdm.set_source(work)
        fdm.update()

    n = CONFIG5["side"]
    blank = np.zeros((n, n, 3), np.uint8)
    stages = [
        ("config 4 set_target", lambda: fdm.set_target(tgt)),
        ("config 4 update", update),
        (f"config 4 match_batch B={CONFIG4['batch']}",
         lambda: fdm.match_batch(batch, tgt)),
        (f"config 5 detect_and_compute_batch B={CONFIG5['batch']}",
         lambda: orb.detect_and_compute_batch(corpus)),
        ("config 5 match (cross-check)",
         lambda: matcher.match(results[0][1], results[1][1])),
        ("config 5 sobel", img.sobel),
        ("config 5 hough.compute", lambda: hough.compute(edges)),
        ("config 5 find_lines",
         lambda: hough.find_lines(acc, CONFIG5["hough_threshold"])),
        ("config 5 canvas 50 lines + 50 circles",
         lambda: draw(Canvas(Image.from_numpy(blank.copy(),
                                              device="cuda")))),
    ]
    for name, fn in stages:
        ev = _time_ms(fn, 3)
        host = _host_ms(fn)
        print(f"[{card}] phase 25 {name}: {ev:.4f} ms (CUDA events), "
              f"{host:.4f} ms (host clock)")
    # where a config-4 update goes
    dev = work._device()[..., :3]
    split = _stage_ms([
        ("upload + u8 -> f32", lambda _: fdm_mod._unit(
            work._device()[..., :3]).reshape(-1, 3)),
        ("mean and covariance (tree sums, D2H)",
         lambda x: (x, fdm_mod._mean_cov(x))),
        ("host SVD", lambda a: (a[0], fdm_mod._map_for(
            *a[1], fdm._target_mean, fdm._target_s, fdm._target_u))),
        ("pixel map", lambda a: fdm_mod._apply_map(a[0], *a[1])),
        ("D2H of the result", lambda out: out.reshape(dev.shape).cpu()),
    ])
    print(f"[{card}] phase 25 config 4 update split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split))
    # where a config-5 ORB batch goes
    planes = torch.stack([orb_mod.plane_of(im, None) for im in corpus])
    h, w = planes.shape[-2:]
    ks, margins = orb._fused_params(h, w)

    def paste(_):
        pyr = ImagePyramid.build(planes, orb.n_levels, orb.scale_factor, 1.6)
        atlas = orb_mod._atlas(pyr.levels, orb.fast_threshold, ks, margins)
        return atlas, atlas.paste(pyr.levels)

    split = _stage_ms([
        ("pyramid (K4 + K1) and atlas", paste),
        ("detect kernel (FAST, NMS, Harris)",
         lambda a: (*a, a[0].candidates(a[1], True))),
        ("detect plain route",
         lambda a: (*a[:2], a[0].candidates_reference(a[1], True))),
        ("top-k sorts", lambda a: a[0].select(a[2])),
        ("whole device path + D2H", lambda _: [
            t.cpu() for t in orb.detect_and_compute_tensors(planes)]),
    ])
    print(f"[{card}] phase 25 config 5 ORB split (B={len(corpus)}; the "
          f"plain route's detect beside the kernel's, not in the path): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split))


# ORB's detect kernel at the orb_stereo cell's shape (ORB-SLAM2's KITTI
# settings): B frames of rows x cols
DETECT = dict(batch=8, rows=376, cols=1241, n_features=2000,
              edge_threshold=31)


def _detect_phase(card):
    """Phase 25b: ORB's detect kernel (csrc/orb_detect.cu) at the
    orb_stereo cell's shape against its plain route on the card (equal
    bit for bit with Harris's response and with the FAST score), then
    timed: plain, kernel, kernel, plain by CUDA events and the kernel's
    profiler device time, beside its bound. Returns the kernels line's
    entry; its launches are one request's, which phase 25c counts."""
    from zignal_tpu_torch.features import Orb
    from zignal_tpu_torch.features import orb as orb_mod
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    b, h, w = DETECT["batch"], DETECT["rows"], DETECT["cols"]
    orb = Orb(n_features=DETECT["n_features"],
              edge_threshold=DETECT["edge_threshold"])
    gen = torch.Generator().manual_seed(86)
    x = torch.randint(0, 256, (b, h, w), generator=gen, dtype=torch.uint8)
    x[:, 100:250, 300:900] //= 4  # a darker block: structure beside grain
    pyr = ImagePyramid.build(x.cuda(), orb.n_levels, orb.scale_factor, 1.6)
    atlas = orb_mod._atlas(pyr.levels, orb.fast_threshold,
                           *orb._fused_params(h, w))
    plane = atlas.paste(pyr.levels)
    for harris in (True, False):
        got = atlas.candidates(plane, harris)
        want = atlas.candidates_reference(plane, harris)
        equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        kept = int(torch.isfinite(want).sum())
        print(f"phase 25b detect kernel {list(plane.shape)} "
              f"harris={harris}: {kept} of {want.numel()} candidates kept, "
              f"{'equal to the plain route bit for bit' if equal else 'FAIL'}")
        if not equal:
            raise AssertionError("the detect kernel differs from the plain "
                                 "route")
    kern = lambda: atlas.candidates(plane, True)  # noqa: E731
    plain = lambda: atlas.candidates_reference(plane, True)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(plain, 5), _time_ms(kern), _time_ms(kern), \
        _time_ms(plain, 5)
    device = _device_ms(kern, "detect_kernel")
    bound_ms, bound_by = detect_bound(b, *atlas.shape, atlas.n)
    print(f"[{card}] phase 25b detect kernel B={b} of {h}x{w} (atlas "
          f"{atlas.shape[0]}x{atlas.shape[1]}, {atlas.n} candidates a "
          f"frame): {k1:.4f} / {k2:.4f} ms (CUDA events), {device:.4f} ms "
          f"(profiler, device), {100 * bound_ms / device:.1f} % of its "
          f"bound {bound_ms:.4f} ms ({bound_by}); plain route {p1:.3f} / "
          f"{p2:.3f} ms")
    return {
        "name": "orb_detect",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/orb_detect.cu",
        "replaces": None,  # the JAX package's FAST, NMS and Harris are jnp
        "launches": None,  # one request's (phase 25c)
        "max_abs_err": 0,
        "ms": min(k1, k2),
        "device_ms": device,
        "plain_ms": min(p1, p2),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no one PyTorch call runs FAST
    }


def _describe_phase(card):
    """Phase 25c: ORB's describe kernel (csrc/orb_describe.cu) at the
    orb_stereo cell's shape: on the keypoints the detect and select
    stages choose, against its plain route on the card (rows, descriptors
    and validity bit for bit), then timed (plain, kernel, kernel, plain by
    CUDA events, the kernel's profiler device time) beside its bound; one
    ORB request with the launch counters set to 0 just before it; the
    request's stages by CUDA events, the plain describe beside the
    kernel's. Returns the detect kernel's launches in that request and
    the kernels line's entry, its launches the request's."""
    from zignal_tpu_torch.features import Orb, matcher
    from zignal_tpu_torch.features import orb as orb_mod
    from zignal_tpu_torch.ops import orb_describe, orb_detect
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    b, h, w = DETECT["batch"], DETECT["rows"], DETECT["cols"]
    orb = Orb(n_features=DETECT["n_features"],
              edge_threshold=DETECT["edge_threshold"])
    gen = torch.Generator().manual_seed(86)
    x = torch.randint(0, 256, (b, h, w), generator=gen, dtype=torch.uint8)
    x[:, 100:250, 300:900] //= 4  # a darker block: structure beside grain
    x = x.cuda()
    ks, margins = orb._fused_params(h, w)

    def pasted(_):
        pyr = ImagePyramid.build(x, orb.n_levels, orb.scale_factor, 1.6)
        atlas = orb_mod._atlas(pyr.levels, orb.fast_threshold, ks, margins)
        return atlas, atlas.paste(pyr.levels)

    atlas, plane = pasted(None)
    resp, idx = atlas.select(atlas.candidates(plane, True))
    before = orb_describe.LAUNCHES
    got = atlas.describe(plane, resp, idx)
    want = atlas.describe_reference(plane, resp, idx)
    torch.cuda.synchronize()
    launches = orb_describe.LAUNCHES - before
    equal = launches == 1 and torch.equal(
        got[0].view(torch.int32), want[0].view(torch.int32)) and \
        torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    k = resp.shape[1]
    print(f"phase 25c describe kernel {list(plane.shape)}, {k} keypoints a "
          f"frame ({int(want[2].sum())} valid of {b * k}): "
          f"{'equal to the plain route bit for bit' if equal else 'FAIL'}")
    if not equal:
        raise AssertionError("the describe kernel differs from the plain "
                             "route")
    kern = lambda: atlas.describe(plane, resp, idx)  # noqa: E731
    plain = lambda: atlas.describe_reference(plane, resp, idx)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(plain, 5), _time_ms(kern), _time_ms(kern), \
        _time_ms(plain, 5)
    device = _device_ms(kern, "describe_kernel")
    bound_ms, bound_by = describe_bound(b, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        kern()
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    print(f"[{card}] phase 25c describe kernel B={b} of {h}x{w}, K={k}: "
          f"{k1:.4f} / {k2:.4f} ms (CUDA events), {device:.4f} ms "
          f"(profiler, device), {100 * bound_ms / device:.2f} % of its "
          f"bound {bound_ms:.4f} ms ({bound_by}); plain route {p1:.3f} / "
          f"{p2:.3f} ms; {host_us:.1f} us of host a call (100 issued)")
    # one request, its launches counted from 0
    orb.detect_and_compute_tensors(x)
    torch.cuda.synchronize()
    orb_describe.LAUNCHES = orb_detect.LAUNCHES = 0
    kps, desc, valid = orb.detect_and_compute_tensors(x)
    torch.cuda.synchronize()
    request = (orb_detect.LAUNCHES, orb_describe.LAUNCHES)
    print(f"phase 25c one ORB request of {b} frames: orb_detect "
          f"{request[0]}, orb_describe {request[1]} launches (want 1, 1)")
    if request != (1, 1):
        raise AssertionError(f"an ORB request launched {request}")
    split = lambda: _stage_ms([  # noqa: E731
        ("pyramid and atlas", pasted),
        ("detect", lambda a: (*a, a[0].candidates(a[1], True))),
        ("select", lambda a: (*a[:2], *a[0].select(a[2]))),
        ("describe kernel", lambda a: (*a, a[0].describe(*a[1:]))),
        ("describe plain route (beside)",
         lambda a: (*a, a[0].describe_reference(*a[1:4]))),
        (f"match ({b // 2} pairs)", lambda a: matcher.match_tensors(
            a[4][1][0::2], a[4][2][0::2], a[4][1][1::2], a[4][2][1::2])),
    ])
    split()  # the matcher's first call
    print(f"[{card}] phase 25c orb_stereo request split (CUDA events): "
          + ", ".join(f"{n} {v:.3f} ms" for n, v in split()))
    return request[0], {
        "name": "orb_describe",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/orb_describe.cu",
        "replaces": None,  # the JAX package's angle and BRIEF are jnp
        "launches": request[1],
        "max_abs_err": 0,
        "ms": min(k1, k2),
        "device_ms": device,
        "plain_ms": min(p1, p2),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no one PyTorch call rotates BRIEF
    }


def _orb_phases(card) -> list:
    """Phases 25b and 25c. Returns the detect and describe kernels'
    entries of the kernels line, each with its launches in one request."""
    det = _detect_phase(card)
    det["launches"], desc = _describe_phase(card)
    return [det, desc]


def _config_phases(card):
    """Phases 23-25c. Returns K1's and K4's launches of phase 24 and the
    detect and describe kernels' entries of the kernels line."""
    c4 = _config4(card)
    launches, c5 = _config5(card)
    _config_times(card, c4, c5)
    return launches, _orb_phases(card)


# -- colormaps, flood fill, Perlin noise, QR, GIF and the terminal ----------
# (phases 26-28)

SLICE10 = dict(batch=16, side=1024, spiral_width=16, qr_version=10,
               gif=(1200, 1600), frames=8, frame_side=512, sixel_side=512)
MAPS = ("jet", "heat", "turbo", "viridis", "inferno")
DITHERS = ("none", "ordered", "floyd_steinberg", "atkinson", "auto")


def spiral(n: int, w: int) -> np.ndarray:
    """A square spiral corridor of width ``w`` from (0, 0) inwards: about
    n / w turns (tests/test_torch_flood_fill.py fills it too)."""
    m = np.zeros((n, n), bool)
    r0, c0, r1, c1 = 0, 0, n - 1, n - 1
    while r1 - r0 > 2 * w and c1 - c0 > 2 * w:
        m[r0:r0 + w, c0:c1 + 1] = True
        m[r0:r1 + 1, c1 - w + 1:c1 + 1] = True
        m[r1 - w + 1:r1 + 1, c0 + 2 * w:c1 + 1] = True
        m[r0 + 2 * w:r1 + 1, c0 + 2 * w:c0 + 3 * w] = True
        r0, c0, r1, c1 = r0 + 2 * w, c0 + 2 * w, r1 - 2 * w, c1 - 2 * w
    return m


def _spiral_photo(n, w, seed):
    """The spiral in one colour with grain on a darker grainy ground."""
    rng = np.random.default_rng(seed)
    base = np.where(spiral(n, w)[..., None], 200, 40).astype(np.int32)
    return (base + rng.integers(0, 3, (n, n, 3))).astype(np.uint8)


def _on_card_equal(label, got, want) -> None:
    """``got`` (a tensor, ImageBatch or Image) is on the card and equal to
    ``want`` (the same call on the CPU)."""
    dev = got.device if hasattr(got, "device") else None
    if dev is None or torch.device(dev).type != "cuda":
        raise AssertionError(f"{label}: output on {dev}, not the card")
    g = got.to_numpy() if hasattr(got, "to_numpy") else got.cpu().numpy()
    w = want.to_numpy() if hasattr(want, "to_numpy") else want.numpy()
    if g.shape != w.shape or not np.array_equal(g, w):
        raise AssertionError(f"{label}: the card and the CPU differ")


def _slice10_device(card):
    """Phase 26: the slice's device paths on the card at full size, each
    output checked on the card and against the same call on the CPU.
    Returns K1's launches (kitty's scaling) and what phase 28 times."""
    from zignal_tpu_torch import (Colormap, Image, ImageBatch, Rgb,
                                  perlin_array, qrcode_decode, qrcode_encode)
    from zignal_tpu_torch.ops import flood_fill as ff
    from zignal_tpu_torch.terminal import kitty_from_image

    b, n = SLICE10["batch"], SLICE10["side"]
    rng = np.random.default_rng(26)
    arr = np.stack([synth_photo(n, n, seed=260 + i) for i in range(b)])
    arr[1] //= 5  # an image whose own range is narrow: 0..51
    batch = ImageBatch(arr, device="cuda")
    cpu_ends = ImageBatch(arr[[0, 1, b - 1]], device="cpu")
    calls = []
    for name in MAPS:
        for rng_ in ((None, None), (13, 200)):
            cm = Colormap(name, *rng_)
            got = batch.apply_colormap(cm)
            want = cpu_ends.apply_colormap(cm)
            _on_card_equal(f"colormap {name} {rng_}",
                           got.device_array()[[0, 1, b - 1]],
                           want.device_array())
            calls.append((f"ImageBatch.apply_colormap({name}, {rng_}) "
                          f"B={b}", lambda cm=cm: batch.apply_colormap(cm)))
    one = Image.from_numpy(arr[0].copy(), device="cuda")
    _on_card_equal("Image.apply_colormap",
                   one.apply_colormap(Colormap.viridis(0, 50)),
                   Image.from_numpy(arr[0].copy(), device="cpu")
                   .apply_colormap(Colormap.viridis(0, 50)))
    calls.append(("Image.apply_colormap(viridis, (0, 50))",
                  lambda: one.apply_colormap(Colormap.viridis(0, 50))))
    print(f"phase 26 apply_colormap: {len(MAPS)} maps at the auto range "
          f"and (13, 200) on [{b}, {n}, {n}, 3], images 0, 1 and {b - 1} "
          "equal to the CPU; Image.apply_colormap equal")

    w = SLICE10["spiral_width"]
    photo = _spiral_photo(n, w, 261)
    corridor = spiral(n, w)
    for mode in (0, 1):
        for conn in (4, 8):
            img = Image.from_numpy(photo.copy(), device="cuda")
            ref = Image.from_numpy(photo.copy(), device="cpu")
            before = ff.ITERATIONS
            img.flood_fill(0, 0, (255, 0, 255), 4.0, conn, mode)
            its = ff.ITERATIONS - before
            ref.flood_fill(0, 0, (255, 0, 255), 4.0, conn, mode)
            out = img.to_numpy()
            filled = (out == (255, 0, 255)).all(-1)
            if not np.array_equal(out, ref.to_numpy()) or \
                    not np.array_equal(filled, corridor):
                raise AssertionError(f"flood_fill mode {mode} conn {conn}: "
                                     "not the corridor, or not the CPU's")
            print(f"phase 26 Image.flood_fill {('SEED', 'NEIGHBOR')[mode]} "
                  f"{conn}-connected on the {n}^2 spiral (width {w}, "
                  f"{int(corridor.sum())} px): {its} iterations, equal to "
                  "the CPU and to the corridor")
            calls.append((f"Image.flood_fill {('SEED', 'NEIGHBOR')[mode]} "
                          f"{conn} ({its} iterations)",
                          lambda c=conn, m=mode: Image.from_numpy(
                              photo.copy(), device="cuda").flood_fill(
                                  0, 0, (255, 0, 255), 4.0, c, m)))
    spirals = ImageBatch(np.stack([_spiral_photo(n, w, 262 + i)
                                   for i in range(b)]), device="cuda")
    before = ff.ITERATIONS
    got = spirals.flood_fill(0, 0, (0, 255, 0), 4.0, 8, 1)
    its = ff.ITERATIONS - before
    want = ImageBatch(spirals.device_array()[:1].cpu(), device="cpu") \
        .flood_fill(0, 0, (0, 255, 0), 4.0, 8, 1)
    _on_card_equal("ImageBatch.flood_fill", got.device_array()[:1],
                   want.device_array())
    print(f"phase 26 ImageBatch.flood_fill NEIGHBOR 8 of [{b}, {n}, {n}, 3]: "
          f"{its} iterations, image 0 equal to the CPU")
    calls.append((f"ImageBatch.flood_fill NEIGHBOR 8 B={b} ({its} "
                  "iterations)", lambda: spirals.flood_fill(
                      0, 0, (0, 255, 0), 4.0, 8, 1)))

    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    noise = perlin_array(xx, yy, 0.5, octaves=4, frequency=1 / 64,
                         device="cuda")
    _on_card_equal("perlin_array", noise,
                   perlin_array(xx, yy, 0.5, octaves=4, frequency=1 / 64,
                                device="cpu"))
    if not bool(torch.isfinite(noise).all()) or float(noise.std()) < 0.05:
        raise AssertionError("perlin_array: not finite, or flat")
    xs, ys = torch.from_numpy(xx).cuda(), torch.from_numpy(yy).cuda()
    calls.append((f"perlin_array {n}^2, 4 octaves",
                  lambda: perlin_array(xs, ys, 0.5, octaves=4,
                                       frequency=1 / 64)))
    print(f"phase 26 perlin_array of {n}^2, 4 octaves: equal to the CPU, "
          f"range [{float(noise.min()):.4f}, {float(noise.max()):.4f}]")

    text = "zignal on the card, version 10: " + "".join(
        chr(c) for c in rng.integers(33, 127, 120))
    code = qrcode_encode(text, version=SLICE10["qr_version"], module_size=4,
                         device="cpu").convert(Rgb).to_numpy()
    scene = synth_photo(n, n, seed=263)
    top, left = (n - code.shape[0]) // 3, (n - code.shape[1]) // 2
    scene[top:top + code.shape[0], left:left + code.shape[1]] = code
    qr_img = Image.from_numpy(scene, device="cuda")
    got = qrcode_decode(qr_img)
    want = qrcode_decode(Image.from_numpy(scene.copy(), device="cpu"))
    if got is None or got.text != text or got.version != 10:
        raise AssertionError(f"qrcode_decode on the card gave {got}")
    if (got.text, got.corners, got.mask, got.corrected_errors) != \
            (want.text, want.corners, want.mask, want.corrected_errors):
        raise AssertionError("qrcode_decode: the card and the CPU differ")
    calls.append((f"qrcode_decode of a version-10 code in {n}^2",
                  lambda: qrcode_decode(qr_img)))
    print(f"phase 26 qrcode_decode of a version-10 code ({len(text)} "
          f"chars) in a {n}^2 synth_photo: the text back, corners "
          f"{[(round(x, 1), round(y, 1)) for x, y in got.corners]}, equal "
          "to the CPU")

    big = Image.from_numpy(synth_photo(n, n, seed=264), device="cuda")
    torch.cuda.synchronize()
    for m in _counted_modules():
        m.LAUNCHES = 0
    since = _streamed()
    k = kitty_from_image(big, width=n // 2)
    torch.cuda.synchronize()
    counts = _counts()
    _keep_streamed("26", since)
    print(f"phase 26 kitty of a {n}^2 CUDA Image scaled to {n // 2}: "
          f"launches K1-K4 {counts}")
    if counts != (1, 0, 0, 0):
        raise AssertionError(f"kitty's scaling launched {counts}, not K1 "
                             "once")
    if k != kitty_from_image(Image.from_numpy(big.to_numpy().copy(),
                                              device="cpu"), width=n // 2):
        raise AssertionError("kitty: the card and the CPU differ")
    calls.append((f"kitty {n}^2 -> {n // 2}",
                  lambda: kitty_from_image(big, width=n // 2)))
    return counts[0], calls


class _FallbackRan(AssertionError):
    pass


def _no_fallbacks():
    """Replace every Python fallback of the host library's entries with one
    that raises; returns the undo."""
    from zignal_tpu_torch.codecs import gif
    from zignal_tpu_torch.ops import dither, quantize
    from zignal_tpu_torch.terminal import sixel

    saved = []
    for mod, name in ((gif, "_lzw_encode_py"), (gif, "_lzw_decode_py"),
                      (dither, "_error_diffusion_py"),
                      (quantize, "_clt_table_py"),
                      (quantize, "_median_cut_py"),
                      (sixel, "_emit_bands_py")):
        saved.append((mod, name, getattr(mod, name)))

        def fail(*_a, _n=name, **_k):
            raise _FallbackRan(f"the Python fallback {_n} ran")

        setattr(mod, name, fail)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return undo


def _slice10_host(card):
    """Phase 27: the host paths on this machine's built library, every
    Python fallback made to raise. Returns what phase 28 times."""
    from zignal_tpu_torch import Image
    from zignal_tpu_torch.codecs import gif
    from zignal_tpu_torch.terminal import sixel

    h, w = SLICE10["gif"]
    photo = synth_photo(h, w, seed=270)
    fs = SLICE10["frame_side"]
    frames = [synth_photo(fs, fs, seed=271 + i) for i in range(
        SLICE10["frames"])]
    sx = Image.from_numpy(synth_photo(SLICE10["sixel_side"],
                                      SLICE10["sixel_side"], seed=279),
                          device="cuda")
    calls = []
    undo = _no_fallbacks()
    try:
        for mode in DITHERS:
            data = gif.encode(photo, dither=mode)
            pal, idx = gif._quantize_frame(photo, 256, mode)
            back, info = gif.decode(data)
            if (info.width, info.height, info.frame_count) != (w, h, 1) or \
                    not np.array_equal(back[..., :3], pal[idx]) or \
                    not (back[..., 3] == 255).all():
                raise AssertionError(f"GIF {mode}: the decoded frame is not "
                                     "the quantized image")
            print(f"phase 27 GIF {h}x{w} dither={mode}: {len(data)} bytes, "
                  f"{len(pal)} colours, decoded frame equal to the "
                  "quantized image")
            calls.append((f"gif.encode {h}x{w} {mode}",
                          lambda m=mode: gif.encode(photo, dither=m)))
            calls.append((f"gif.decode {h}x{w} {mode}",
                          lambda d=data: gif.decode(d)))
        delays = list(range(3, 3 + len(frames)))
        anim = gif.encode_animated(frames, delays, loop_count=0,
                                   dither="ordered")
        out = gif.decode_animated(anim)
        if out.frame_count != len(frames) or out.delays != delays:
            raise AssertionError("animated GIF: frames or delays lost")
        for f, got in zip(frames, out.frames):
            pal, idx = gif._quantize_frame(f, 256, "ordered")
            if not np.array_equal(got[..., :3], pal[idx]):
                raise AssertionError("animated GIF: a frame is not its "
                                     "quantized image")
        print(f"phase 27 animated GIF of {len(frames)} frames of {fs}^2: "
              f"{len(anim)} bytes, every frame equal to its quantized image")
        calls.append((f"gif.encode_animated {len(frames)} x {fs}^2",
                      lambda: gif.encode_animated(frames, delays,
                                                  dither="ordered")))
        calls.append((f"gif.decode_animated {len(frames)} x {fs}^2",
                      lambda: gif.decode_animated(anim)))
        text = sixel.sixel_from_image(sx)
        calls.append((f"sixel {SLICE10['sixel_side']}^2",
                      lambda: sixel.sixel_from_image(sx)))
    finally:
        undo()
    rgb = sx.to_numpy()
    palette = sixel.build_palette(rgb, "adaptive", 256)
    lut = sixel.ColorLookupTable(palette)
    mode = sixel.resolve_auto(len(palette), rgb.shape[1], rgb.shape[0])
    idx = sixel.apply_dither(rgb.copy(), palette, lut, mode)
    if not text.startswith(f'\x1bPq"1;1;{rgb.shape[1]};{rgb.shape[0]}') or \
            not text.endswith(sixel._emit_bands_py(idx) + "\x1b\\"):
        raise AssertionError("sixel: the library's bands are not the "
                             "Python emitter's")
    print(f"phase 27 sixel of {SLICE10['sixel_side']}^2: {len(text)} chars, "
          "bands equal to the Python emitter's; no Python fallback ran in "
          "phase 27")
    return calls


def _event_ms(fn) -> float:
    """ms a call by CUDA events, phase 26's call being the warm-up: one
    call, and as many as fit in about half a second when it is short."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(stop)
    if once > 100.0:
        return once
    return _time_ms(fn, max(1, min(20, int(500.0 / max(once, 1e-3)))))


def _slice10_times(card, device_calls, host_calls):
    """Phase 28: each call of phases 26-27 timed: CUDA events after a
    warm-up for the device paths, the best host clock of 3 for the host
    paths."""
    for name, fn in device_calls:
        print(f"[{card}] phase 28 {name}: {_event_ms(fn):.4f} ms "
              "(CUDA events)")
    for name, fn in host_calls:
        print(f"[{card}] phase 28 {name}: {_host_ms(fn):.4f} ms "
              "(host clock, best of 3)")


def _slice10_phases(card) -> int:
    """Phases 26-28. Returns K1's launches of phase 26."""
    t0 = time.perf_counter()
    k1, device_calls = _slice10_device(card)
    t1 = time.perf_counter()
    host_calls = _slice10_host(card)
    t2 = time.perf_counter()
    _slice10_times(card, device_calls, host_calls)
    print(f"phases 26-28: {t1 - t0:.1f} + {t2 - t1:.1f} + "
          f"{time.perf_counter() - t2:.1f} s")
    return k1


# -- the CLI and optimization/ (phases 29-30) --------------------------------

CLI = dict(side=1024, display=512, tiles=4, rounds=15, asks=8, hungarian=256)
TILE_MODES = ("square", "horizontal", "vertical", "grid", "factors")
QR_TEXT = "zignal-torch on the card"
RECIPE = (".{ .steps = .{ .{ .resize = .{ .scale = 0.5 } }, "
          ".{ .blur = .{ .type = .gaussian, .sigma = 2.0 } }, "
          ".{ .edges = .{ .filter = .sobel } } } }")


def _cli(argv, device) -> str:
    """``zignal-torch --device DEVICE ARGV`` in this process (warnings and
    errors logged); returns its stdout and raises unless it exits with
    0."""
    import contextlib
    import io

    from zignal_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--device", device, "--log-level", "warn", *argv])
    if rc != 0:
        raise AssertionError(f"zignal-torch {' '.join(argv)} on {device}: "
                             f"exit code {rc}")
    return out.getvalue()


def _outputs(d) -> dict:
    import os

    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _cli_commands(tmp, photos, src, tgt):
    """(name, argv of the card's run, (K1, K4) launches on the card) of
    every phase-29 command, in order; ``{out}`` is the device's own output
    directory. Later commands read earlier ones' outputs on the card."""
    import os

    recipe = os.path.join(tmp, "recipe.zon")
    with open(recipe, "w") as f:
        f.write(RECIPE)
    card = os.path.join(tmp, "cuda")
    resized = [os.path.join(card, "resize", os.path.basename(p) +
                            "_resized.png") for p in photos[:CLI["tiles"]]]
    blurred = os.path.join(card, "blur-src", "blurred.png")
    n = len(photos)
    cmds = [
        ("resize", ["resize", *photos, "--scale", "0.5", "-o", "{out}/"],
         (n, 0)),
        ("resize-lanczos", ["resize", *photos, "--scale", "0.5", "--filter",
                            "lanczos", "-o", "{out}/"], (0, 0)),
        ("blur", ["blur", *photos, "--type", "gaussian", "--sigma", "2",
                  "-o", "{out}/"], (0, n)),
        ("pipeline", ["pipeline", recipe, *photos, "-o", "{out}/"], (n, n)),
        ("fdm", ["fdm", src, tgt, "{out}/fdm.png"], (0, 0)),
    ]
    cmds += [(f"tile-{m}", ["tile", *resized, "--mode", m, "-o",
                            "{out}/tile.png"], (0, 0)) for m in TILE_MODES]
    cmds += [
        ("display", ["display", src, "--protocol", "kitty", "--width",
                     str(CLI["display"])], (1, 0)),
        ("blur-src", ["blur", src, "--sigma", "2", "-o",
                      "{out}/blurred.png"], (0, 1)),
        ("diff", ["diff", src, blurred, "-o", "{out}/diff.png"], (0, 0)),
        ("metrics", ["metrics", src, blurred], (0, 0)),
        ("qr-encode", ["qr", "encode", QR_TEXT, "-o", "{out}/qr.png"],
         (0, 0)),
        ("qr-decode", ["qr", "decode", os.path.join(card, "qr-encode",
                                                    "qr.png")], (0, 0)),
        ("info", ["info", *photos[:2], src, "--stats"], (0, 0)),
        ("version", ["version"], (0, 0)),
    ]
    return cmds


def _metric_numbers(text) -> dict:
    import re

    return {k: float(v) for k, v in
            re.findall(r"^(\w+): (-?[\d.]+|inf)", text, re.MULTILINE)}


def _cli_device(card, corpus, tmp):
    """Phase 29: every CLI command on the card, the launch counts read
    around each, its files and stdout against the same command with
    ``--device cpu``; the module entry in a subprocess; optimization/ on
    the card. Returns (K1, K4) launches and what phase 30 times."""
    import os

    from zignal_tpu_torch.codecs import load_array, save_array

    n = CLI["side"]
    photos = []
    for k, jpg in enumerate(corpus):
        # no extension: the CLI reads the format from the bytes and names
        # its outputs .png, so resize is config 1's JPEG -> PNG
        photos.append(os.path.join(tmp, f"photo{k:02d}"))
        with open(photos[-1], "wb") as f:
            f.write(jpg)
    src, tgt = os.path.join(tmp, "src.png"), os.path.join(tmp, "tgt.png")
    save_array(src, synth_photo(n, n, seed=3))
    save_array(tgt, cast_target(n, n))
    k1 = k4 = 0
    timed = []
    for name, argv, want in _cli_commands(tmp, photos, src, tgt):
        outs = {d: os.path.join(tmp, d, name) for d in ("cuda", "cpu")}
        for d in outs.values():
            os.makedirs(d)
        args = {d: [a.replace("{out}", outs[d]) for a in argv]
                for d in outs}
        counts, since = _counts(), _streamed()
        t0 = time.perf_counter()
        text = _cli(args["cuda"], "cuda")
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        got = tuple(a - b for a, b in zip(_counts(), counts))
        _keep_streamed("29", since)
        if got != (want[0], 0, 0, want[1]):
            raise AssertionError(f"phase 29 {name}: launches (K1, K2, K3, "
                                 f"K4) {got}, not {want}")
        k1, k4 = k1 + got[0], k4 + got[3]
        text_cpu = _cli(args["cpu"], "cpu")
        files, files_cpu = _outputs(outs["cuda"]), _outputs(outs["cpu"])
        if sorted(files) != sorted(files_cpu):
            raise AssertionError(f"phase 29 {name}: files {sorted(files)} "
                                 f"on the card, {sorted(files_cpu)} on the "
                                 "CPU")
        if name == "fdm":
            _fdm_close("zignal-torch fdm", load_array(
                os.path.join(outs["cuda"], "fdm.png")), load_array(
                os.path.join(outs["cpu"], "fdm.png")), phase=29)
        elif files != files_cpu:
            raise AssertionError(f"phase 29 {name}: the card's files differ "
                                 "from the CPU's")
        if name == "metrics":
            got_m, want_m = _metric_numbers(text), _metric_numbers(text_cpu)
            if sorted(got_m) != ["mean_pixel_error", "psnr", "ssim"] or any(
                    abs(got_m[k] - want_m[k]) > METRIC_REL * abs(want_m[k])
                    for k in want_m):
                raise AssertionError(f"phase 29 metrics: {got_m} on the "
                                     f"card, {want_m} on the CPU")
        elif text.replace(outs["cuda"], "") != \
                text_cpu.replace(outs["cpu"], ""):
            raise AssertionError(f"phase 29 {name}: stdout differs from "
                                 "the CPU's")
        if name == "qr-decode" and repr(QR_TEXT) not in text:
            raise AssertionError(f"phase 29 qr decode: {text!r}")
        if name == "version" and "zignal_tpu_torch" not in text:
            raise AssertionError(f"phase 29 version: {text!r}")
        size = sum(map(len, files.values()))
        print(f"phase 29 zignal-torch {name}: K1 {got[0]}, K4 {got[3]} "
              f"launches; {len(files)} files ({size / 1e6:.2f} MB) and "
              f"{len(text)} chars of stdout, "
              + ("metrics within 1e-5 relative of" if name == "metrics"
                 else "equal to") + " --device cpu")
        timed.append((name, lambda a=args["cuda"]: _cli(a, "cuda"),
                      first_ms))
    _cli_module_entry(photos[0], os.path.join(tmp, "cuda", "resize"), tmp)
    _optimization_on_card()
    return (k1, k4), timed, photos


def _cli_module_entry(photo, resized, tmp):
    """``python3 -m zignal_tpu_torch.cli --device cuda resize`` in a
    subprocess (no jax on this machine): its PNG equals phase 29's."""
    import os

    out = os.path.join(tmp, "module-entry.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "zignal_tpu_torch.cli", "--device", "cuda",
         "resize", photo, "--scale", "0.5", "-o", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m zignal_tpu_torch.cli: exit code "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out, "rb") as f, open(os.path.join(
            resized, os.path.basename(photo) + "_resized.png"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the module entry's PNG differs from "
                                 "phase 29's")
    logged = " | ".join(proc.stderr.splitlines()[:2])
    print(f"phase 29 python3 -m zignal_tpu_torch.cli --device cuda resize: "
          f"exit code 0 in {time.perf_counter() - t0:.1f} s, its PNG equal "
          f"to phase 29's; it logged: {logged}")


def _optimization_on_card():
    """``GlobalOptimizer.tell`` with CUDA tensors equal to numpy, and the
    assignment solver against scipy."""
    from scipy.optimize import linear_sum_assignment

    from zignal_tpu_torch import (GlobalOptimizer, Matrix,
                                  solve_assignment_problem)

    runs = []
    for on_card in (True, False):
        opt = GlobalOptimizer([(-5, 5), (-5, 5)], seed=7)
        asked = []
        for _ in range(CLI["rounds"]):
            X = opt.ask(CLI["asks"])
            asked.append(X)
            if on_card:
                d = torch.tensor(X, dtype=torch.float64, device="cuda") - 1.5
                Y = (d * d).sum(dim=1)
            else:
                d = np.asarray(X) - 1.5
                Y = (d * d).sum(axis=1)
            opt.tell(X, Y)
        runs.append((asked, opt.best(), opt.num_evaluations))
    if runs[0] != runs[1]:
        raise AssertionError("GlobalOptimizer: tell with CUDA tensors "
                             "diverged from tell with numpy")
    (x, y), evals = runs[0][1], runs[0][2]
    print(f"phase 29 GlobalOptimizer(seed=7): {CLI['rounds']} rounds of "
          f"ask({CLI['asks']}) told CUDA f64 tensors, every ask and the best "
          f"equal to numpy's; {evals} evaluations, best {y:.3e} at "
          f"({x[0]:.4f}, {x[1]:.4f})")
    m = CLI["hungarian"]
    c = np.random.default_rng(29).random((m, m)) * 100
    t0 = time.perf_counter()
    got = solve_assignment_problem(Matrix.from_numpy(c))
    dt = time.perf_counter() - t0
    ri, ci = linear_sum_assignment(c)
    want = float(c[ri, ci].sum())
    if got.assignments != ci.tolist() or \
            abs(got.total_cost - want) > 1e-9 * want:
        raise AssertionError(f"solve_assignment_problem {got.total_cost} "
                             f"vs scipy {want}")
    print(f"phase 29 solve_assignment_problem of a {m}x{m} Matrix: total "
          f"{got.total_cost:.6f}, the assignment and total equal to "
          f"scipy.optimize.linear_sum_assignment's, {dt:.2f} s on the host")


def _cli_times(card, timed, count, config1):
    """Phase 30: each phase-29 command on the card, the best host clock of
    3 (phase 29's run and two more); resize beside phase 16's config 1."""
    mpix = CONFIG1["rows"] * CONFIG1["cols"] / 1e6
    for name, fn, first_ms in timed:
        ms = min(first_ms, _host_ms(fn, reps=2))
        extra = ""
        if name in ("resize", "resize-lanczos", "blur", "pipeline"):
            extra = (f", {ms / count:.2f} ms an image, "
                     f"{count * mpix / (ms / 1e3):.2f} MPix/s")
        if name == "resize":
            extra += (f" (phase 16's config 1 in this run: "
                      f"{config1['latency_ms']:.2f} ms single-image "
                      f"latency, {config1['mpix_s']:.2f} MPix/s sustained)")
        print(f"[{card}] phase 30 zignal-torch {name}: {ms:.2f} ms "
              f"(host clock, best of 3){extra}")


def _cli_resize_split(card, photos, tmp):
    """Phase 30: ``resize_cmd``'s steps for each photo, each stage alone
    with a synchronize after it: Image.load (file read and decode), resize
    (upload and K1) and save (download, PNG encode, file write)."""
    import os

    from zignal_tpu_torch import Image

    split = {k: [] for k in ("load", "resize", "save")}
    for path in photos:
        t0 = time.perf_counter()
        img = Image.load(path, device="cuda")
        t1 = time.perf_counter()
        out = img.resize((img.rows // 2, img.cols // 2))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.save(os.path.join(tmp, "split.png"))
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(1e3 * dt)
    print(f"[{card}] phase 30 zignal-torch resize split, median ms an "
          "image: " + ", ".join(f"{k} {np.median(v):.3f}"
                                 for k, v in split.items())
          + f" (sum {sum(np.median(v) for v in split.values()):.2f})")


def _cli_phases(card, corpus, config1):
    """Phases 29-30. Returns K1's and K4's launches of phase 29."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        (k1, k4), timed, photos = _cli_device(card, corpus, tmp)
        t1 = time.perf_counter()
        _cli_times(card, timed, len(photos), config1)
        _cli_resize_split(card, photos, tmp)
    print(f"phases 29-30: {t1 - t0:.1f} + {time.perf_counter() - t1:.1f} s")
    return k1, k4


# -- the mesh: parallel/ and ImageBatch(mesh=) on NCCL (phases 31-33) -------

MESH = dict(batch=16, side=1024, out=512, sigma=2.0, big=4096, fdm=1024)
BORDERS = ("ZERO", "REPLICATE", "MIRROR", "WRAP")


def _local(out):
    """The rank's tensor(s) of a mesh result (the whole value on one rank):
    a DTensor's local tensor, an ImageBatch's tensor."""
    if isinstance(out, tuple):
        return tuple(_local(o) for o in out)
    if hasattr(out, "device_array"):
        out = out.device_array()
    return out.to_local() if hasattr(out, "to_local") else out


def _mesh_calls(mesh, mesh2):
    """(name, mesh call, the same call without a mesh, check) of phase 31:
    the north star through sharded_pipeline and ImageBatch(mesh=), the
    dry run's ImageBatch chains on the 1-D and the 1x1 mesh, every
    spatial function on one MESH["big"]^2 RGB image (the Gaussian blur in
    all four borders), the summed statistics and match_sharded."""
    from zignal_tpu_torch import FeatureDistributionMatching, Gray, Image
    from zignal_tpu_torch import ImageBatch, pipeline
    from zignal_tpu_torch import parallel as P
    from zignal_tpu_torch.enums import BorderMode
    from zignal_tpu_torch.fdm import _unit
    from zignal_tpu_torch.ops import binary, enhancement, integral, metrics
    from zignal_tpu_torch.ops import order_stat
    from zignal_tpu_torch.ops.convolution import gaussian_blur, \
        sobel_magnitude
    from zignal_tpu_torch.ops.tables import blur_radius

    rng = np.random.default_rng(31)
    n, o, sigma, big = MESH["side"], MESH["out"], MESH["sigma"], MESH["big"]
    x = _u8(rng, (MESH["batch"], n, n, 3))
    img = torch.from_numpy(synth_photo(big, big, seed=31)).cuda()
    other = gaussian_blur(img, 1.5)
    plane = img[..., 1].contiguous()
    fplane = plane.to(torch.float32)
    mask = (plane > 160).to(torch.uint8) * 255
    src = synth_photo(MESH["fdm"], MESH["fdm"], seed=3)
    tgt = Image.from_numpy(cast_target(512, 512), device="cuda")
    ib, ib2 = ImageBatch(x, mesh=mesh), ImageBatch(x, mesh=mesh2)
    plain = ImageBatch(x, device="cuda")
    big_h = img.shape[0]

    def chain(b):
        return b.resize((o, o)).gaussian_blur(1.0).convert(Gray).equalize()

    def chain2(b):
        return b.gaussian_blur(1.0).box_blur(1).autocontrast(0.01)

    def unit_stats():
        v = _unit(img).reshape(-1, 3).double()
        return v.mean(0), torch.cov(v.T)

    def batch_stats():
        v = x.reshape(-1, 3).double()
        mean = v.mean(0)
        return mean, v.T @ v / v.shape[0] - torch.outer(mean, mean)

    def fdm_plain():
        work = Image.from_numpy(src.copy(), device="cuda")
        FeatureDistributionMatching().match(work, tgt)
        return torch.from_numpy(work.to_numpy().copy())

    calls = [
        ("sharded_pipeline B=16 1024^2->512^2 s2",
         lambda: P.sharded_pipeline(mesh, o, o, sigma)(x),
         lambda: pipeline.resize_blur_oklab(x, o, o, sigma), "equal"),
        ("ImageBatch(mesh).resize_blur_oklab",
         lambda: ib.resize_blur_oklab((o, o), sigma=sigma),
         lambda: plain.resize_blur_oklab((o, o), sigma=sigma), "equal"),
        ("ImageBatch(mesh) resize->blur->Gray->equalize",
         lambda: chain(ib), lambda: chain(plain), "equal"),
        ("ImageBatch(1x1 mesh) blur->box_blur->autocontrast",
         lambda: chain2(ib2), lambda: chain2(plain), "equal"),
    ]
    for name in BORDERS:
        border = BorderMode[name]
        calls.append((
            f"spatial_gaussian_blur {big}^2 s{sigma} {name}",
            lambda b=border: P.spatial_gaussian_blur(mesh, sigma, b)(img),
            lambda b=border: gaussian_blur(img, sigma, b), "equal"))
    calls += [
        ("spatial_op(gaussian_blur s1.5, MIRROR)",
         lambda: P.spatial_op(mesh, lambda t: gaussian_blur(t, 1.5),
                              blur_radius(1.5))(img),
         lambda: gaussian_blur(img, 1.5), "equal"),
        ("spatial_box_blur r2", lambda: P.spatial_box_blur(mesh, big_h, 2)(img),
         lambda: integral.box_blur(img, 2), "equal"),
        ("spatial_sharpen r2", lambda: P.spatial_sharpen(mesh, big_h, 2)(img),
         lambda: integral.sharpen(img, 2), "equal"),
        ("spatial_adaptive_mean_threshold r6",
         lambda: P.spatial_adaptive_mean_threshold(mesh, big_h, 6, 5.0)(plane),
         lambda: binary.adaptive_mean_threshold(plane, 6, 5.0), "equal"),
        ("spatial_sobel", lambda: P.spatial_sobel(mesh)(fplane),
         lambda: sobel_magnitude(fplane), "equal"),
        ("spatial_dilate 3x1", lambda: P.spatial_dilate(mesh, 3, 1)(mask),
         lambda: binary.dilate(mask, 3, 1), "equal"),
        ("spatial_erode 3x2", lambda: P.spatial_erode(mesh, 3, 2)(mask),
         lambda: binary.erode(mask, 3, 2), "equal"),
        ("spatial_median_blur r1", lambda: P.spatial_median_blur(mesh, 1)(img),
         lambda: order_stat.median_blur(img, 1), "equal"),
        ("spatial_histogram", lambda: P.spatial_histogram(mesh)(img),
         lambda: binary.histogram256_multi(img), "equal"),
        ("spatial_equalize", lambda: P.spatial_equalize(mesh)(img),
         lambda: enhancement.equalize(img), "equal"),
        ("spatial_ssim", lambda: P.spatial_ssim(mesh, big_h)(img, other),
         lambda: metrics.ssim(img, other), "ssim"),
        ("spatial_mean_cov_image", lambda: P.spatial_mean_cov_image(mesh)(img),
         unit_stats, "unit_stats"),
        ("global_mean_cov B=16 1024^2", lambda: P.global_mean_cov(mesh)(x),
         batch_stats, "batch_stats"),
        (f"match_sharded {MESH['fdm']}^2",
         lambda: FeatureDistributionMatching().match_sharded(src, tgt, mesh),
         fdm_plain, "fdm"),
    ]
    return calls


def _mesh_check(name, kind, got, want) -> str:
    """Phase 31's check of a mesh output against the call without a mesh
    (the bounds of the CPU tests); raises on a miss."""
    got, want = _local(got), _local(want)
    if kind == "equal":
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        for g, w in pairs:
            if g.shape != w.shape or g.dtype != w.dtype or \
                    not torch.equal(g, w):
                raise AssertionError(f"phase 31 {name}: differs without "
                                     "the mesh")
        return "equal"
    if kind == "ssim":
        err = float((got.double() - want.double()).abs().max())
        if err >= 1e-5:
            raise AssertionError(f"phase 31 {name}: |d| {err} >= 1e-5")
        return f"|d| {err:.3g} (< 1e-5)"
    if kind in ("unit_stats", "batch_stats"):
        (mean, cov), (w_mean, w_cov) = got, want
        tol = dict(rtol=1e-5, atol=1e-7) if kind == "unit_stats" \
            else dict(rtol=1e-4, atol=1e-2)
        ok = torch.allclose(mean.double(), w_mean, rtol=1e-5, atol=1e-7) \
            and torch.allclose(cov.double(), w_cov, **tol)
        if not ok:
            raise AssertionError(f"phase 31 {name}: off the f64 reference")
        err = float((cov.double() - w_cov).abs().max())
        return f"within the f64 reference (cov |d| {err:.3g})"
    diff = (got.cpu().int() - want.int()).abs()
    share = float((diff > 0).double().mean())
    if int(diff.max()) > 1 or share >= 0.02:
        raise AssertionError(f"phase 31 {name}: {int(diff.max())} steps at "
                             f"{share:.4%}")
    return f"<= {int(diff.max())} u8 step at {share:.4%} of values (< 2 %)"


def _mesh_phases(card):
    """Phases 31-33: the mesh on this card (NCCL, a group of this process
    alone), the dry runs, and the mesh calls timed beside the same calls
    without a mesh. Returns K1's and K4's launches of phase 31."""
    import torch.distributed as dist

    from zignal_tpu_torch.entry import dryrun_multichip
    from zignal_tpu_torch.parallel import _comm, make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(1, device="cuda")
    mesh2 = make_mesh((1, 1), ("batch", "space"), device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the card's mesh runs {dist.get_backend()}")
    print(f"phase 31: backend {dist.get_backend()}, meshes "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names} and "
          f"{tuple(mesh2.shape)} {mesh2.mesh_dim_names}")
    calls = _mesh_calls(mesh, mesh2)
    mods = _counted_modules()
    fp, fc, cc, sc = mods
    outs = []
    torch.cuda.synchronize()
    for m in mods:
        m.LAUNCHES = 0
    since = _streamed()
    _comm.reset_counts()
    for name, fn, _, _ in calls:
        before = _counts()
        outs.append(fn())
        torch.cuda.synchronize()
        k1, k4 = fp.LAUNCHES - before[0], sc.LAUNCHES - before[3]
        print(f"phase 31 {name}: K1 {k1}, K4 {k4} launches")
    torch.cuda.synchronize()
    launches, collectives = _counts(), dict(_comm.COLLECTIVES)
    _keep_streamed("31", since)
    print(f"phase 31: K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]} launches; collectives "
          f"{collectives}")
    if launches[1] or launches[2]:
        raise AssertionError("K2 or K3 launched on the mesh path")
    if not launches[0] or not launches[3]:
        raise AssertionError("the mesh path did not reach K1 and K4")
    for (name, _, plain, kind), got in zip(calls, outs):
        print(f"phase 31 {name}: {_mesh_check(name, kind, got, plain())}")
    t1 = time.perf_counter()

    # 33. each call with and without the mesh, in turns
    for name, fn, plain, _ in calls:
        p1, m1 = _time_events(plain), _time_events(fn)
        print(f"[{card}] phase 33 {name}: mesh {m1:.4f} ms, without "
              f"{p1:.4f} ms (CUDA events)")
    dist.destroy_process_group()
    t2 = time.perf_counter()

    # 32. the dry runs: one card on NCCL in this process, 4 gloo CPU ranks
    dryrun_multichip(1, device="cuda")
    print("phase 32: dryrun_multichip(1, device='cuda') ok")
    dryrun_multichip(4, device="cpu")
    print("phase 32: dryrun_multichip(4, device='cpu') ok")
    print(f"phases 31-33: {t1 - t0:.1f} + {t2 - t1:.1f} + "
          f"{time.perf_counter() - t2:.1f} s")
    return launches[0], launches[3]


# -- the port's profiling on the card: measure, trace, Profile (phase 34) ----


def _trace_events(log_dir) -> list:
    """The events of the one trace file under ``log_dir``."""
    import pathlib

    files = list(pathlib.Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {len(files)} files in {log_dir}")
    return json.loads(files[0].read_text())["traceEvents"]


def _kernel_events(events, names) -> list:
    """The kernel events on the card whose name holds one of ``names``."""
    return [e for e in events if e.get("cat") == "kernel"
            and "device" in e.get("args", {})
            and any(name in e.get("name", "") for name in names)]


def _phase34_calls():
    """Phase 34's batch, planes and calls: (kernel, its wrapper module,
    the call, its label)."""
    from zignal_tpu_torch import ImageBatch, pipeline
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp

    n, o, sigma, b = MAIN["size"], MAIN["out"], MAIN["sigma"], FILTER_BATCH
    rng = np.random.default_rng(34)
    ib = ImageBatch(rng.integers(0, 256, (b, n, n, 3), np.uint8),
                    device="cuda")
    planes = _u8(rng, (b, n, n))
    return ib, planes, (
        ("K1", fp, lambda: ib.resize_blur_oklab((o, o), sigma=sigma),
         f"ImageBatch.resize_blur_oklab B={b} {n}^2->{o}^2 sigma={sigma}"),
        ("K2", fc, lambda: pipeline.filter_chain(planes, sigma, 2, 128.0),
         f"pipeline.filter_chain B={b} {n}^2 sigma={sigma} r2 thr 128"),
    )


def trace_calls(log_dir) -> int:
    """``--trace DIR``: one warm call of each phase-34 call, then one of
    each under ``profiling.trace(DIR)``; each kernel must launch once."""
    from zignal_tpu_torch.profiling import trace

    _, _, calls = _phase34_calls()
    for _, _, call, _ in calls:
        call()
    torch.cuda.synchronize()
    before = [mod.LAUNCHES for _, mod, _, _ in calls]
    with trace(log_dir):
        for _, _, call, _ in calls:
            call()
    launched = [mod.LAUNCHES - b for (_, mod, _, _), b in zip(calls, before)]
    if launched != [1, 1]:
        raise AssertionError(f"--trace: K1 and K2 launched {launched} times")
    print(f"--trace: K1 and K2 launched once each under trace({log_dir})")
    return 0


def _profiling_phases(card, corpus):
    """Phase 34: zignal_tpu_torch.profiling on the card. (a) measure of the
    north star (K1) and of config 3's filter_chain (K2) beside _time_ms of
    the same call, each output equal to its plain version; (b) trace of
    one call of each, whose file must hold both kernels' events on the
    card; (c) Profile of config 1's stages for one of its JPEGs. Returns
    K1's and K2's launches."""
    import os
    import tempfile

    from zignal_tpu_torch import Image
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.profiling import Profile, measure

    t0 = time.perf_counter()
    n, o, sigma, b = MAIN["size"], MAIN["out"], MAIN["sigma"], FILTER_BATCH
    ib, planes, calls = _phase34_calls()
    x = ib.device_array()
    torch.cuda.synchronize()
    fp.LAUNCHES = fc.LAUNCHES = 0
    since = _streamed()

    # (a) measure beside _time_ms; the outputs against the plain versions
    for name, mod, call, label in calls:
        before = mod.LAUNCHES
        secs, gpix = measure(call, pixels=b * n * n)
        torch.cuda.synchronize()
        if mod.LAUNCHES == before:
            raise AssertionError(f"phase 34: measure of {label} did not "
                                 f"launch {name}")
        if not (np.isfinite(secs) and secs > 0 and np.isfinite(gpix)
                and gpix > 0):
            raise AssertionError(f"phase 34: measure of {label} gave "
                                 f"{secs} s, {gpix} GPix/s")
        events = _time_ms(call)
        print(f"[{card}] phase 34 measure {label}: {1e3 * secs:.4f} ms a "
              f"call, {gpix:.2f} GPix/s; _time_ms {events:.4f} ms "
              f"({b * n * n / events / 1e6:.2f} GPix/s)")
    lab, mask = calls[0][2](), calls[1][2]()
    torch.cuda.synchronize()
    want = fp.fused_resize_blur_oklab_reference(x, o, o, sigma)
    err = float((lab - want).abs().max())
    if tuple(lab.shape) != (b, o, o, 3) or not bool(
            torch.isfinite(lab).all()) or err > OKLAB_TOL:
        raise AssertionError(f"phase 34: K1's output {tuple(lab.shape)} "
                             f"max_abs_err={err}")
    _check_equal(f"phase 34 {calls[1][3]}", mask,
                 fc.fused_blur_sharpen_morph_reference(planes, sigma, 2,
                                                       128.0))
    print(f"phase 34 {calls[0][3]}: Oklab max_abs_err={err} ok")

    # (b) one call of each under trace, in a fresh process: on the H100
    # machine torch.profiler dropped the card's kernel events from a trace
    # taken tens of seconds after the process's first profiler session
    # (their timestamps drift from the host's by milliseconds, and Kineto
    # keeps only events inside the window; PERF.md §7)
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trace", tmp],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"phase 34: chip_smoke.py --trace: exit "
                                 f"code {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        print(proc.stdout.strip().splitlines()[-1])
        events = _trace_events(tmp)
        k1 = _kernel_events(events, K1_NAMES)
        k2 = _kernel_events(events, (K2_NAME,))
        if not k1 or not k2:
            cats = sorted({str(e.get("cat")) for e in events})
            raise AssertionError(f"phase 34: the trace in {tmp} holds "
                                 f"{len(k1)} K1 and {len(k2)} K2 kernel "
                                 f"events on the card (categories {cats})")
        print(f"[{card}] phase 34 trace {tmp}: K1 {k1[0]['name'][:60]} "
              f"{k1[0]['dur']} us, K2 {k2[0]['name'][:60]} "
              f"{k2[0]['dur']} us (device {k1[0]['args']['device']})")

        # (c) config 1's stages of one JPEG under Profile
        src, dst = f"{tmp}/photo.jpg", f"{tmp}/photo.png"
        with open(src, "wb") as f:
            f.write(corpus[0])
        prof = Profile()
        for _ in range(4):
            with prof.stage("Image.load"):
                img = Image.load(src, device="cuda")
            with prof.stage("resize (K1)"):
                small = _launched(lambda: img.resize(
                    (img.rows // 2, img.cols // 2)), fp, "phase 34 resize")
                torch.cuda.synchronize()
            with prof.stage("PNG save"):
                small.save(dst)
        print(f"[{card}] phase 34 Profile of config 1's stages, "
              f"{img.rows}x{img.cols} JPEG -> {small.rows}x{small.cols} "
              f"PNG, 4 passes:\n{prof.report()}")
    torch.cuda.synchronize()
    launches = fp.LAUNCHES, fc.LAUNCHES
    _keep_streamed("34", since)
    print(f"phase 34: K1 {launches[0]}, K2 {launches[1]} launches; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# -- entry() and the port's bench on the card (phase 35) ---------------------

BENCH_TIMEOUT = 600  # s; the bench's full run takes well under a tenth


def _bench_phases(card) -> dict:
    """Phase 35: entry() once on the card (K1 once, Oklab within 5e-6 of
    plain), then ``python -m zignal_tpu_torch.bench`` at full size in a
    subprocess: exit 0, bench.py's six metric names in its order, each
    with a positive value, its check and this card's name, the summary's
    values complete, every kernel launched and K3p once. Returns the
    launches by kernel, entry()'s among them."""
    import os

    from zignal_tpu_torch.bench import _CONFIGS, _METRIC_NAMES
    from zignal_tpu_torch.entry import entry
    from zignal_tpu_torch.ops import fused_pipeline as fp

    t0 = time.perf_counter()
    fn, args = entry()
    since = _streamed()
    lab = _launched(lambda: fn(*args), fp, "phase 35 entry()")
    _keep_streamed("35", since)
    err = float((lab - fp.fused_resize_blur_oklab_reference(
        args[0], 128, 128, 1.5)).abs().max())
    if args[0].device.type != "cuda" or tuple(lab.shape) != \
            (2, 128, 128, 3) or err > OKLAB_TOL:
        raise AssertionError(f"phase 35 entry(): {tuple(lab.shape)} on "
                             f"{args[0].device}, max_abs_err={err}")
    print(f"phase 35 entry(): fn(*args) ran as returned on "
          f"{args[0].device}, K1 1 launch, Oklab max_abs_err={err} ok")
    del fn, args, lab
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zignal_tpu_torch.bench"],
                          cwd=root, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    out = proc.stdout.strip().splitlines()
    for line in out:
        print(f"[{card}] phase 35 bench: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 35: the bench exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(line) for line in out]
    configs, summary = lines[:-1], lines[-1]
    if [x["metric"] for x in configs] != [_METRIC_NAMES[n]
                                          for n in _CONFIGS]:
        raise AssertionError("phase 35: the bench's lines are not bench.py's "
                             "six configs in order")
    for x in configs:
        if "error" in x or not x.get("check") or x["device"] != card or \
                not (isinstance(x["value"], (int, float)) and x["value"] > 0):
            raise AssertionError(f"phase 35: bad line {x}")
    values = summary.get("values", {})
    if len(out[-1].encode()) >= 2000 or not summary.get("summary") or \
            summary.get("device") != card or set(values) != set(_CONFIGS) \
            or any(v is None for v in values.values()):
        raise AssertionError(f"phase 35: bad summary {out[-1]}")
    launches = {k: sum(x["launches"][k] for x in configs)
                for k in ("K1", "K2", "K3", "K3p", "K4", "DET", "DESC")}
    K1_STREAMED["35"] += sum(x["k1_streamed"] for x in configs)
    if min(launches.values()) < 1 or launches["K3p"] != 1:
        raise AssertionError(f"phase 35: the bench launched {launches}")
    print(f"phase 35: the bench ran bench.py's six configs in "
          f"{time.perf_counter() - t1:.1f} s, every check passed, launches "
          f"{launches}; summary {len(out[-1].encode())} bytes; phase "
          f"{time.perf_counter() - t0:.1f} s")
    launches["K1"] += 1  # entry()'s
    return launches


def _profile_one(card, name, fn, reps: int = 3) -> None:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm-up: device
    ms a call (all its kernels and copies), the host clock beside it, and
    the five rows with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    total = sum(r[0] for r in rows) / reps / 1e3
    print(f"[{card}] profile {name}: {total:.3f} ms of device time a "
          f"call, {host:.3f} ms on the host clock (profiled)")
    for us, count, key in rows[:5]:
        print(f"    {us / reps / 1e3:8.3f} ms {count // reps:4d} a call "
              f"{key[:100]}")


def calls_profile() -> int:
    """--profile: where the device time of each phase-20 call and of
    phase 26's device calls goes (the QR decode, seconds of host scan a
    call, left out)."""
    from zignal_tpu_torch import ImageBatch

    card = _card()
    print(card)
    n, b = GEO["side"], GEO["batch"]
    x = np.random.default_rng(0).integers(0, 256, (b, n, n, 3), np.uint8)
    ib = ImageBatch(x, device="cuda")
    calls = [(name, fn) for name, fn, _ in _geometry_calls(n)]
    calls += _metric_calls(calls[7][1](ib))  # against linear(0, 9)
    for name, fn in calls:
        _profile_one(card, name, lambda fn=fn: fn(ib))
    _, slice10 = _slice10_device(card)
    for name, fn in slice10:
        if not name.startswith("qrcode_decode"):
            _profile_one(card, name, fn)
    return 0


# K1 at the edges of its tile plans: outputs just below, at and above the
# tile sides (8-64) and past 128, from a 2:1 source and from an upscale
K1_EDGE_OUT = ((1, 130), (7, 9), (15, 17), (31, 33), (33, 47), (48, 49),
               (63, 65), (64, 1), (127, 129))
K1_EDGE_SIGMAS = (0.0, 1.0, 1.5, 2.0, 3.5)


def _k1_edges(rng):
    """Phase 2b: K1 vs plain at the edges of its tile plans, C 1-5 (2 and
    5 in channel groups), B 1 and 16, Oklab on for RGB."""
    from zignal_tpu_torch.ops import fused_pipeline as fp

    pairs, lab_err = [], 0.0
    for c in range(1, 6):
        for oh, ow in K1_EDGE_OUT:
            for b in (1, 16):
                for h, w in ((2 * oh + 1, 2 * ow + 3),
                             (oh // 2 + 1, ow // 3 + 2)):
                    x = _u8(rng, (b, h, w, c))
                    for sigma in K1_EDGE_SIGMAS:
                        pairs.append((
                            fp.fused_resize_blur_oklab(x, oh, ow, sigma,
                                                       oklab=False),
                            fp.fused_resize_blur_oklab_reference(
                                x, oh, ow, sigma, oklab=False)))
                        if c == 3:
                            got = fp.fused_resize_blur_oklab(x, oh, ow, sigma)
                            want = fp.fused_resize_blur_oklab_reference(
                                x, oh, ow, sigma)
                            lab_err = max(lab_err, float(
                                (got - want).abs().max()))
    _check_all(f"K1 tile-plan edges (outputs {K1_EDGE_OUT}, 2:1 and "
               f"upscaled sources, B 1 and 16, sigma {K1_EDGE_SIGMAS}, C 1-5)",
               pairs)
    print(f"K1 tile-plan edges, Oklab: max_abs_err={lab_err} "
          f"{'ok' if lab_err <= OKLAB_TOL else 'FAIL'}")
    if lab_err > OKLAB_TOL:
        raise AssertionError("K1 Oklab != plain at the tile-plan edges")


def _k1_streamed_vs_tile(x) -> None:
    """Phase 3c: at the north star's shape (B=16 of 1024^2 -> 512^2, sigma
    2) the streamed kernel, the tile kernel (its plan refused) and the
    plain version: u8 and Oklab f32 bitwise the tile kernel's, u8 equal to
    the plain version's, Oklab within OKLAB_TOL of it."""
    from zignal_tpu_torch.ops import _build
    from zignal_tpu_torch.ops import fused_pipeline as fp

    n, o, sigma = MAIN["size"], MAIN["out"], MAIN["sigma"]
    outs = {}
    for label in ("streamed", "tile"):
        saved = fp._stream_plan
        if label == "tile":
            fp._stream_plan = lambda *a: None
        _build.PLANS.clear()
        streamed = fp.STREAMED
        outs[label] = [fp.fused_resize_blur_oklab(x, o, o, sigma, oklab)
                       for oklab in (False, True)]
        fp._stream_plan = saved
        _build.PLANS.clear()
        if fp.STREAMED - streamed != (2 if label == "streamed" else 0):
            raise AssertionError(f"K1 {label}: {fp.STREAMED - streamed} of 2 "
                                 "launches streamed")
    torch.cuda.synchronize()
    (u8, lab), (u8_tile, lab_tile) = outs["streamed"], outs["tile"]
    same = torch.equal(u8, u8_tile) and torch.equal(lab, lab_tile)
    plain = fp.fused_resize_blur_oklab_reference(x, o, o, sigma, oklab=False)
    err = float((lab - fp.fused_resize_blur_oklab_reference(
        x, o, o, sigma)).abs().max())
    ok = same and torch.equal(u8, plain) and err <= OKLAB_TOL
    print(f"K1 streamed vs tile at B={x.shape[0]} {n}^2->{o}^2 sigma={sigma}: "
          f"u8 and Oklab bitwise equal {same}, u8 equal to plain "
          f"{torch.equal(u8, plain)}, Oklab max_abs_err={err} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the streamed K1 differs from the tile kernel "
                             "or the plain version")


def _fault_cases(rng) -> float:
    """Phase 3b: the repaired faults through the user's entry points, each
    with the launch counts read around it: F1, pipeline.filter_chain and
    pipeline.resize_blur_oklab on strided views (K2, K1); F2, a u8
    bilinear resize of 2, 5 and 8 channels (K1 in channel groups); F3,
    gaussian_blur of 5 and 8 channels and a 6-channel resize band (K4 in
    channel groups). Returns the Oklab max-abs error."""
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc
    from zignal_tpu_torch.ops import tables
    from zignal_tpu_torch.ops.convolution import convolve_separable_reference, \
        gaussian_blur
    from zignal_tpu_torch.ops.interpolation import resize

    x = _u8(rng, (4, 512, 384, 3))
    mask = _launched(lambda: pipeline.filter_chain(x[..., 0]), fc,
                    "F1 filter_chain on a strided plane")
    _check_equal("F1 filter_chain(x[..., 0]) on [4, 512, 384, 3] (K2)", mask,
                 fc.fused_blur_sharpen_morph_reference(
                     x[..., 0].contiguous()))
    lab = _launched(lambda: pipeline.resize_blur_oklab(x[:, ::2], 128, 96,
                                                      1.0), fp,
                   "F1 resize_blur_oklab on a strided batch")
    err = float((lab - fp.fused_resize_blur_oklab_reference(
        x[:, ::2].contiguous(), 128, 96, 1.0)).abs().max())
    print(f"F1 resize_blur_oklab(x[:, ::2], 128, 96, 1.0) (K1): "
          f"max_abs_err={err} {'ok' if err <= OKLAB_TOL else 'FAIL'}")
    if err > OKLAB_TOL:
        raise AssertionError("F1 resize_blur_oklab != plain")
    for c in (2, 5, 8):
        y = _u8(rng, (4, 300, 250, c))
        got = _launched(lambda: resize(y, 149, 163), fp, f"F2 resize C={c}",
                       fp.launches_for(c))
        _check_equal(f"F2 resize [4, 300, 250, {c}] -> 149x163 (K1, channel "
                     "groups)", got, fp.fused_resize_blur_oklab_reference(
                         y, 149, 163, 0.0, oklab=False))
        if c > 4:
            k = tables.gaussian_kernel(1.0)
            got = _launched(lambda: gaussian_blur(y, 1.0), sc,
                           f"F3 gaussian_blur C={c}", sc.launches_for(c))
            _check_equal(f"F3 gaussian_blur [4, 300, 250, {c}] sigma=1 (K4, "
                         "channel groups)", got,
                         convolve_separable_reference(y, k, k))
    y = _u8(rng, (2, 300, 250, 6))
    bands = []
    for m in (250, 300):
        a, b, f = tables.bilinear_axis_table(m, m // 2)
        bands.append(tables.build_tap_matrix(
            np.stack([a, b], 1), np.stack([256 - f, f], 1), m, m // 2))
    got = _launched(lambda: sc.separable_u8(y, *bands), sc, "F3 band C=6",
                   sc.launches_for(6))
    _check_equal("F3 separable_u8 [2, 300, 250, 6] bilinear band (K4 band "
                 "kernel, channel groups)", got,
                 sc.separable_u8_reference(y, *bands))
    return err


# K3's chains of growing length: (rgb, s, rgb, s, ..., rgb) with s = lab
# (3 cube roots a hop) or xyz (none); the kernel carries linear RGB across
# the rgb junctions, so each added hop costs its two edges and nothing else
K3_HOPS = (1, 5, 9)


def _k3_slope(x, label: str) -> None:
    """``--times``: what a cube root costs inside K3, from the profiler's
    device time of chains of 1, 5 and 9 lab hops and of as many xyz hops
    (the same mixes, no root) on the u8 batch ``x``: the lab slope a hop
    less the xyz slope, over 3, printed in ms and as f32 ops a pixel at
    the peak rate. A diagnostic of the kernel (its stalls count); the
    bounds use CBRTF_OPS instead."""
    from zignal_tpu_torch.ops import color_chain as cc

    ms = {(s, h): _device_ms(lambda c=("rgb",) + (s, "rgb") * h:
                             cc.fused_color_chain_u8(x, c), K3_NAMES)
          for s in ("lab", "xyz") for h in K3_HOPS}
    slope = {s: float(np.polyfit(K3_HOPS, [ms[s, h] for h in K3_HOPS], 1)[0])
             for s in ("lab", "xyz")}
    root = (slope["lab"] - slope["xyz"]) / 3
    print(f"{label} K3 chains on {tuple(x.shape)}: "
          + ", ".join(f"{s} x{h} {t:.4f}" for (s, h), t in ms.items())
          + f" ms (profiler, device); slope a hop: lab {slope['lab']:.5f} "
          f"ms, xyz {slope['xyz']:.5f} ms; a cube root in the kernel "
          f"{root:.5f} ms, {root * 1e-3 * F32_OPS_S / (x.numel() // 3):.1f} "
          f"f32 ops a pixel (CBRTF_OPS {CBRTF_OPS})", flush=True)


def _host_us(fn, reps: int = 200) -> float:
    """µs of host time a call, back to back without a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


# K1's two kernels timed apart (--times): (B, side, sigma) of side^2 RGB
# -> (side / 2)^2, Oklab. The north star's shape at B 16, 4 and 1 (8-row
# segments for 12 warm-up rows), 16 of 256^2 (the same), and the streamed
# grids around the plan's MIN_GRID: 64, 72, 96 and 112 blocks (B=2 and 3
# of 256^2, B=1 of 384^2 and 448^2; 88 is the rule's on 132 SMs)
K1_PAIRS = ((16, 1024, 2.0), (4, 1024, 2.0), (1, 1024, 2.0), (16, 256, 2.0),
            (2, 256, 2.0), (1, 384, 2.0), (3, 256, 2.0), (1, 448, 2.0))


def k1_kernel_pairs(fp, card, label, clear_plans, pairs=K1_PAIRS) -> None:
    """Each shape of ``pairs`` (B, side, sigma) through the tile kernel (the
    streamed plan refused) and the streamed one (its grid rule lifted):
    CUDA events and the profiler's device time, with the streamed plan's
    blocks and segment rows and the kernel the rule picks."""
    rng = np.random.default_rng(1)
    for b, n, sigma in pairs:
        o, x = n // 2, _u8(rng, (b, n, n, 3))
        rule = fp._Plan(b, n, n, 3, o, o, sigma, True, "cuda").stream
        for kind, attr, value in (("tile", "_stream_plan", lambda *a: None),
                                  ("streamed", "MIN_GRID", 0)):
            saved = getattr(fp, attr)
            setattr(fp, attr, value)
            clear_plans()
            st = fp._Plan(b, n, n, 3, o, o, sigma, True, "cuda").stream
            grid = "" if st is None else \
                f" ({st.blocks} blocks, segments of {st.seg} rows)"
            fn = lambda x=x, o=o, sigma=sigma: \
                fp.fused_resize_blur_oklab(x, o, o, sigma)  # noqa: E731
            print(f"[{card}] {label} K1 {kind} B={b} {n}^2->{o}^2 "
                  f"sigma={sigma:g} Oklab{grid}, the rule's "
                  f"{'tile' if rule is None else 'streamed'}: "
                  f"{_time_ms(fn, 50):.4f} ms (events), "
                  f"{_device_ms(fn, K1_NAMES):.4f} ms (profiler, device)",
                  flush=True)
            setattr(fp, attr, saved)
            clear_plans()
        del x


def kernel_times(tree) -> int:
    """``--times [TREE]``: every kernel alone, on the package found first
    on ``TREE`` (another checkout, e.g. a ``git archive`` of the parent
    commit) or this one: CUDA events, the profiler's device time and the
    host time a call at the main-path shapes (K1 at B 16, 4 and 1 and its
    plain resize, K2 at three filters and ``pipeline.filter_chain`` at B=1,
    K4 with its library call, K3 at B 4 and 16), K3's
    transcendental costs from chains of growing length with the bound
    they give, and, where the package has tile lists, each tile alone."""
    if tree:
        # this tree's package came in with the bounds: TREE's replaces it
        sys.path.insert(0, tree)
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "zignal_tpu_torch"]:
            del sys.modules[name]
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import _build
    from zignal_tpu_torch.ops import color_chain as cc
    from zignal_tpu_torch.ops import filter_chain as fc
    from zignal_tpu_torch.ops import fused_pipeline as fp
    from zignal_tpu_torch.ops import separable_conv as sc
    from zignal_tpu_torch.ops.convolution import _div_clamp_u8, \
        convolve_separable
    from zignal_tpu_torch.ops.tables import gaussian_kernel

    def clear_plans(mod):  # an older tree keeps them in the module
        plans = getattr(_build, "PLANS", None)
        (mod._TABLES if plans is None else plans).clear()

    card = _card()
    label = tree or "this tree"
    rng = np.random.default_rng(0)
    n, o = MAIN["size"], MAIN["out"]
    cases = []
    rgb = {b: _u8(rng, (b, n, n, 3)) for b in BATCHES}
    for b in BATCHES:
        cases.append((f"K1 B={b} {n}^2->{o}^2 sigma=2 Oklab", K1_NAMES,
                      lambda x=rgb[b]: fp.fused_resize_blur_oklab(x, o, o,
                                                                  2.0)))
    x16 = rgb[FILTER_BATCH]
    cases.append((f"K1 resize B={FILTER_BATCH} {n}^2->{o}^2 sigma=0 u8",
                   K1_NAMES, lambda: fp.fused_resize_blur_oklab(
                       x16, o, o, 0.0, oklab=False)))
    for b in COLOR_BATCHES:
        cases.append((f"K3 B={b} {n}^2 bench chain", K3_NAMES,
                      lambda x=rgb[b]: cc.fused_color_chain_u8(
                          x, BENCH_CHAIN)))
    pb = torch.from_numpy(rng.uniform(0, 2, 1 << 20).astype(np.float32)) \
        .cuda()
    cases.append(("K3p 1M values in [0, 2]", "probe_kernel",
                  lambda: cc.transcendentals_probe(pb)))
    k2_names, k4_names = "filter_kernel", ("separable_kernel", "conv_kernel")
    for b in (FILTER_BATCH, 1):
        p = _u8(rng, (b, n, n))
        for sigma, r in ((2.0, 2), (1.0, 1), (1.5, 3)):
            cases.append((f"K2 B={b} {n}^2 gray sigma={sigma:g} r={r}",
                          k2_names, lambda p=p, sigma=sigma, r=r:
                          fc.fused_blur_sharpen_morph(p, sigma, r)))
    cases.append((f"pipeline.filter_chain B=1 {n}^2 gray", k2_names,
                  lambda p=p: pipeline.filter_chain(p)))
    x = _u8(rng, (FILTER_BATCH, n, n, 3))
    for sigma in (2.0, 1.0):
        k = gaussian_kernel(sigma)
        cases.append((f"K4 B={FILTER_BATCH} {n}^2 RGB sigma={sigma}",
                      k4_names, lambda k=k: convolve_separable(x, k, k)))
    g = _u8(rng, (1, n, n, 1))
    kp = gaussian_kernel(1.6)
    cases.append((f"K4 pyramid blur, one {n}^2 gray plane, sigma=1.6",
                   k4_names, lambda: convolve_separable(g, kp, kp)))
    for name, kernels, fn in cases:
        print(f"[{card}] {label} {name}: {_time_ms(fn, 50):.4f} ms (events),"
              f" {_device_ms(fn, kernels):.4f} ms (profiler, device), "
              f"{_host_us(fn):.1f} us host a call", flush=True)
    if hasattr(fp, "_stream_plan"):
        k1_kernel_pairs(fp, card, label, lambda: clear_plans(fp))
    for sigma in (2.0, 1.0):
        k = gaussian_kernel(sigma)
        lib, lib_out = _library_conv(x, k)
        equal = torch.equal(_div_clamp_u8(lib_out, 65536),
                            convolve_separable(x, k, k))
        print(f"[{card}] {label} library call (depthwise F.conv2d, two 1-D "
              f"f32 calls) B={FILTER_BATCH} RGB sigma={sigma}: "
              f"{_time_ms(lib, 20):.4f} ms, array_equal={equal}", flush=True)
    _k3_slope(rgb[4], f"[{card}] {label}")
    if hasattr(fc, "TilePlan"):
        p16 = _u8(rng, (FILTER_BATCH, n, n))
        k2 = gaussian_kernel(2.0)
        for mod, attr, fn, kernels in (
                (fp, "TILES", lambda: fp.fused_resize_blur_oklab(
                    x16, o, o, 2.0), K1_NAMES),
                (fc, "TILES", lambda: fc.fused_blur_sharpen_morph(p16),
                 k2_names),
                (sc, "CONV_TILES", lambda: convolve_separable(x, k2, k2),
                 k4_names)):
            tiles = getattr(mod, attr)
            stream_plan = getattr(mod, "_stream_plan", None)
            if stream_plan is not None:  # K2's tiles: the tile kernel
                mod._stream_plan = lambda *a: None
            for tile in tiles[:8] if mod is fp else tiles[:5]:
                setattr(mod, attr, (tile,))
                clear_plans(mod)
                print(f"[{card}] {label} {mod.__name__.rsplit('.', 1)[1]} "
                      f"B={FILTER_BATCH} tile {tile} alone: "
                      f"{_device_ms(fn, kernels):.4f} ms (profiler, device)",
                      flush=True)
            setattr(mod, attr, tiles)
            if stream_plan is not None:
                mod._stream_plan = stream_plan
            clear_plans(mod)
    return 0


def transcendental_rates() -> int:
    """``--ops``: what cbrtf and powf cost with every SM issuing
    independent calls back to back (csrc/measure/transcendental_rate.cu),
    in f32 ops at the peak rate, the basis of CBRTF_OPS and POWF_OPS."""
    import ctypes
    import os

    from zignal_tpu_torch.ops import _build

    src = _build._PKG / "csrc" / "measure" / "transcendental_rate.cu"
    out_dir = _build._BUILD_DIR / "measure"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"librate.{os.getpid()}.so"
    _build._run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(path),
                 str(src)])
    lib = ctypes.CDLL(str(path))
    path.unlink()
    lib.zt_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.zt_rate.restype = ctypes.c_int
    lib.zt_rate_calls.argtypes = [ctypes.c_int]
    lib.zt_rate_calls.restype = ctypes.c_longlong
    blocks = 32 * torch.cuda.get_device_properties(0).multi_processor_count
    calls = lib.zt_rate_calls(blocks)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.25, 0.75, 4096).astype(np.float32)).cuda()
    y = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(f, e):
        err = lib.zt_rate(f, x.data_ptr(), y.data_ptr(), e, blocks, stream)
        if err:
            raise RuntimeError(f"zt_rate({f}) failed: {err}")

    card = _card()
    forms = (("the loop alone", 0, 0.0), ("cbrtf", 1, 0.0),
             ("powf(x, 1/2.4)", 2, 1 / 2.4),
             ("sign(x) * powf(|x|, 1/3)", 3, 1 / 3))
    ms = {name: min(_time_ms(lambda: run(f, e), 5) for _ in range(3))
          for name, f, e in forms}
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("the rate kernels gave non-finite values")
    base = ms["the loop alone"]
    print(f"[{card}] {calls} calls a launch, {blocks} blocks of 256; the loop "
          f"alone {base:.4f} ms (events)")
    for name, _, _ in forms[1:]:
        ops = (ms[name] - base) * 1e-3 * F32_OPS_S / calls
        print(f"[{card}] {name}: {ms[name]:.4f} ms, "
              f"{(ms[name] - base) * 1e9 / calls:.5f} ps a call, "
              f"{ops:.1f} f32 ops a call at {F32_OPS_S:.3g} ops/s", flush=True)
    return 0


LANE = dict(batch=8, rows=376, cols=1241, sigma=1.4, low=50.0, high=150.0,
            size=1024, threshold=100, angle=5.0, radius=10.0, lines=32,
            seed=2 ** 33 + 26)


def _lane_request(x, hough):
    """The lane_hough cell's request: Canny, then the Hough lines."""
    from zignal_tpu_torch.ops import edges

    e = edges.canny(x.to(torch.float32), LANE["sigma"], LANE["low"],
                    LANE["high"])
    return (e,) + hough.lines_batch(e, LANE["threshold"], LANE["angle"],
                                    LANE["radius"], LANE["lines"])


def _lane_stages(x, hough):
    """The request's stages on the card's kernels one after another:
    (name, fn of the previous output), as ``_stage_ms`` times them."""
    from zignal_tpu_torch.ops import canny_front, hough_kernels
    from zignal_tpu_torch.ops.hough import _device_tables, _tables
    from zignal_tpu_torch.ops.hysteresis import hysteresis_u8

    n = LANE["size"]
    cos_j, sin_j, _ = _device_tables(n, x.device)
    _, _, offset, even = _tables(n)

    def front(_):
        return canny_front.front(x.to(torch.float32), LANE["sigma"])

    def hyst(f):
        return hysteresis_u8(f[1], f[0], LANE["low"], LANE["high"])

    def vote(e):
        return hough_kernels.vote(e, n, cos_j, sin_j, offset, even)

    def lines(acc):
        return hough_kernels.lines(acc, LANE["threshold"], LANE["angle"],
                                   LANE["radius"], LANE["lines"], even)

    return [("front", front), ("hysteresis", hyst), ("vote", vote),
            ("lines", lines)]


def _plain_stages(x, hough):
    """The same stages on the plain route, for comparison: on the card
    smooth, gradients, NMS, the hysteresis growth, resize and vote; the
    peaks and lines on the host (``find_lines``' own, which a CPU
    accumulator takes), the copy there included."""
    from zignal_tpu_torch.enums import BorderMode, Interpolation
    from zignal_tpu_torch.ops import edges
    from zignal_tpu_torch.ops.convolution import convolve_separable, \
        gradient_magnitude, sobel_gradients
    from zignal_tpu_torch.ops.hough import _vote
    from zignal_tpu_torch.ops.interpolation import resize
    from zignal_tpu_torch.ops.tables import gaussian_kernel

    k, n = gaussian_kernel(LANE["sigma"]), LANE["size"]

    def smooth(_):
        return convolve_separable(x.to(torch.float32)[..., None], k, k,
                                  BorderMode.MIRROR)[..., 0]

    def gradients(s):
        gx, gy = sobel_gradients(s, BorderMode.REPLICATE)
        return gx, gy, gradient_magnitude(gx, gy)

    def nms(g):
        return edges._quantized_nms(*g), g[2]

    def hyst(c):
        return edges._hysteresis(c[0], c[1], LANE["low"], LANE["high"]).to(
            torch.uint8) * 255

    def resized(e):
        return resize(e[..., None], n, n, Interpolation.NEAREST)[..., 0]

    def vote(p):
        return _vote(p, n)

    def peaks(acc):
        return hough.find_lines_tensors(acc.cpu(), LANE["threshold"],
                                        LANE["angle"], LANE["radius"],
                                        LANE["lines"])

    return [("smooth", smooth), ("gradients", gradients), ("nms", nms),
            ("hysteresis", hyst), ("resize", resized), ("vote", vote),
            ("peaks on the host", peaks)]


def _syncs(fn) -> list:
    """The host waits that ``fn()`` makes on the card, as torch's sync
    debug mode reports them: the innermost Python frames of each."""
    import traceback
    import warnings

    stacks = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            stacks.append(" < ".join(
                f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                for f in reversed(traceback.extract_stack()[-7:-1])))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return stacks


def _lane_outputs_equal(label, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"phase 36 {label}: output {i} differs")


def lane_phase(card) -> list:
    """Phase 36: the lane_hough cell's request (8 road frames of 1241 x
    376 from benchmarks/sources/device_road.py) on the card against the
    same calls on the CPU, bit for bit: the edges, the accumulators, the
    line rows and their validity; each kernel against its plain route
    (equal, with the plain hysteresis's convergence tests; the lines
    kernel against ``find_lines``' own on the host); the host waits of a
    request after the first (torch's sync debug mode: none); the
    request's split by CUDA events, on the kernels and on the plain route;
    and each kernel's time alone against its bound. Returns the kernels
    line's entries of the four kernels, with the launches of the first
    request, each counter set to 0 before it."""
    from benchmarks.sources import device_road
    from zignal_tpu_torch.ops import canny_front, edges, hough_kernels, \
        hysteresis
    from zignal_tpu_torch.ops.hough import HoughTransform

    shape = (LANE["batch"], LANE["rows"], LANE["cols"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LANE["seed"])
    x = device_road.frames(shape, gen, torch.device("cuda"))
    hough = HoughTransform(LANE["size"])
    # the main path's own launches: one request with the counters at 0
    counters = ((canny_front, "LAUNCHES"), (hysteresis, "LAUNCHES"),
                (hough_kernels, "VOTE_LAUNCHES"),
                (hough_kernels, "LINES_LAUNCHES"))
    for mod, name in counters:
        setattr(mod, name, 0)
    out = _lane_request(x, hough)
    torch.cuda.synchronize()
    calls = [getattr(mod, name) for mod, name in counters]
    if calls != [1, 1, 1, 1]:
        raise AssertionError(f"the request called the kernels {calls} "
                             "times, not once each")
    share = float((out[0] > 0).float().mean())
    t0 = time.perf_counter()
    cpu = _lane_request(x.cpu(), hough)
    cpu_s = time.perf_counter() - t0
    _lane_outputs_equal("card vs CPU", out, cpu)
    print(f"phase 36 lane_hough B={shape[0]} {shape[2]}x{shape[1]}: edges, "
          f"accumulators, rows and validity equal to the CPU route "
          f"({cpu_s:.1f} s there); edge share {share:.4f}, lines a frame "
          f"{out[3].sum(1).tolist()}, accumulator max "
          f"{int(out[1].max())}")
    # each kernel against its plain route on the card
    kern, plain = _lane_stages(x, hough), _plain_stages(x, hough)
    k_front = kern[0][1](None)
    s = plain[0][1](None)
    p_nms = plain[2][1](plain[1][1](s))
    _lane_outputs_equal("front vs plain", k_front, (p_nms[1], p_nms[0]))
    tests = edges.HYSTERESIS_TESTS
    p_hyst = plain[3][1](p_nms)
    tests = edges.HYSTERESIS_TESTS - tests
    k_hyst = kern[1][1](k_front)
    _lane_outputs_equal("hysteresis vs plain", (k_hyst,), (p_hyst,))
    k_acc = kern[2][1](k_hyst)
    p_acc = plain[5][1](plain[4][1](p_hyst))
    _lane_outputs_equal("vote vs plain", (k_acc,), (p_acc,))
    _lane_outputs_equal("lines vs plain", kern[3][1](k_acc),
                        plain[6][1](p_acc))
    print(f"phase 36: the front, hysteresis, vote and lines kernels equal "
          f"their plain routes on the card; the plain hysteresis took "
          f"{tests} convergence tests")
    waits = _syncs(lambda: _lane_request(x, hough))
    print(f"phase 36 host waits in a request: {len(waits)} {waits}")
    if waits:
        raise AssertionError(f"a request waited {len(waits)} times")
    _lane_request(x, hough)
    for label, stages in (("kernels", kern), ("plain", plain)):
        split = _stage_ms(stages)
        print(f"[{card}] phase 36 split on the {label} (ms): " + ", ".join(
            f"{name} {t:.4f}" for name, t in split)
            + f"; total {sum(t for _, t in split):.4f}")
    rows = []
    e = k_hyst
    resized = plain[4][1](e)
    edge_n, votes = int((resized > 0).sum()), int(k_acc.sum())
    print(f"phase 36 the request's votes: {edge_n} edge pixels at "
          f"{LANE['size']}^2, {votes} votes in range")
    for name, fn, src, bnd in (
            ("canny_front", lambda: kern[0][1](None), "canny_front.cu",
             front_bound(*shape)),
            ("hysteresis", lambda: kern[1][1](k_front), "hysteresis.cu",
             hysteresis_bound(*shape)),
            ("hough_vote", lambda: kern[2][1](e), "hough.cu",
             vote_bound(*shape, LANE["size"], edge_n, votes)),
            ("hough_lines", lambda: kern[3][1](k_acc), "hough.cu", None)):
        ms = _time_ms(fn)
        share = "" if bnd is None else (
            f" ({100 * bnd[0] / ms:.2f} % of its {bnd[1]} bound "
            f"{bnd[0]:.5f} ms)")
        print(f"[{card}] phase 36 {name}: {ms:.4f} ms{share}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"zignal_tpu_torch/csrc/{src}",
                     "replaces": None, "launches": None, "max_abs_err": 0,
                     "ms": ms, "bound_ms": None if bnd is None else bnd[0],
                     "bound_by": None if bnd is None else bnd[1]})
    for row, count in zip(rows, calls):
        row["launches"] = count
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--lane" in sys.argv[1:]:
        print(json.dumps({"kernels": lane_phase(_card())}))
        return 0
    if "--orb" in sys.argv[1:]:
        print(json.dumps({"kernels": _orb_phases(_card())}))
        return 0
    if "--profile" in sys.argv[1:]:
        return calls_profile()
    if "--ops" in sys.argv[1:]:
        return transcendental_rates()
    if "--trace" in sys.argv[1:]:
        return trace_calls(sys.argv[sys.argv.index("--trace") + 1])
    if "--times" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--times") + 1:]
        return kernel_times(rest[0] if rest else None)
    from zignal_tpu_torch import ImageBatch, native
    from zignal_tpu_torch.ops import _build, fused_pipeline as fp

    # 1. device facts and the build
    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(card)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    if native.get_lib() is None:
        raise AssertionError("the host codec library did not build (g++)")
    print(f"codec library build: {native.BUILD_SECONDS:.1f} s "
          f"({native.get_lib()._name})")
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

    _k1_edges(rng)

    # 3. the main path through the user's entry points
    n, o, sigma = MAIN["size"], MAIN["out"], MAIN["sigma"]
    batches = {b: rng.integers(0, 256, (b, n, n, 3), np.uint8)
               for b in BATCHES}
    fp.LAUNCHES = fp.STREAMED = 0
    outs = {}
    for b in BATCHES:
        # the streamed kernel takes each resize_blur_oklab (its plan takes
        # every B of the shape), never the plain resize (sigma 0)
        for _ in range(3):
            before, streamed = fp.LAUNCHES, fp.STREAMED
            ib = ImageBatch(batches[b], device="cuda")
            lab = ib.resize_blur_oklab((o, o), sigma=sigma)
            if (fp.LAUNCHES - before, fp.STREAMED - streamed) != (1, 1):
                raise AssertionError(f"resize_blur_oklab B={b} launched K1 "
                                     f"{fp.LAUNCHES - before}, streamed "
                                     f"{fp.STREAMED - streamed}")
            small = ib.resize((o, o))
            if (fp.LAUNCHES - before, fp.STREAMED - streamed) != (2, 1):
                raise AssertionError("the plain resize did not launch the "
                                     "tile kernel once")
        outs[b] = (ib, lab, small)
    torch.cuda.synchronize()
    launches, streamed = fp.LAUNCHES, fp.STREAMED
    print(f"main path: {launches} kernel launches over "
          f"{3 * len(BATCHES)} resize_blur_oklab + resize calls, "
          f"{streamed} streamed")
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
    worst = max(worst, _fault_cases(rng))
    _k1_streamed_vs_tile(outs[16][0].device_array())

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

    k1 = {
        "name": "fused_resize_blur_oklab",
        "route": "cuda",
        "source": "zignal_tpu_torch/csrc/fused_resize_blur_oklab.cu",
        "replaces": "zignal_tpu/ops/pallas_pipeline.py:322",
        "launches": launches,
        "streamed": streamed,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": None,  # F.interpolate's taps are float, not 8.8
    }
    k2, k4 = _filter_phases(card, rng)
    k3, k3p, eqk, (k1_ex, k4_ex) = _color_phases(card, rng)
    k1["bound_ms"], k1["bound_by"] = k1_bound(16, n, o)
    k1_s4, k4_s4 = _slice4_phases(card, rng)
    k1_s7, k4_s7, corpus, config1 = _file_phases(card, rng)
    t0 = time.perf_counter()
    k4_s8 = _geometry_phases(card, rng)
    print(f"phases 20-22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (k1_s9, k4_s9), orb_kernels = _config_phases(card)
    print(f"phases 23-25: {time.perf_counter() - t0:.1f} s")
    k1_s10 = _slice10_phases(card)
    k1_s11, k4_s11 = _cli_phases(card, corpus, config1)
    k1_s12, k4_s12 = _mesh_phases(card)
    k1_s13, k2_s13 = _profiling_phases(card, corpus)
    s14 = _bench_phases(card)
    k1["launches"] += k1_ex + k1_s4 + k1_s7 + k1_s9 + k1_s10 + k1_s11 + \
        k1_s12 + k1_s13 + s14["K1"]
    k1["streamed"] += sum(K1_STREAMED.values())
    print(f"K1 streamed launches by phase: phase 3 {streamed}, "
          f"{K1_STREAMED}")
    k2["launches"] += k2_s13 + s14["K2"]
    k3["launches"] += s14["K3"]
    k3p["launches"] += s14["K3p"]
    k4["launches"] += k4_ex + k4_s4 + k4_s7 + k4_s8 + k4_s9 + k4_s11 + \
        k4_s12 + s14["K4"]
    lane = lane_phase(card)
    print(json.dumps({"kernels": [k1, k2, k3, k3p, k4, eqk] + orb_kernels
                      + lane}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
