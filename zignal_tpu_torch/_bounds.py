"""The least time an H100 could take for each kernel's work: the larger of
the bytes the function must move over the card's memory rate and its
operations over its f32 rate. ``chip_smoke.py`` (the ``bound_ms`` of its
kernels line) and ``python -m zignal_tpu_torch.bench`` (each config's
share of its kernel's bound) both count with these functions.

Each ``k*_bound`` returns ``(ms, "bytes" or "operations")``.
"""

from __future__ import annotations

import torch

# the card's published peaks (NVIDIA's H100 SXM data sheet, 700 W): HBM
# bytes/s and f32 multiply-adds/s (67 TFLOP/s, 2 FLOP each); the bounds
# count every multiply-add at this rate, the fastest exact one
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# a transcendental's cost in those f32 ops: its time a call with every SM
# issuing independent calls back to back, times F32_OPS_S
# (csrc/measure/transcendental_rate.cu, run by chip_smoke.py --ops; NVIDIA
# H100 80GB HBM3, 700.00 W: 0.75207 and 2.47323 ps a call): cbrtf, the
# cube root of K1 and K3 (1 ulp; about 3 MUFU at 16 a clock an SM), and
# IEEE powf with a runtime exponent, K3's output gamma curve
CBRTF_OPS = 50.4
POWF_OPS = 165.7


def bound(nbytes: float, ops: float):
    """(ms, resource): the larger of the HBM time and the op time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(b: int, n: int, o: int):
    """K1 on ``b`` images of n^2 RGB to o^2: u8 in, f32 Oklab out; per
    output value 4 resize and 26 blur multiply-adds (2 ops each); per pixel
    the Oklab epilogue's 3 cube roots (cbrtf, CBRTF_OPS each) and its two
    3x3 mixes (36 ops); its sRGB -> linear step is a table read."""
    values = b * o * o * 3
    return bound(b * n * n * 3 + 4 * values, values * 2 * 30
                 + b * o * o * (3 * CBRTF_OPS + 36))


def k2_bound(b: int, n: int):
    """K2 on ``b`` n^2 planes: u8 in and out; per pixel 26 blur
    multiply-adds (2 ops each) and 19 other ops (running box sums 4,
    sharpen 6, threshold 1, the separable dilate and erode 8)."""
    return bound(2 * b * n * n, b * n * n * (2 * 26 + 19))


def k3_bound(x):
    """K3 on the bench chain over the u8 batch ``x``: 6 bytes a pixel, and
    a pixel's work counted from the chain's steps in
    csrc/fused_color_chain_u8.cu (the input gamma is a table read): 238
    f32 ops of mixes, scalings, compares, clips and the quantization, 6
    cube roots (Oklab's and XYB's, on every pixel), and where this data
    needs them Lab's 3 (X/Xn, Y/Yn, Z/Zn above Lab's epsilon) and the 3
    output gamma curves (a channel above the linear segment: the chain
    returns every byte to itself). A root at CBRTF_OPS, a curve at
    POWF_OPS, the cheapest exact-enough forms, which the kernel uses."""
    from .color._array import convert_array
    from .color._scalar import D65_X, D65_Y, D65_Z, LAB_EPSILON, \
        SRGB_LINEAR_THRESHOLD
    from .ops.tables import gamma_table

    px = x.numel() // 3
    xyz = convert_array(x.to(torch.float32) / 255.0, "rgb", "xyz")
    d65 = torch.tensor([D65_X, D65_Y, D65_Z], device=x.device)
    lab_roots = int((xyz / d65 > LAB_EPSILON).sum())
    curves = int((gamma_table(x.device)[x.long()]
                  > SRGB_LINEAR_THRESHOLD).sum())
    return bound(6 * px, px * (238 + 6 * CBRTF_OPS) + lab_roots * CBRTF_OPS
                 + curves * POWF_OPS)


def k3p_bound(values: int):
    """K3p on values uniform in [0, 2]: f32 in and out; a value takes one
    powf (POWF_OPS), a cube root (CBRTF_OPS; the three quarters above
    0.5) or a cube (2 ops), a compare and an add."""
    return bound(8 * values, values * (POWF_OPS + 0.75 * CBRTF_OPS
                                       + 0.25 * 2 + 2))


def k4_bound(x, k):
    """K4: u8 in and out; 2 * len(k) multiply-adds (2 ops each) a value."""
    return bound(2 * x.numel(), x.numel() * 2 * 2 * len(k))


def hist_bound(values: int):
    """The equalize histogram over ``values`` u8 values: each read once,
    a byte extracted and counted (2 ops); the counts are 1 KB an image
    and channel."""
    return bound(values, 2 * values)


def lut_bound(values: int):
    """The equalize lookup over ``values`` u8 values: each read and
    written once, a byte extracted, looked up and placed (3 ops). The
    tables between the two passes read 1 KB of counts an image and
    channel and are not counted."""
    return bound(2 * values, 3 * values)


def detect_bound(b: int, h: int, w: int, n: int):
    """ORB's detect kernel on ``b`` atlases of h x w u8 that hold ``n``
    level pixels each: the atlas read and the f32 candidates written;
    per level pixel FAST's 48 ops (16 compares each way and the arc test,
    as benchmarks/roofline_features.py counts them), Harris's 25 and the
    NMS's 18 (its disc's maxima as three running row maxima, then a
    column of 9)."""
    return bound(b * h * w + 4 * b * n, b * n * (48 + 25 + 18))


# a keypoint's orientation patch: the values of the radius-15 circle, each
# added to the mass and, times its x and its y, to the two moments (5
# ops); its descriptor: 256 pairs of two rotated samples, each two
# coordinates of two multiply-adds, and a compare (17 ops), as
# benchmarks/roofline_features.py counts them
PATCH_VALUES = sum(1 for y in range(-15, 16) for x in range(-15, 16)
                   if x * x + y * y <= 15 * 15)
DESCRIBE_OPS = PATCH_VALUES * 5 + 256 * 17


def describe_bound(b: int, k: int):
    """ORB's describe kernel on ``b`` planes of ``k`` keypoints: each
    keypoint's response (4 B) and index (8 B) read, its row (20 B),
    descriptor (32 B) and validity (1 B) written, the 32-B row table read
    once; ``DESCRIBE_OPS`` a keypoint. Its windows of the atlas are left
    in L2 by the detect stage and not counted."""
    return bound(b * k * (4 + 8 + 20 + 32 + 1) + 32 * k, b * k * DESCRIBE_OPS)


def hysteresis_bound(b: int, h: int, w: int):
    """Canny's hysteresis kernel on ``b`` planes of h x w: the u8
    candidates and the f32 magnitude read once and the u8 edges written
    once; per pixel its two threshold compares and the 8-neighbour test of
    one growth step (9 ops)."""
    n = b * h * w
    return bound(n * (1 + 4 + 1), n * (2 + 9))


def front_bound(b: int, h: int, w: int):
    """Canny's front kernel on ``b`` planes of h x w: the f32 plane read
    once, the f32 magnitude and the u8 mask written once; per pixel the
    blur's 2 x 11 multiply-adds (2 ops each), Sobel's 12, the magnitude's
    4 and the NMS's 12."""
    n = b * h * w
    return bound(n * (4 + 4 + 1), n * (44 + 12 + 4 + 12))


def vote_bound(b: int, h: int, w: int, size: int, edges: int, votes: int):
    """The Hough votes of ``b`` u8 edge frames of h x w into size x size
    int32 accumulators, of a request whose resized planes held ``edges``
    edge pixels that cast ``votes`` votes in range (the accumulators'
    sum): the frames read once, each edge's 4-B entry written and read
    once, each bin written once; per vote its two products and their sum,
    the bin's two shifts and add, and the count's add (7 ops). The votes
    depend on the frames, so the bound is read from the request's own."""
    return bound(b * h * w + 8 * edges + 4 * b * size * size, 7 * votes)
