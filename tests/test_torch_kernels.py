"""The CUDA kernels against their plain PyTorch versions on the card. A
CUDA kernel has no CPU mode, so every test here needs a device and skips
without one, but the pins of what each wrapper hands its kernel
(``test_wrapper_params_and_plans_are_pinned``), which run on the host. On
a GPU machine (no jax needed):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

from zignal_tpu_torch import BorderMode, Gray, ImageBatch, pipeline
from zignal_tpu_torch.color import convert_chain
from zignal_tpu_torch.ops import _build
from zignal_tpu_torch.ops import binary as eb
from zignal_tpu_torch.ops import color_chain as cc
from zignal_tpu_torch.ops import enhancement as en
from zignal_tpu_torch.ops import filter_chain as fc
from zignal_tpu_torch.ops import fused_pipeline as fp
from zignal_tpu_torch.ops import orb_describe as odesc
from zignal_tpu_torch.ops import orb_detect as od
from zignal_tpu_torch.ops import separable_conv as sc
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.convolution import convolve_separable, \
    convolve_separable_reference
from zignal_tpu_torch.features import Orb
from zignal_tpu_torch.ops.interpolation import resize

import _orb_atlas_cases as oc

pytestmark = pytest.mark.cuda

OKLAB_TOL = 5e-6

CASES = [  # (shape, out_rows, out_cols, sigma): test_pallas_pipeline's
    ((2, 256, 256, 3), 128, 128, 2.0),
    ((1, 384, 512, 3), 192, 256, 2.0),
    ((1, 500, 400, 3), 128, 128, 2.0),
    ((1, 192, 256, 3), 128, 128, 0.5),
    ((1, 192, 256, 3), 128, 128, 1.0),
    ((1, 192, 256, 3), 128, 128, 3.5),
    ((1, 1080, 960, 3), 360, 640, 1.5),
    ((1, 300, 512, 3), 150, 300, 1.5),
    ((2, 256, 256, 4), 100, 100, 1.5),
    ((2, 256, 256, 1), 100, 190, 1.5),
    ((1, 256, 256, 3), 320, 288, 1.5),
    ((2, 300, 400, 3), 128, 128, 0.0),
    ((1, 37, 53, 3), 100, 9, 3.5),
    ((2, 1, 64, 3), 3, 32, 1.0),
    ((2, 64, 1, 4), 31, 1, 2.0),
    ((1, 64, 64, 3), 40, 40, 30.0),   # radius 90: > 48 KB shared memory
    ((1, 64, 64, 4), 40, 40, 30.0),   # radius 90, RGBA: a 16-px tile
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _u8(shape, seed, device):
    x = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("shape,oh,ow,sigma", CASES)
def test_kernel_u8_equals_plain(cuda, shape, oh, ow, sigma):
    x = _u8(shape, 0, cuda)
    before = fp.LAUNCHES
    got = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab=False)
    want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma,
                                                oklab=False)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,oh,ow,sigma",
                         [c for c in CASES if c[0][-1] == 3])
def test_kernel_oklab_within_bound_of_plain(cuda, shape, oh, ow, sigma):
    x = _u8(shape, 1, cuda)
    got = fp.fused_resize_blur_oklab(x, oh, ow, sigma)
    want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= OKLAB_TOL


def test_image_batch_main_path_launches_the_kernel(cuda):
    x = _u8((2, 256, 256, 3), 2, cuda)
    ib = ImageBatch(x, device=cuda)
    before = fp.LAUNCHES
    lab = ib.resize_blur_oklab((128, 128), 2.0)
    small = ib.resize((128, 128))
    assert fp.LAUNCHES == before + 2
    want = fp.fused_resize_blur_oklab_reference(x, 128, 128, 2.0)
    assert float((lab - want).abs().max()) <= OKLAB_TOL
    assert torch.equal(small.device_array(),
                       fp.fused_resize_blur_oklab_reference(
                           x, 128, 128, 0.0, oklab=False))


def test_resize_of_one_image_on_the_card(cuda):
    x = _u8((1, 70, 90, 4), 3, cuda)
    assert torch.equal(resize(x[0], 33, 47), resize(x.cpu(), 33, 47)[0].to(cuda))


# K1's tile plans at their edges: outputs just below, at and above the tile
# sides (8-64) and one past 128, from a 2:1 source and from an upscale
K1_EDGE_OUT = [(1, 130), (7, 9), (15, 17), (31, 33), (33, 47), (48, 49),
               (63, 65), (64, 1), (127, 129)]


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("sigma", [0.0, 1.0, 1.5, 2.0, 3.5])
def test_kernel_at_tile_edges_equals_plain(cuda, channels, sigma):
    for i, (oh, ow) in enumerate(K1_EDGE_OUT):
        for b in (1, 16):
            for h, w in ((2 * oh + 1, 2 * ow + 3), (oh // 2 + 1, ow // 3 + 2)):
                x = _u8((b, h, w, channels), 30 + i, cuda)
                before = fp.LAUNCHES
                got = fp.fused_resize_blur_oklab(x, oh, ow, sigma,
                                                 oklab=False)
                want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma,
                                                            oklab=False)
                # C = 5 runs in two channel groups, one launch each
                assert fp.LAUNCHES == before + (2 if channels == 5 else 1)
                assert torch.equal(got, want), (b, h, w, oh, ow)
                if channels == 3:
                    lab = fp.fused_resize_blur_oklab(x, oh, ow, sigma)
                    ref = fp.fused_resize_blur_oklab_reference(x, oh, ow,
                                                               sigma)
                    assert float((lab - ref).abs().max()) <= OKLAB_TOL


@pytest.mark.parametrize("tile", fp.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_kernel_every_tile_equals_plain(cuda, tile, monkeypatch):
    monkeypatch.setattr(fp, "TILES", (tile,))
    monkeypatch.setattr(_build, "PLANS", {})
    for shape, oh, ow, sigma in (((3, 200, 300, 3), 100, 150, 2.0),
                                 ((2, 130, 70, 1), 65, 35, 1.0),
                                 ((1, 90, 250, 4), 180, 125, 3.5),
                                 ((2, 57, 33, 3), 57, 66, 1.5),
                                 ((2, 57, 33, 5), 20, 40, 0.0)):
        x = _u8(shape, 27, cuda)
        got = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab=False)
        assert torch.equal(got, fp.fused_resize_blur_oklab_reference(
            x, oh, ow, sigma, oklab=False)), (shape, sigma)
        if shape[-1] == 3:
            lab = fp.fused_resize_blur_oklab(x, oh, ow, sigma)
            ref = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma)
            assert float((lab - ref).abs().max()) <= OKLAB_TOL


def test_kernel_unaligned_batch_and_gathered_plan_equal_plain(cuda):
    base = _u8((2 * 64 * 80 * 3 + 5,), 28, cuda)
    x = base[5:].view(2, 64, 80, 3)   # rows not 16-byte aligned
    for sigma in (0.0, 2.0):
        assert torch.equal(
            fp.fused_resize_blur_oklab(x, 33, 41, sigma, oklab=False),
            fp.fused_resize_blur_oklab_reference(x, 33, 41, sigma,
                                                 oklab=False))
    # a 40:1 downscale: a tile's source span does not fit a block
    y = _u8((1, 1600, 2000, 3), 29, cuda)
    b, h, w, c = y.shape
    r = tables.blur_radius(2.0)
    plan, _, _ = fp.tile_plan(b, 40, 50, r, c, True,
                              tables.halo_axis_table(h, 40, r),
                              tables.halo_axis_table(w, 50, r), 132)
    assert not plan.staged
    assert torch.equal(
        fp.fused_resize_blur_oklab(y, 40, 50, 2.0, oklab=False),
        fp.fused_resize_blur_oklab_reference(y, 40, 50, 2.0, oklab=False))
    lab = fp.fused_resize_blur_oklab(y, 40, 50, 2.0)
    ref = fp.fused_resize_blur_oklab_reference(y, 40, 50, 2.0)
    assert float((lab - ref).abs().max()) <= OKLAB_TOL


@pytest.mark.parametrize("channels", [2, 5, 8])
def test_resize_of_any_channel_count_launches_the_kernel(cuda, channels):
    """F2: a u8 bilinear resize of C not in {1, 3, 4} runs K1 in channel
    groups on the card."""
    x = _u8((2, 17, 19, channels), 31, cuda)
    before = fp.LAUNCHES
    got = resize(x, 9, 11)
    blurred = fp.fused_resize_blur_oklab(x, 30, 37, 1.5, oklab=False)
    # one launch a group of at most 4 channels, for each of the two calls
    assert fp.LAUNCHES == before + 2 * -(-channels // 4)
    assert torch.equal(got.cpu(), resize(x.cpu(), 9, 11))
    assert torch.equal(blurred, fp.fused_resize_blur_oklab_reference(
        x, 30, 37, 1.5, oklab=False))


def test_pipelines_take_strided_input(cuda):
    """F1: the public pipelines hand the kernels contiguous tensors."""
    x = _u8((2, 48, 40, 3), 32, cuda)
    k1, k2 = fp.LAUNCHES, fc.LAUNCHES
    mask = pipeline.filter_chain(x[..., 0])
    lab = pipeline.resize_blur_oklab(x[:, ::2], 5, 6, 1.0)
    assert (fp.LAUNCHES, fc.LAUNCHES) == (k1 + 1, k2 + 1)
    assert torch.equal(mask, fc.fused_blur_sharpen_morph_reference(
        x[..., 0].contiguous()))
    want = fp.fused_resize_blur_oklab_reference(x[:, ::2].contiguous(), 5, 6,
                                                1.0)
    assert float((lab - want).abs().max()) <= OKLAB_TOL


def test_kernel_rejects_non_contiguous(cuda):
    x = _u8((1, 64, 64, 3), 4, cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fp.fused_resize_blur_oklab(x, 16, 16, 1.0)


def _k1_both(x, oh, ow, sigma, oklab, monkeypatch):
    """K1's output on ``x`` from the streamed kernel (the plan's, which
    must stream) and from the tile kernel (the streamed plan refused),
    each one launch."""
    monkeypatch.setattr(_build, "PLANS", {})
    launches, streamed = fp.LAUNCHES, fp.STREAMED
    got = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab)
    assert (fp.LAUNCHES, fp.STREAMED) == (launches + 1, streamed + 1)
    with monkeypatch.context() as m:
        m.setattr(_build, "PLANS", {})
        m.setattr(fp, "_stream_plan", lambda *a: None)  # the tiles
        tile = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab)
    assert (fp.LAUNCHES, fp.STREAMED) == (launches + 2, streamed + 1)
    return got, tile


# the streamed kernel at the north star's shape and around it: sigma 1 and
# 1.5, output widths that are not a multiple of the 64-column strip (500,
# 513) with a ragged last segment, B=3, rows that are not 16-byte aligned
STREAM_K1_CASES = [  # (shape, out_rows, out_cols, sigma)
    ((16, 1024, 1024, 3), 512, 512, 2.0),
    ((16, 1024, 1024, 3), 512, 512, 1.0),
    ((16, 1024, 1024, 3), 512, 512, 1.5),
    ((8, 1000, 1000, 3), 500, 500, 2.0),
    ((8, 1026, 1026, 3), 513, 513, 2.0),
    ((3, 600, 800, 3), 300, 400, 1.5),
    ((16, 400, 402, 3), 200, 201, 2.0),
]


@pytest.mark.parametrize("shape,oh,ow,sigma", STREAM_K1_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_streamed_k1_equals_the_tile_kernel(cuda, shape, oh, ow, sigma,
                                            monkeypatch):
    """Bitwise the tile kernel's output, u8 and Oklab f32, and the plain
    version's u8."""
    x = _u8(shape, 33, cuda)
    got, tile = _k1_both(x, oh, ow, sigma, False, monkeypatch)
    assert torch.equal(got, tile)
    assert torch.equal(got, fp.fused_resize_blur_oklab_reference(
        x, oh, ow, sigma, oklab=False))
    lab, lab_tile = _k1_both(x, oh, ow, sigma, True, monkeypatch)
    assert torch.equal(lab, lab_tile)
    ref = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma)
    assert float((lab - ref).abs().max()) <= OKLAB_TOL


def test_streamed_k1_takes_strided_input_b1_and_a_small_grid(cuda,
                                                            monkeypatch):
    """pipeline.resize_blur_oklab on x[:, ::2] (its contiguous copy's rows
    are not 16-byte aligned: the stages gather), B=1 of 1024^2 (8-row
    segments) and B=2 of 256^2 streamed with the grid rule lifted: equal
    to the tile kernel."""
    x = _u8((16, 800, 408, 3), 34, cuda)
    monkeypatch.setattr(_build, "PLANS", {})
    streamed = fp.STREAMED
    lab = pipeline.resize_blur_oklab(x[:, ::2], 200, 204, 2.0)
    assert fp.STREAMED == streamed + 1
    monkeypatch.setattr(_build, "PLANS", {})
    monkeypatch.setattr(fp, "_stream_plan", lambda *a: None)
    assert torch.equal(lab, pipeline.resize_blur_oklab(x[:, ::2], 200, 204,
                                                       2.0))
    monkeypatch.undo()
    y = _u8((1, 1024, 1024, 3), 35, cuda)
    for oklab in (False, True):
        got, tile = _k1_both(y, 512, 512, 2.0, oklab, monkeypatch)
        assert torch.equal(got, tile)
    monkeypatch.setattr(fp, "MIN_GRID", 0)
    z = _u8((2, 256, 256, 3), 37, cuda)
    for oklab in (False, True):
        got, tile = _k1_both(z, 128, 128, 2.0, oklab, monkeypatch)
        assert torch.equal(got, tile)


def test_small_grids_and_sigma0_keep_the_tile_kernel(cuda, monkeypatch):
    """B=2 of 256^2 -> 128^2 (a streamed grid of 64 blocks) and the plain
    resize take the tile kernel; B=1 and B=16 of 1024^2 -> 512^2 stream,
    once a call."""
    monkeypatch.setattr(_build, "PLANS", {})
    x = _u8((16, 1024, 1024, 3), 36, cuda)
    launches, streamed = fp.LAUNCHES, fp.STREAMED
    fp.fused_resize_blur_oklab(x[:2, ::4, ::4].contiguous(), 128, 128, 2.0)
    small = ImageBatch(x, device=cuda).resize((512, 512))
    assert (fp.LAUNCHES, fp.STREAMED) == (launches + 2, streamed)
    one = fp.fused_resize_blur_oklab(x[:1], 512, 512, 2.0)
    lab = ImageBatch(x, device=cuda).resize_blur_oklab((512, 512), 2.0)
    assert (fp.LAUNCHES, fp.STREAMED) == (launches + 4, streamed + 2)
    assert torch.equal(lab[:1], one)
    assert torch.equal(small.device_array(),
                       fp.fused_resize_blur_oklab_reference(
                           x, 512, 512, 0.0, oklab=False))


FILTER_CASES = [  # (shape, sigma, sharpen_radius, thr): test_pallas_filter's
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
    ((100, 130), 2.0, 2, 127.5),
    ((100, 130), 2.0, 2, -1.0),
    ((100, 130), 2.0, 2, 300.0),
    ((100, 130), 0.0, 0, 128.0),
    ((64, 64), 30.0, 2, 128.0),      # blur radius 90: > 48 KB shared memory
    ((70, 90), 2.0, 60, 128.0),      # sharpen radius 60
]

SIGNED = (-0.25, 0.5, 1.5, 0.5, -0.25)
CONV_CASES = [  # (shape, kernel, border)
    *[((2, 40, 56, 3), tables.gaussian_kernel(s), b)
      for s in (1.0, 2.0) for b in BorderMode],
    ((2, 40, 56, 3), SIGNED, BorderMode.ZERO),
    ((2, 40, 56, 3), SIGNED, BorderMode.REPLICATE),
    ((2, 40, 56, 1), tables.gaussian_kernel(2.0), BorderMode.WRAP),
    ((2, 40, 56, 4), SIGNED, BorderMode.MIRROR),
    ((2, 1, 64, 3), tables.gaussian_kernel(2.0), BorderMode.MIRROR),
    ((1, 9, 1, 1), SIGNED, BorderMode.ZERO),
    ((1, 64, 64, 3), tables.gaussian_kernel(30.0), BorderMode.REPLICATE),
]


@pytest.mark.parametrize("shape,sigma,radius,thr", FILTER_CASES)
def test_filter_kernel_equals_plain(cuda, shape, sigma, radius, thr):
    x = _u8(shape, 5, cuda)
    before = fc.LAUNCHES
    got = fc.fused_blur_sharpen_morph(x, sigma, radius, thr)
    want = fc.fused_blur_sharpen_morph_reference(x, sigma, radius, thr)
    torch.cuda.synchronize()
    assert fc.LAUNCHES == before + 1
    assert torch.equal(got, want)


# the new K2 tile plans at their edges: planes just below, at and above the
# tile sides, B=1 and B=16, the blur and sharpen radii of the main paths
EDGE_SIDES = [(63, 129), (64, 65), (65, 64), (127, 63), (129, 127), (1, 65),
              (65, 1)]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("hw", EDGE_SIDES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 1.5, 2.0, 3.5])
def test_filter_kernel_at_tile_edges_equals_plain(cuda, batch, hw, sigma):
    x = _u8((batch, *hw), 20, cuda)
    for radius, thr in ((1, 127.5), (2, 128.0), (3, 90.0)):
        got = fc.fused_blur_sharpen_morph(x, sigma, radius, thr)
        want = fc.fused_blur_sharpen_morph_reference(x, sigma, radius, thr)
        assert torch.equal(got, want), (radius, thr)


@pytest.mark.parametrize("tile", fc.TILES,
                         ids=lambda t: f"bw{1 << t[0]}-th{t[1]}")
def test_filter_kernel_every_tile_equals_plain(cuda, tile, monkeypatch):
    monkeypatch.setattr(fc, "TILES", (tile,))
    monkeypatch.setattr(_build, "PLANS", {})
    monkeypatch.setattr(fc, "_stream_plan", lambda *a: None)  # the tiles
    for shape, sigma, radius, thr in (((3, 200, 300), 2.0, 2, 128.0),
                                      ((2, 130, 70), 1.0, 1, -1.0),
                                      ((1, 90, 250), 3.5, 3, 300.0),
                                      ((1, 57, 33), 1.5, 2, 127.5)):
        x = _u8(shape, 21, cuda)
        got = fc.fused_blur_sharpen_morph(x, sigma, radius, thr)
        want = fc.fused_blur_sharpen_morph_reference(x, sigma, radius, thr)
        assert torch.equal(got, want), (shape, sigma)


def test_filter_kernel_unaligned_plane_equals_plain(cuda):
    base = _u8((2 * 256 * 256 + 3,), 22, cuda)
    x = base[3:].view(2, 256, 256)   # rows not 16-byte aligned
    assert torch.equal(fc.fused_blur_sharpen_morph(x),
                       fc.fused_blur_sharpen_morph_reference(x))


def test_filter_kernel_int_form_equals_plain(cuda, monkeypatch):
    from zignal_tpu_torch.ops import integral

    monkeypatch.setattr(_build, "PLANS", {})
    monkeypatch.setattr(fc, "_stream_plan", lambda *a: None)  # the tiles
    monkeypatch.setattr(fc, "sums_fit_f32", lambda *a: False)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    x = _u8((2, 300, 200), 6, cuda)
    launches, streamed = fc.LAUNCHES, fc.STREAMED
    got = fc.fused_blur_sharpen_morph(x, 2.0, 3, 128.0)
    assert (fc.LAUNCHES, fc.STREAMED) == (launches + 1, streamed)
    assert torch.equal(got, fc.fused_blur_sharpen_morph_reference(x, 2.0, 3,
                                                                  128.0))


# the streamed kernel at its edges: planes just below, at and above one
# and two strip widths (120 output columns, 112 at r 3) and one and two
# segments of 9 rows, heights under its 20-row warm-up, B=1 and B=16
STREAM_SIDES = [(1, 120), (5, 119), (19, 121), (21, 240), (8, 241), (9, 64),
                (10, 113), (18, 250), (64, 129), (75, 1024)]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("hw", STREAM_SIDES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.5, 2.0])
def test_streamed_kernel_at_strip_and_segment_edges_equals_plain(
        cuda, batch, hw, sigma, monkeypatch):
    """Every segment length streams here, those whose warm-up sends the
    plan to the tile kernel too."""
    monkeypatch.setattr(fc, "MAX_WARMUP", float("inf"))
    monkeypatch.setattr(_build, "PLANS", {})
    x = _u8((batch, *hw), 24, cuda)
    for radius, thr in ((0, 128.0), (1, 127.5), (2, 128.0), (3, 90.0)):
        streamed = fc.STREAMED
        got = fc.fused_blur_sharpen_morph(x, sigma, radius, thr)
        want = fc.fused_blur_sharpen_morph_reference(x, sigma, radius, thr)
        assert fc.STREAMED == streamed + 1
        assert torch.equal(got, want), (radius, thr)


def test_warm_up_heavy_segments_take_the_tile_kernel(cuda):
    """B=1 of 1024^2 at sigma 1.5, r 3 (22 warm-up rows for 9-row
    segments) takes the tile kernel, B=16 the streamed one; both exact."""
    for b, streams in ((1, 0), (16, 1)):
        x = _u8((b, 1024, 1024), 28, cuda)
        launches, streamed = fc.LAUNCHES, fc.STREAMED
        got = fc.fused_blur_sharpen_morph(x, 1.5, 3, 120.0)
        assert (fc.LAUNCHES, fc.STREAMED) == (launches + 1, streamed + streams)
        assert torch.equal(got, fc.fused_blur_sharpen_morph_reference(
            x, 1.5, 3, 120.0))


@pytest.mark.parametrize("w", [1024, 1000, 130])
def test_streamed_kernel_unaligned_plane_equals_plain(cuda, w):
    """Rows that are not 16-byte aligned: every strip gathers through the
    halo tables."""
    base = _u8((4 * 75 * w + 3,), 25, cuda)
    x = base[3:].view(4, 75, w)
    for sigma, radius in ((2.0, 2), (1.0, 1)):
        assert torch.equal(fc.fused_blur_sharpen_morph(x, sigma, radius),
                           fc.fused_blur_sharpen_morph_reference(x, sigma,
                                                                 radius))


def test_int_form_takes_the_tile_kernel(cuda, monkeypatch):
    """The streamed kernel computes the f32 form only: where the bound rule
    takes the int form, the launch takes the tile kernel, exact at the
    streamed kernel's strip and segment edges too."""
    from zignal_tpu_torch.ops import integral

    monkeypatch.setattr(_build, "PLANS", {})
    monkeypatch.setattr(fc, "sums_fit_f32", lambda *a: False)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    for shape in ((16, 21, 241), (1, 75, 1024), (16, 9, 120)):
        x = _u8(shape, 26, cuda)
        for sigma, radius, thr in ((2.0, 2, 128.0), (1.5, 3, 120.0),
                                   (0.5, 0, 60.0)):
            launches, streamed = fc.LAUNCHES, fc.STREAMED
            got = fc.fused_blur_sharpen_morph(x, sigma, radius, thr)
            assert (fc.LAUNCHES, fc.STREAMED) == (launches + 1, streamed)
            assert torch.equal(got, fc.fused_blur_sharpen_morph_reference(
                x, sigma, radius, thr)), (shape, sigma, radius)


def test_streamed_counts_the_main_path_launch(cuda):
    """pipeline.filter_chain on B=16 planes of 1024^2: one launch, and it
    took the streamed kernel; a blur of 23 taps, or sigma 0, takes the
    tile kernel."""
    x = _u8((16, 1024, 1024), 27, cuda)
    launches, streamed = fc.LAUNCHES, fc.STREAMED
    mask = pipeline.filter_chain(x)
    assert (fc.LAUNCHES, fc.STREAMED) == (launches + 1, streamed + 1)
    assert torch.equal(mask, fc.fused_blur_sharpen_morph_reference(x))
    wide = fc.fused_blur_sharpen_morph(x[:2], 3.5, 3, 128.0)
    assert (fc.LAUNCHES, fc.STREAMED) == (launches + 2, streamed + 1)
    assert torch.equal(wide, fc.fused_blur_sharpen_morph_reference(
        x[:2], 3.5, 3, 128.0))
    none = fc.fused_blur_sharpen_morph(x[:2], 0.0, 2, 128.0)
    assert (fc.LAUNCHES, fc.STREAMED) == (launches + 3, streamed + 1)
    assert torch.equal(none, fc.fused_blur_sharpen_morph_reference(
        x[:2], 0.0, 2, 128.0))


# What each wrapper hands its kernel, pinned on the host: the chosen plan,
# and a digest of the packed parameter structs of a launch's variants and
# of the plan's device tables. The benchmark cells' shapes (K1 B=16 of
# 1024^2 -> 512^2, K2 at B=16 and B=1, K3's rgb -> lab values chain) and
# tile edges: C=5, an unstaged 40:1 downscale, r 3 with 13 taps at B=1, a
# 5-tap signed kernel, a filter too long for a conv tile.
PINS = [
    ("K1", (16, 1024, 1024, 3, 512, 512, 2.0, True),
     ("streamed", 8, 128, 4), "353305b6da88de95"),
    ("K1", (1, 1024, 1024, 3, 512, 512, 2.0, True), ("streamed", 8, 8, 64),
     "2d6a981ba6027d59"),
    ("K1", (2, 57, 33, 5, 20, 40, 1.5, False), (8, 8, False),
     "811e466d04fb6f39"),
    ("K1", (1, 1600, 2000, 3, 40, 50, 2.0, True), (8, 8, False),
     "c34a89f38070769d"),
    ("K1", (2, 1, 64, 3, 3, 32, 0.0, False), (8, 8, False),
     "66aa66b9bf928eae"),
    ("K2", (16, 1024, 1024, 2.0, 2, 128.0), (64, 56, (13, 74, 14)),
     "3ed7e830a8269153"),
    ("K2", (1, 1024, 1024, 2.0, 2, 128.0), (64, 24, (13, 9, 114)),
     "32adf02b1ee157df"),
    ("K2", (1, 1024, 1024, 1.5, 3, 120.0), (64, 24, None),
     "009f780c4ee1a4fa"),
    ("K2", (1, 63, 129, 3.5, 3, 90.0), (16, 8, None), "aefb1e6ebaedd71b"),
    ("K2", (16, 21, 241, 0.5, 0, 60.0), (16, 8, (7, 9, 3)),
     "6c5fa86f03e5eda6"),
    ("K3", ("rgb", "lab"), (0, 3), "6195522c6c01adc1"),
    ("K3", ("rgb", "lab", "rgb", "oklch", "rgb", "xyb", "rgb"),
     (0, 3, 7, 4, 10, 8, 5, 9, 1), "cdb7cb5da80012e7"),
    ("K3", (), (), "fffc490857cf66e7"),   # K3p's
    ("K4", (2, 40, 56, 3, SIGNED, "ZERO"), (4, 8), "f87b3d1f8a9eeadc"),
    ("K4", (1, 33, 65, 4, SIGNED, "MIRROR"), (4, 8), "eda4de6f04f9ad34"),
    ("K4", (16, 70, 150, 1, SIGNED, "WRAP"), (32, 8), "85efe2e675c67156"),
    ("K4", (1, 64, 64, 3, 30.0, "REPLICATE"), ("band", 69632),
     "cd64f938a267ab0a"),
    ("K4", (16, 1024, 1024, 3, 2.0, "MIRROR"), (64, 32), "bd7926ac4345c55f"),
    ("DET", (8, 376, 1241, 2000, 8, 31), (20, 43, 8), "0ddca85afc6c97c1"),
    ("DET", (2, 70, 90, 100, 1, 31), (2, 3, 1), "4386706e31aa3893"),
    ("DESC", (8, 376, 1241, 2000, 8, 31), (2000, 1999), "e837adbdbd101162"),
    ("DESC", (2, 70, 90, 100, 1, 31), (26, 100), "f957f2ecd4096d62"),
]


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else part.numpy().tobytes())
    return h.hexdigest()[:16]


def _pinned(kernel, case):
    """(the chosen plan, the digest) of ``case`` as the wrapper plans it
    on the host (132 SMs, an H100 SXM's)."""
    if kernel == "K1":
        p = fp._Plan(*case, "cpu")
        st = p.stream
        if st is not None:
            return ("streamed", st.strips, st.seg, st.segs), _digest(
                st.pack(False).raw, st.pack(True).raw, p.ty, p.tx, st.by,
                st.bx)
        return (p.tile.tw, p.tile.th, p.tile.staged), _digest(
            p.pack(False).raw, p.pack(True).raw, p.ty, p.tx, p.sy, p.sx)
    if kernel == "K2":
        *shape, thr = case
        p = fc._Plan(*shape, "cpu")
        st = p.stream
        return (1 << p.tile.lg_bw, p.tile.th,
                None if st is None else (st.kb, st.seg, st.segs)), _digest(
            *(p.pack(thr, vi, vo).raw for vi, vo in
              ((False, False), (True, True), (True, False))),
            p.ty, p.tx, p.sty, p.stx)
    if kernel == "DET":
        b, h, w, n_features, n_levels, edge = case
        atlas = oc.atlas_of(Orb(n_features=n_features, n_levels=n_levels,
                                edge_threshold=edge), h, w, "cpu")
        p = od._DetectPlan(b, *atlas.shape, atlas.n, atlas.levels)
        return (-(-p.fields["W"] // od.TILE[1]),
                -(-p.fields["H"] // od.TILE[0]),
                p.fields["levels"]), _digest(p.pack().raw)
    if kernel == "DESC":
        b, h, w, n_features, n_levels, edge = case
        atlas = oc.atlas_of(Orb(n_features=n_features, n_levels=n_levels,
                                edge_threshold=edge), h, w, "cpu")
        k = atlas.table.tensor.shape[0]
        p = odesc._DescribePlan(b, *atlas.shape, k)
        return (b * -(-k // odesc.WARPS), k), _digest(p.pack().raw,
                                                      atlas.table.tensor)
    if kernel == "K3":
        codes = cc.compile_chain(case) if case else ()
        return codes, _digest(cc.chain_params(codes).raw)
    b, h, w, c, k, border = case
    border = BorderMode[border]
    kint = tables._kernel_to_int(tables.gaussian_kernel(k)
                                 if isinstance(k, float) else k)
    p = sc._conv_plan(kint, kint, border, b, h, w, c, "cpu")
    if p is None:
        from zignal_tpu_torch.ops.convolution import _band

        p = sc._BandPlan(_band(w, kint, border), _band(h, kint, border), b,
                         h, w, c, "cpu")
        return ("band", p.smem), _digest(p.pack().raw, p.ysrc, p.yidx, p.yw,
                                         p.xsrc, p.xidx, p.xw)
    return (p.tile.tw, p.tile.th), _digest(p.pack(False).raw,
                                           p.pack(True).raw, p.ty, p.tx)


@pytest.mark.parametrize("kernel,case,plan,digest", PINS,
                         ids=[f"{k}-{i}" for i, (k, *_) in enumerate(PINS)])
def test_wrapper_params_and_plans_are_pinned(kernel, case, plan, digest):
    assert _pinned(kernel, case) == (plan, digest)


@pytest.mark.parametrize("shape,kernel,border", CONV_CASES)
def test_separable_kernel_equals_plain(cuda, shape, kernel, border):
    x = _u8(shape, 7, cuda)
    before = sc.LAUNCHES
    got = convolve_separable(x, kernel, kernel, border)
    want = convolve_separable_reference(x, kernel, kernel, border)
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("hw", [(63, 129), (64, 65), (129, 127), (1, 64),
                                (64, 1)], ids=lambda s: "x".join(map(str, s)))
def test_separable_kernel_at_tile_edges_equals_plain(cuda, channels, border,
                                                     hw):
    x = _u8((2, *hw, channels), 23, cuda)
    for kernel in (tables.gaussian_kernel(2.0), tables.gaussian_kernel(1.0),
                   tables.gaussian_kernel(1.5), SIGNED,
                   tables.gaussian_kernel(3.5)):
        got = convolve_separable(x, kernel, kernel, border)
        want = convolve_separable_reference(x, kernel, kernel, border)
        assert torch.equal(got, want), len(kernel)


@pytest.mark.parametrize("tile", sc.CONV_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_separable_kernel_every_tile_equals_plain(cuda, tile, monkeypatch):
    monkeypatch.setattr(sc, "CONV_TILES", (tile,))
    monkeypatch.setattr(_build, "PLANS", {})
    k2 = tables.gaussian_kernel(2.0)
    for shape, kx, ky, border in (
            ((16, 70, 150, 3), k2, k2, BorderMode.MIRROR),
            ((2, 45, 100, 1), tables.gaussian_kernel(1.0), k2,
             BorderMode.WRAP),
            ((1, 33, 65, 4), SIGNED, SIGNED, BorderMode.ZERO),
            ((3, 40, 48, 2), (0.25, 0.5, 0.25), k2, BorderMode.REPLICATE)):
        x = _u8(shape, 24, cuda)
        got = convolve_separable(x, kx, ky, border)
        assert torch.equal(got, convolve_separable_reference(x, kx, ky,
                                                             border))


@pytest.mark.parametrize("channels", [5, 6, 8])
def test_separable_kernel_of_more_than_four_channels_equals_plain(cuda,
                                                                  channels):
    """F3: more than 4 channels run K4 in channel groups, on the conv path
    (f32 and int32 height passes, every border) and on the band path."""
    x = _u8((2, 17, 19, channels), 33, cuda)
    before = sc.LAUNCHES
    blur = convolve_separable(x, tables.gaussian_kernel(1.0),
                              tables.gaussian_kernel(1.0))
    assert sc.LAUNCHES == before + 2  # two groups of at most 4 channels
    assert torch.equal(blur, convolve_separable_reference(
        x, tables.gaussian_kernel(1.0), tables.gaussian_kernel(1.0)))
    y = _u8((3, 70, 90, channels), 34, cuda)
    for kernel in (tables.gaussian_kernel(2.0), SIGNED):
        for border in BorderMode:
            assert torch.equal(
                convolve_separable(y, kernel, kernel, border),
                convolve_separable_reference(y, kernel, kernel, border)), \
                (len(kernel), border)
    long = tables.gaussian_kernel(43.0)   # more taps than a conv tile takes
    assert torch.equal(convolve_separable(y, long, (1.0,)),
                       convolve_separable_reference(y, long, (1.0,)))
    a, b, f = tables.bilinear_axis_table(90, 45)
    mx = tables.build_tap_matrix(np.stack([a, b], 1),
                                 np.stack([256 - f, f], 1), 90, 45)
    a, b, f = tables.bilinear_axis_table(70, 35)
    my = tables.build_tap_matrix(np.stack([a, b], 1),
                                 np.stack([256 - f, f], 1), 70, 35)
    assert torch.equal(sc.separable_u8(y, mx, my),
                       sc.separable_u8_reference(y, mx, my))


def test_separable_kernel_int_route_and_long_kernels_equal_plain(cuda):
    x = _u8((2, 70, 90, 3), 25, cuda)
    k2 = tables.gaussian_kernel(2.0)
    for kx, ky in ((SIGNED, SIGNED), (SIGNED, k2), (k2, SIGNED)):
        # signed bands past 2^24: the int32 height pass
        assert not sc.f32_exact(tables._kernel_to_int(kx),
                                tables._kernel_to_int(ky))
    for kx, ky in ((SIGNED, SIGNED), (SIGNED, k2),
                   (tables.gaussian_kernel(43.0), (1.0,))):
        assert torch.equal(convolve_separable(x, kx, ky),
                           convolve_separable_reference(x, kx, ky))


def test_separable_kernel_unaligned_batch_equals_plain(cuda):
    base = _u8((2 * 64 * 80 * 3 + 5,), 26, cuda)
    x = base[5:].view(2, 64, 80, 3)
    k = tables.gaussian_kernel(2.0)
    assert torch.equal(convolve_separable(x, k, k),
                       convolve_separable_reference(x, k, k))


def test_separable_kernel_on_a_non_square_band(cuda):
    x = _u8((2, 1024, 768, 3), 8, cuda)
    a, b, f = tables.bilinear_axis_table(1024, 512)
    my = tables.build_tap_matrix(np.stack([a, b], 1),
                                 np.stack([256 - f, f], 1), 1024, 512)
    a, b, f = tables.bilinear_axis_table(768, 384)
    mx = tables.build_tap_matrix(np.stack([a, b], 1),
                                 np.stack([256 - f, f], 1), 768, 384)
    got = sc.separable_u8(x, mx, my)
    assert got.shape == (2, 512, 384, 3)
    assert torch.equal(got, sc.separable_u8_reference(x, mx, my))


def test_image_batch_filters_launch_the_kernels(cuda):
    x = _u8((2, 96, 80, 3), 9, cuda)
    ib = ImageBatch(x, device=cuda)
    k2, k4 = fc.LAUNCHES, sc.LAUNCHES
    blur = ib.gaussian_blur(2.0)
    conv = ib.convolve_separable(SIGNED, SIGNED, BorderMode.REPLICATE)
    gray = x[..., 0].contiguous()
    mask = pipeline.filter_chain(gray)
    assert (fc.LAUNCHES, sc.LAUNCHES) == (k2 + 1, k4 + 2)
    assert torch.equal(blur.device_array(),
                       convolve_separable_reference(
                           x, tables.gaussian_kernel(2.0),
                           tables.gaussian_kernel(2.0)))
    assert torch.equal(conv.device_array(), convolve_separable_reference(
        x, SIGNED, SIGNED, BorderMode.REPLICATE))
    assert torch.equal(mask, fc.fused_blur_sharpen_morph_reference(gray))


def test_new_kernels_reject_non_contiguous(cuda):
    x = _u8((64, 64), 10, cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_blur_sharpen_morph(x)
    y = _u8((1, 64, 64, 3), 11, cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sc.run_cached(y, "k", None)


# f32 max-abs, K3 vs plain on the card. K3 takes its cube roots with the
# card's cbrtf (1 ulp) where the plain version takes sign(x) * |x|^(1/3f);
# the chains amplify that ulp where a channel is dark. Measured over all
# 2^24 RGB triples of the six chains of chip_smoke.py on an H100: 9.24e-5
# (rgb-lab-rgb-oklch-rgb-xyb-rgb), rounded up; every u8 output is equal.
CHAIN_UNIT = 1e-4
CHAINS = [  # test_pallas_color.py's chains, then stock hops the gate admits
    ("rgb", "lab", "rgb", "oklch", "rgb", "xyb", "rgb"),
    ("rgb", "oklab", "rgb"),
    ("rgb", "lab", "lch", "lab", "rgb"),
    ("rgb", "xyz", "rgb"),
    ("rgb", "xyb", "rgb"),
    ("rgb", "oklch", "rgb"),
    ("rgb", "xyz", "lab", "rgb"),
    ("rgb", "lab", "oklab", "xyb", "rgb"),
    ("rgb", "xyb", "xyz", "oklab", "oklch", "rgb"),
    ("rgb", "rgb"),
]


@pytest.mark.parametrize("spaces", CHAINS, ids=["-".join(c) for c in CHAINS])
@pytest.mark.parametrize("shape", [(2, 64, 128, 3), (3, 5, 7, 3),
                                   (1, 1, 1, 3)])
def test_color_chain_kernel_equals_plain(cuda, spaces, shape):
    x = _u8(shape, 12, cuda)
    before = cc.LAUNCHES
    got = cc.fused_color_chain_u8(x, spaces)
    f = cc.fused_color_chain_u8(x, spaces, quantize=False)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 2 and cc.PROBE_LAUNCHES >= 1
    assert torch.equal(got, cc.fused_color_chain_u8_reference(x, spaces))
    want = cc.fused_color_chain_u8_reference(x, spaces, quantize=False)
    assert f.dtype == torch.float32 and f.shape == x.shape
    assert float((f - want).abs().max()) <= CHAIN_UNIT
    # not a copy of its input: the f32 values are the chain's, off the bytes
    if spaces != ("rgb", "rgb"):
        assert float((f * 255 - x.float()).abs().max()) > 0


def test_color_chain_kernel_on_every_rgb_triple(cuda):
    v = torch.arange(1 << 24, device=cuda, dtype=torch.int64)
    x = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1) \
        .to(torch.uint8).reshape(1, 4096, 4096, 3)
    spaces = CHAINS[0]
    assert torch.equal(cc.fused_color_chain_u8(x, spaces), x)
    f = cc.fused_color_chain_u8(x, spaces, quantize=False)
    want = convert_chain(x.to(torch.float32) / 255.0, spaces)
    assert float((f - want).abs().max()) <= CHAIN_UNIT


def test_transcendentals_probe_equals_plain(cuda):
    x = torch.rand(1 << 20, device=cuda, generator=None) * 2.0
    before = cc.PROBE_LAUNCHES
    got = cc.transcendentals_probe(x)
    assert cc.PROBE_LAUNCHES == before + 1
    err = cc.probe_error(got, cc.transcendentals_probe_reference(x))
    assert err <= cc.PROBE_TOL


# K3p's redesign: 4 values a thread through float4 loads, a scalar head up
# to x's 16-byte boundary and a scalar tail; an offset view leaves y's
# stores scalar too
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 1024, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_transcendentals_probe_at_any_size_and_alignment(cuda, n, offset):
    rng = np.random.default_rng(n + offset)
    buf = torch.from_numpy(rng.uniform(0, 2, n + offset).astype(
        np.float32)).to(cuda)
    x = buf[offset:]
    assert x.data_ptr() % 16 == 4 * offset % 16
    got = cc.transcendentals_probe(x)
    assert got.shape == x.shape
    assert cc.probe_error(got, cc.transcendentals_probe_reference(x)) \
        <= cc.PROBE_TOL


def test_transcendentals_probe_on_the_tpu_tile(cuda):
    x = torch.linspace(0.0, 2.0, 8 * 128, device=cuda).reshape(8, 128)
    got = cc.transcendentals_probe(x)
    assert got.shape == (8, 128)
    assert cc.probe_error(got, cc.transcendentals_probe_reference(x)) \
        <= cc.PROBE_TOL


def test_color_chain_u8_launches_the_kernel(cuda):
    x = _u8((2, 32, 48, 3), 13, cuda)
    spaces = CHAINS[0]
    before = cc.LAUNCHES
    got = pipeline.color_chain_u8(x, spaces)
    other = pipeline.color_chain_u8(x, ("rgb", "hsv", "rgb"))
    assert cc.LAUNCHES == before + 1
    assert torch.equal(got, cc.fused_color_chain_u8_reference(x, spaces))
    want = pipeline.color_chain_u8(x.cpu(), ("rgb", "hsv", "rgb"))
    assert torch.equal(other.cpu(), want)


# the values route's one-hop chains, K3 against the plain version on the
# card: within CHAIN_UNIT (over all 2^24 RGB triples on an H100, rgb->lab
# reads 6.1e-5 on a, 7.6e-6 on L; xyz 0; oklab 3.9e-7; xyb 1.2e-7)
VALUE_ENDS = ("xyz", "lab", "oklab", "xyb")


def test_color_chain_values_launch_k3_once_at_the_camera_frame(cuda):
    """``pipeline.color_chain_values`` on two 16-MP frames (4608 x 3456):
    one K3 launch a call, counted by ``VALUES``, within CHAIN_UNIT of the
    plain version; a cylindrical end takes the plain path."""
    x = _u8((2, 3456, 4608, 3), 41, cuda)
    for end in VALUE_ENDS:
        spaces = ("rgb", end)
        launches, values = cc.LAUNCHES, cc.VALUES
        got = pipeline.color_chain_values(x, spaces)
        assert (cc.LAUNCHES, cc.VALUES) == (launches + 1, values + 1)
        want = convert_chain(x.to(torch.float32) / 255.0, spaces)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert float((got - want).abs().max()) <= CHAIN_UNIT, end
    launches = cc.LAUNCHES
    got = pipeline.color_chain_values(x[:, :8], ("rgb", "lch"))
    assert cc.LAUNCHES == launches
    assert torch.equal(got, convert_chain(
        x[:, :8].to(torch.float32) / 255.0, ("rgb", "lch")))


# longer values chains, K3 against the plain version: a hop back to linear
# rgb and out again moves a dark channel's ulp-level error through a
# second cube root near LAB_EPSILON, and a and b multiply it by 500 and
# 200. Over all 2^24 RGB triples on an H100: 3.9e-4 (rgb-lab-rgb-oklch-
# rgb-lab), 8.7e-4 (rgb-xyb-xyz-lab, b), 6.1e-5 (rgb-lch-lab), 6.0e-7
# (rgb-oklch-oklab-xyb); rounded up
VALUES_CHAIN_UNIT = 1e-3
LONG_VALUE_CHAINS = [("rgb", "lab", "rgb", "oklch", "rgb", "lab"),
                     ("rgb", "xyb", "xyz", "lab"), ("rgb", "lch", "lab"),
                     ("rgb", "oklch", "oklab", "xyb")]


@pytest.mark.parametrize("spaces", LONG_VALUE_CHAINS,
                         ids=["-".join(c) for c in LONG_VALUE_CHAINS])
def test_longer_values_chains_on_every_rgb_triple(cuda, spaces):
    v = torch.arange(1 << 24, device=cuda, dtype=torch.int64)
    x = torch.stack([v >> 16, (v >> 8) & 255, v & 255], -1) \
        .to(torch.uint8).reshape(1, 4096, 4096, 3)
    values = cc.VALUES
    got = pipeline.color_chain_values(x, spaces)
    assert cc.VALUES == values + 1
    want = convert_chain(x.to(torch.float32) / 255.0, spaces)
    assert float((got - want).abs().max()) <= VALUES_CHAIN_UNIT


def test_batched_equalize_at_the_camera_frame_queues_without_a_sync(cuda):
    """Equalize of four 16-MP frames on the card: no call waits for it
    (``set_sync_debug_mode`` raises on one), and its bytes equal the
    CPU's."""
    from zignal_tpu_torch.ops import enhancement

    x = _u8((4, 3456, 4608, 3), 42, cuda) // 2 + 40  # a peaked histogram
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = enhancement.equalize(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), enhancement.equalize(x.cpu()))
    assert int(got.max()) == 255 and int(got.min()) == 0


def test_recorder_holds_the_colorspace_stages_on_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from zignal_tpu_torch.ops import enhancement
    from zignal_tpu_torch.profiling import RECORDER

    x = _u8((1, 33, 47, 3), 43, cuda)
    pipeline.color_chain_values(x, ("rgb", "lab"))  # K3p's one launch
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            pipeline.color_chain_values(enhancement.equalize(x),
                                        ("rgb", "lab"))
        torch.cuda.synchronize()
    spans = RECORDER.spans
    # equalize's three kernel launches: the histogram's inside
    # equalize.hist, the tables' and the lookup's inside equalize.lut;
    # then K3's launch inside the values entry
    call = ["launch", "equalize.hist", "launch", "launch", "equalize.lut",
            "equalize", "launch", "color_chain_values"]
    assert [s[0] for s in spans] == call * 2
    for one in (spans[:8], spans[8:]):
        hist, lut = one[1], one[4]
        assert hist[1] <= one[0][1] <= one[0][2] <= hist[2]
        assert lut[1] <= one[2][1] <= one[2][2] <= one[3][1] \
            <= one[3][2] <= lut[2]
        by = {name: (t0, t1) for name, t0, t1, _ in one}  # K3's launch last
        entry = by["color_chain_values"]
        assert by["equalize"][1] <= entry[0] <= by["launch"][0] \
            <= by["launch"][1] <= entry[1]


def test_histogram_ops_on_the_card_equal_the_cpu(cuda):
    x = _u8((2, 40, 56, 3), 14, cuda)
    ib, cpu = ImageBatch(x, device=cuda), ImageBatch(x.cpu(), device="cpu")
    assert torch.equal(ib.histogram().cpu(), cpu.histogram())
    assert torch.equal(ib.equalize().device_array().cpu(),
                       cpu.equalize().device_array())
    assert torch.equal(ib.autocontrast(0.01).device_array().cpu(),
                       cpu.autocontrast(0.01).device_array())
    got, t = ib.convert(Gray).threshold_otsu()
    want, wt = cpu.convert(Gray).threshold_otsu()
    assert (t == wt).all()
    assert torch.equal(got.device_array().cpu(), want.device_array())


def test_color_chain_kernel_unaligned_batch_equals_plain(cuda):
    """A batch whose bytes are not 4-byte aligned takes the kernel's
    byte-wise loads and stores; pixel counts off a multiple of 4 take its
    one-pixel tail."""
    base = _u8((5 * 7 * 3 * 3 + 1,), 35, cuda)
    x = base[1:].view(3, 5, 7, 3)
    for quantize in (True, False):
        got = cc.fused_color_chain_u8(x, CHAINS[0], quantize)
        want = cc.fused_color_chain_u8_reference(x, CHAINS[0], quantize)
        assert float((got.float() - want.float()).abs().max()) <= \
            (0 if quantize else CHAIN_UNIT)


def test_gamma_table_on_the_card_matches_the_cpu(cuda):
    """K1's and K3's input gamma, computed on the card, against the same
    table computed on the CPU (which tests/test_torch_color.py holds to
    JAX): within 1e-5 max-abs (UNIT there)."""
    table = tables.gamma_table(cuda)
    assert table.dtype == torch.float32 and table.shape == (256,)
    want = tables.gamma_table("cpu")
    assert float((table.cpu() - want).abs().max()) <= 1e-5


def test_color_chain_kernel_rejects_non_contiguous(cuda):
    x = _u8((1, 64, 64, 3), 15, cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        cc.fused_color_chain_u8(x, CHAINS[0])


def test_resize_takes_any_leading_dims_on_the_card(cuda):
    x = _u8((2, 3, 37, 53, 3), 16, cuda)
    before = fp.LAUNCHES
    got = resize(x, 20, 31)
    assert fp.LAUNCHES == before + 1
    assert got.shape == (2, 3, 20, 31, 3)
    assert torch.equal(got.cpu(), resize(x.cpu(), 20, 31))
    rgb = _u8((2, 37, 53, 4), 17, cuda)[..., :3]   # not contiguous
    assert torch.equal(resize(rgb, 20, 31).cpu(), resize(rgb.cpu(), 20, 31))


def test_image_pyramid_launches_the_blur_and_resize_kernels(cuda):
    from zignal_tpu_torch.ops.pyramid import ImagePyramid

    x = _u8((300, 410), 17, cuda)
    k1, k4 = fp.LAUNCHES, sc.LAUNCHES
    got = ImagePyramid.build(x, 6)
    assert (fp.LAUNCHES - k1, sc.LAUNCHES - k4) == (5, 1)
    want = ImagePyramid.build(x.cpu(), 6)
    for g, w in zip(got.levels, want.levels):
        assert torch.equal(g.cpu(), w)


# the new plain paths on the card against the CPU: u8 equal, floats within
# the bounds of the CPU tests (an f64 multiply-add rounds the same on both)
F255_TOL = 1e-4


@pytest.mark.parametrize("method,args", [
    *[("resize", ((21, 34), m)) for m in range(6)],
    ("resize", ((70, 61), 5)), ("letterbox", ((40, 60),)),
    ("letterbox", ((30, 30), 2)),
    ("convolve", (((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0)),)),
    ("convolve", ((np.ones((5, 5)) / 25).tolist(), BorderMode.ZERO)),
    ("median_blur", (2,)), ("percentile_blur", (3, 0.9, BorderMode.WRAP)),
    ("min_blur", (2,)), ("max_blur", (2, BorderMode.ZERO)),
    ("midpoint_blur", (2,)), ("alpha_trimmed_mean_blur", (2, 0.2)),
    ("sobel", ()), ("canny", ()), ("shen_castan", ()),
    ("shen_castan", (0.8, 7, 0.9, 0.5, True, True)),
    ("threshold_adaptive_mean", ()),
])
def test_new_image_batch_paths_on_the_card_equal_the_cpu(cuda, method, args):
    x = _u8((2, 48, 64, 3), 18, cuda)
    got = getattr(ImageBatch(x, device=cuda), method)(*args)
    want = getattr(ImageBatch(x.cpu(), device="cpu"), method)(*args)
    assert torch.equal(got.device_array().cpu(), want.device_array())


def test_float_paths_on_the_card_are_within_bound_of_the_cpu(cuda):
    from zignal_tpu_torch.ops import edges, integral
    from zignal_tpu_torch.ops.convolution import convolve2d, sobel_gradients

    x = (torch.rand((2, 40, 52, 3), generator=torch.Generator().manual_seed(0))
         * 255).to(cuda)
    k = tables.gaussian_kernel(1.5)
    pairs = [(resize(x, 23, 70, m), resize(x.cpu(), 23, 70, m))
             for m in range(6)]
    pairs.append((convolve_separable(x, k, k), convolve_separable(x.cpu(), k,
                                                                   k)))
    pairs.append((convolve2d(x, ((0.1, 0.2, 0.1),) * 3),
                  convolve2d(x.cpu(), ((0.1, 0.2, 0.1),) * 3)))
    pairs.append((integral.box_blur(x, 2), integral.box_blur(x.cpu(), 2)))
    pairs += list(zip(sobel_gradients(x[..., 0]),
                      sobel_gradients(x[..., 0].cpu())))
    pairs.append((edges.isef_filter(x[..., 0], 0.9),
                  edges.isef_filter(x[..., 0].cpu(), 0.9)))
    for got, want in pairs:
        assert float((got.cpu() - want).abs().max()) <= F255_TOL


# -- the Image container and the pinned loader on the card --------------------

def test_image_resize_and_gaussian_blur_launch_k1_and_k4(cuda):
    from zignal_tpu_torch import Image

    arr = np.random.default_rng(70).integers(0, 256, (96, 128, 3), np.uint8)
    img = Image.from_numpy(arr, device=cuda)
    cpu = Image.from_numpy(arr.copy(), device="cpu")
    k1, k4 = fp.LAUNCHES, sc.LAUNCHES
    small = img.resize((48, 64))
    assert (fp.LAUNCHES, sc.LAUNCHES) == (k1 + 1, k4)
    blurred = img.gaussian_blur(2.0)
    assert (fp.LAUNCHES, sc.LAUNCHES) == (k1 + 1, k4 + 1)
    boxed = img.letterbox((80, 80))
    assert fp.LAUNCHES == k1 + 2
    assert small.device.type == "cuda"
    assert np.array_equal(small.to_numpy(),
                          cpu.resize((48, 64)).to_numpy())
    assert np.array_equal(blurred.to_numpy(),
                          cpu.gaussian_blur(2.0).to_numpy())
    assert np.array_equal(boxed.to_numpy(),
                          cpu.letterbox((80, 80)).to_numpy())
    # the borrowed array is uploaded anew by every op
    arr[:8] = 0
    assert np.array_equal(img.resize((48, 64)).to_numpy(),
                          Image.from_numpy(arr.copy(), device="cpu")
                          .resize((48, 64)).to_numpy())


def test_pinned_loader_batches_equal_the_cpu(cuda, tmp_path):
    from zignal_tpu_torch import BatchLoader, codecs, load_image_batch

    rng = np.random.default_rng(71)
    paths = []
    for i, (h, w) in enumerate([(64, 64), (48, 80), (90, 60), (64, 64),
                                (33, 47)]):
        p = str(tmp_path / f"f{i}.{('png', 'jpg')[i % 2]}")
        codecs.save_array(p, rng.integers(0, 256, (h, w, 3), np.uint8))
        paths.append(p)
    k1 = fp.LAUNCHES
    got = load_image_batch(paths, shape=(64, 64), device=cuda)
    assert got.device.type == "cuda"
    assert fp.LAUNCHES == k1 + 3   # the three letterboxed files
    want = load_image_batch(paths, shape=(64, 64), device="cpu")
    assert torch.equal(got.cpu(), want)
    batches = list(BatchLoader(paths, batch_size=2, shape=(64, 64),
                               device=cuda))
    cpu = list(BatchLoader(paths, batch_size=2, shape=(64, 64),
                           device="cpu"))
    assert len(batches) == len(cpu) == 3
    for g, w in zip(batches, cpu):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    ib = ImageBatch.from_paths(paths, shape=(64, 64), device=cuda)
    lab = ib.resize_blur_oklab((32, 32), 2.0)
    ref = ImageBatch.from_paths(paths, shape=(64, 64), device="cpu") \
        .resize_blur_oklab((32, 32), 2.0)
    assert float((lab.cpu() - ref).abs().max()) <= OKLAB_TOL


def test_image_batch_new_members_on_the_card_equal_the_cpu(cuda):
    from zignal_tpu_torch import Blending, Gray

    x = _u8((2, 40, 56, 3), 72, cuda)
    over = _u8((2, 40, 56, 4), 73, cuda)
    ib, cpu = ImageBatch(x, device=cuda), ImageBatch(x.cpu(), device="cpu")
    calls = [("invert", ()), ("flip_left_right", ()),
             ("flip_top_bottom", ()), ("fill", ((1, 2, 3),)),
             ("set_border", ((3, 4, 30, 20), (9, 9, 9))),
             ("convert", (Gray,))]
    for name, args in calls:
        got, want = getattr(ib, name)(*args), getattr(cpu, name)(*args)
        assert got.dtype is want.dtype
        assert torch.equal(got.device_array().cpu(), want.device_array())
    for mode in Blending:
        got = ib.blend(ImageBatch(over, device=cuda), mode)
        want = cpu.blend(ImageBatch(over.cpu(), device="cpu"), mode)
        assert torch.equal(got.device_array().cpu(), want.device_array()), \
            mode
    images = ib.to_images()
    back = ImageBatch.from_images(images, device=cuda)
    assert torch.equal(back.device_array(), x)


def test_launch_counts_hold_under_threads(cuda):
    """The loader's decode threads launch K1 at once: no count is lost."""
    import sys
    import threading

    x = _u8((1, 64, 80, 3), 74, cuda)
    n, calls = 16, 20
    gate = threading.Barrier(n)

    def work():
        gate.wait(timeout=60)
        for _ in range(calls):
            fp.fused_resize_blur_oklab(x, 32, 40, 0.0, oklab=False)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = fp.LAUNCHES
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + n * calls


def test_axis_aligned_linear_motion_blur_launches_the_separable_kernel(cuda):
    """An axis-aligned u8 linear motion blur is the box filter under
    REPLICATE: one K4 launch a call (C <= 4), equal to the plain version;
    an oblique one launches nothing."""
    import math

    from zignal_tpu_torch import MotionBlur

    x = _u8((2, 48, 60, 3), 75, cuda)
    ib = ImageBatch(x, device=cuda)
    for angle, distance in ((0.0, 9), (math.pi / 2, 4), (math.pi, 10)):
        k = (1.0 / distance,) * distance
        kx, ky = (k, (1.0,)) if abs(math.sin(angle)) < 0.5 else ((1.0,), k)
        before = sc.LAUNCHES
        got = ib.motion_blur(MotionBlur.linear(angle, distance))
        assert sc.LAUNCHES == before + 1
        want = convolve_separable_reference(x, kx, ky, BorderMode.REPLICATE)
        assert torch.equal(got.device_array(), want)
    counts = (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES)
    ib.motion_blur(MotionBlur.linear(0.7, 9))
    torch.cuda.synchronize()
    assert (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES) == counts


def test_geometric_and_blur_members_on_the_card_equal_the_cpu(cuda):
    """Every item-11 member on a CUDA batch equals the same call on the
    CPU: the coordinates are the same host f32 arrays, and the device
    arithmetic is the same f32 (fused multiply-adds through ops/fma.py);
    no kernel of csrc/ launches but K4 for the axis-aligned blur."""
    import math

    from zignal_tpu_torch import (Blending, Image, Interpolation, MotionBlur,
                                  ProjectiveTransform, SimilarityTransform)

    x = _u8((2, 40, 56, 3), 76, cuda)
    src = Image.from_numpy(_u8((12, 15, 4), 77, "cpu").numpy(), device=cuda)
    proj = ProjectiveTransform([(0, 0), (55, 0), (0, 39), (55, 39)],
                               [(3, 2), (50, 4), (-2, 36), (58, 35)])
    sim = SimilarityTransform([(2, 3), (40, 30)], [(5, 1), (44, 33)])
    calls = [("rotate 0.5", lambda t: t.rotate(0.5)),
             ("rotate pi/2", lambda t: t.rotate(math.pi / 2)),
             ("rotate LANCZOS WRAP", lambda t: t.rotate(
                 -1.1, Interpolation.LANCZOS, BorderMode.WRAP)),
             ("extract", lambda t: t.extract((4, 3, 40, 30), 0.3, (20, 24))),
             ("crop", lambda t: t.crop((-5, 10, 30, 45))),
             ("warp BILINEAR", lambda t: t.warp(proj)),
             ("warp BICUBIC", lambda t: t.warp(proj, None,
                                               Interpolation.BICUBIC)),
             ("warp MITCHELL", lambda t: t.warp(sim, (30, 30),
                                                Interpolation.MITCHELL)),
             ("insert", lambda t: t.insert(src, (5, 5, 30, 25), 0.2,
                                           Interpolation.BILINEAR,
                                           Blending.OVERLAY)),
             ("linear 0.7", lambda t: t.motion_blur(MotionBlur.linear(0.7,
                                                                      9))),
             ("zoom", lambda t: t.motion_blur(MotionBlur.radial_zoom())),
             ("spin", lambda t: t.motion_blur(MotionBlur.radial_spin()))]
    ib, cpu = ImageBatch(x, device=cuda), ImageBatch(x.cpu(), device="cpu")
    counts = (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES)
    for name, fn in calls:
        got, want = fn(ib), fn(cpu)
        assert got.device.type == "cuda" and got.dtype is want.dtype, name
        assert torch.equal(got.device_array().cpu(), want.device_array()), \
            name
    torch.cuda.synchronize()
    assert (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES) == counts
    # Image members run the same ops on a batch of one
    img = Image.from_numpy(x[0].cpu().numpy(), device=cuda)
    assert np.array_equal(img.rotate(0.5).to_numpy(),
                          cpu.rotate(0.5).device_array()[0].numpy())


def test_metrics_on_the_card_are_within_bounds_of_the_cpu(cuda):
    from zignal_tpu_torch import MotionBlur

    x = _u8((3, 40, 48, 3), 78, cuda)
    ib = ImageBatch(x, device=cuda)
    blurred = ib.motion_blur(MotionBlur.linear(0.4, 5))
    cpu, cpu_b = (ImageBatch(t.device_array().cpu(), device="cpu")
                  for t in (ib, blurred))
    for name in ("psnr", "mean_pixel_error", "ssim"):
        got = getattr(ib, name)(blurred)
        want = getattr(cpu, name)(cpu_b)
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    vis, counts = ib.diff(blurred, threshold=2, scale=1.7)
    cvis, ccounts = cpu.diff(cpu_b, threshold=2, scale=1.7)
    assert torch.equal(vis.device_array().cpu(), cvis.device_array())
    assert torch.equal(counts.cpu(), ccounts)


def test_orb_batch_launches_the_pyramid_kernels_once_a_call(cuda):
    """The batched ORB builds one pyramid for the whole [B, H, W] stack:
    K4 once and K1 n_levels - 1 times a call, not a call per image; its
    keypoints and descriptors equal the same call on the CPU."""
    from zignal_tpu_torch.features import Orb

    planes = [_u8((96, 100), 80 + i, "cpu").numpy() for i in range(3)]
    orb = Orb(n_features=80, n_levels=4)
    k1, k4 = fp.LAUNCHES, sc.LAUNCHES
    got = orb.detect_and_compute_batch(planes, device=cuda)
    torch.cuda.synchronize()
    assert (fp.LAUNCHES - k1, sc.LAUNCHES - k4) == (3, 1)
    want = orb.detect_and_compute_batch(planes, device="cpu")
    for (kg, dg), (kw, dw) in zip(got, want):
        assert [(k.x, k.y, k.octave, k.response, k.angle) for k in kg] == \
            [(k.x, k.y, k.octave, k.response, k.angle) for k in kw]
        assert all(np.array_equal(a.bits, b.bits) for a, b in zip(dg, dw))


@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("name", oc.CASES)
def test_detect_kernel_equals_the_plain_route(cuda, name, harris):
    """ORB's detect kernel (csrc/orb_detect.cu, one launch a call) gives
    the plain route's candidates bit for bit, -inf included, on every
    case of tests/_orb_atlas_cases.py: the KITTI atlas at B=1 and B=8,
    empty shelf space, one level, a flat frame, pixels planted at a
    level's edges and next to another level, arcs of 9 taps wrapping past
    tap 15."""
    atlas, plane = oc.case(name, cuda)
    before = od.LAUNCHES
    got = atlas.candidates(plane, harris)
    torch.cuda.synchronize()
    assert od.LAUNCHES == before + 1
    want = atlas.candidates_reference(plane, harris)
    assert got.shape == want.shape == (plane.shape[0], atlas.n)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isfinite(want).any()) == (name != "flat")


@pytest.mark.parametrize("name", oc.CASES + oc.PLACED)
def test_describe_kernel_equals_the_plain_route(cuda, name):
    """ORB's describe kernel (csrc/orb_describe.cu, one launch a call)
    gives the plain route's rows, descriptors and validity bit for bit on
    every row, valid or not, on every case of tests/_orb_atlas_cases.py:
    the keypoints the detect and select stages choose on each atlas (the
    KITTI atlas at B=1 and B=8, the top-k's -inf padding), keypoints
    anywhere on their levels, a table of 40 levels (past the detect
    kernel's 32), and samples past the window on a level wider than
    2^20 px."""
    atlas, plane, resp, idx = oc.keypoints(name, cuda)
    before = odesc.LAUNCHES
    got = atlas.describe(plane, resp, idx)
    torch.cuda.synchronize()
    assert odesc.LAUNCHES == before + 1
    want = atlas.describe_reference(plane, resp, idx)
    k = atlas.table.tensor.shape[0]
    for g, wt, shape in zip(got, want, ((5,), (32,), ())):
        assert g.shape == wt.shape == (plane.shape[0], k) + shape
        assert g.dtype == wt.dtype and g.device.type == "cuda"
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("b", [1, 8])
def test_describe_kernel_of_no_keypoints_launches_nothing(cuda, b):
    """K = 0: empty rows, descriptors and validity, and no launch."""
    plane = _u8((b, 40, 60), 28, cuda)
    before = odesc.LAUNCHES
    rows, desc, valid = odesc.describe(
        plane, torch.zeros((b, 0), device=cuda),
        torch.zeros((b, 0), dtype=torch.int64, device=cuda),
        odesc.RowTable(np.zeros((0, odesc.TABLE_COLS), np.int32), (40, 60),
                       cuda))
    assert (rows.shape, desc.shape, valid.shape) == ((b, 0, 5), (b, 0, 32),
                                                     (b, 0))
    assert odesc.LAUNCHES == before


def test_orb_stereo_request_at_kitti_size_waits_for_nothing(cuda):
    """One stereo request of 8 frames of 1241 x 376 (ORB at 2000 features,
    then each left frame matched with its right) after a warm-up call
    issues no host-device synchronization: it raises nothing under
    ``set_sync_debug_mode("error")``. Its keypoints, descriptors and
    matches equal the same request on the CPU; the counters count its
    8 levels, 4 pairs and one launch each of the detect and describe
    kernels."""
    from zignal_tpu_torch.features import Orb, matcher, orb

    gen = torch.Generator().manual_seed(86)
    x = torch.randint(0, 256, (8, 376, 1241), generator=gen,
                      dtype=torch.uint8)
    x[:, 100:250, 300:900] //= 4  # a darker block: structure beside noise
    det = Orb(n_features=2000, edge_threshold=31)

    def request(planes):
        kps, desc, valid = det.detect_and_compute_tensors(planes)
        return kps, desc, valid, matcher.match_tensors(
            desc[0::2], valid[0::2], desc[1::2], valid[1::2])

    card = x.to(cuda)
    request(card)
    torch.cuda.synchronize()
    levels, pairs, detects, describes = orb.LEVELS, matcher.PAIRS, \
        od.LAUNCHES, odesc.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = request(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (orb.LEVELS - levels, matcher.PAIRS - pairs, od.LAUNCHES - detects,
            odesc.LAUNCHES - describes) == (8, 4, 1, 1)
    want = request(x)
    for a, b in zip(got[:3] + got[3], want[:3] + want[3]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert int(want[2].sum()) > 8 * 1000 and int((want[3][0] >= 0).sum()) > 0


def test_fdm_hough_and_matcher_on_the_card_equal_the_cpu(cuda):
    """FDM's statistics and map are f32 operations rounded alone in a
    fixed order (and f64 FMAs): the card gives the CPU's bits. The Hough
    votes and the Hamming distances are integers."""
    from zignal_tpu_torch import FeatureDistributionMatching, Image
    from zignal_tpu_torch.features import BinaryDescriptor, BruteForceMatcher
    from zignal_tpu_torch.ops.hough import HoughTransform

    src = _u8((3, 70, 90, 3), 81, "cpu")
    tgt = _u8((60, 50, 3), 82, "cpu").numpy() // 2 + 40
    got = FeatureDistributionMatching().match_batch(
        src.to(cuda), Image.from_numpy(tgt.copy(), device=cuda))
    want = FeatureDistributionMatching().match_batch(
        src, Image.from_numpy(tgt.copy(), device="cpu"))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    for dev in (cuda, "cpu"):
        im = Image.from_numpy(src[0].numpy().copy(), device=dev)
        FeatureDistributionMatching().match(
            im, Image.from_numpy(tgt.copy(), device=dev))
        if dev != "cpu":
            card = im.to_numpy()
    assert np.array_equal(card, im.to_numpy())
    edges = (_u8((80, 80), 83, "cpu") > 230).to(torch.uint8) * 255
    assert np.array_equal(HoughTransform(80).compute(edges.to(cuda)),
                          HoughTransform(80).compute(edges))
    a = [BinaryDescriptor(r) for r in _u8((300, 32), 84, "cpu").numpy()]
    b = [BinaryDescriptor(r) for r in _u8((200, 32), 85, "cpu").numpy()]
    cm = BruteForceMatcher(cross_check=True, device=cuda)
    hm = BruteForceMatcher(cross_check=True, device="cpu")
    assert [(m.query_idx, m.train_idx, m.distance) for m in cm.match(a, b)] \
        == [(m.query_idx, m.train_idx, m.distance) for m in hm.match(a, b)]


def test_pca_arrays_on_the_card_within_bound_of_the_cpu(cuda):
    from zignal_tpu_torch import PCA

    x = torch.rand((64, 80, 5), generator=torch.Generator().manual_seed(3))
    p, c = PCA(), PCA()
    p.fit_array(x.to(cuda), 3)
    c.fit_array(x, 3)
    np.testing.assert_allclose(p.eigenvalues, c.eigenvalues, rtol=1e-5)
    proj = p.transform_array(x.to(cuda))
    assert proj.device.type == "cuda"
    assert torch.get_float32_matmul_precision() == "highest"


# -- colormaps, flood fill, Perlin noise, QR and the terminal on the card -----

def test_colormaps_on_the_card_equal_the_cpu(cuda):
    """A true division by a range tensor on the card (no reciprocal), the
    f32 reciprocal of a fixed range where the batch asks for it: every
    index is the CPU's."""
    from zignal_tpu_torch import Colormap, Image

    x = _u8((3, 70, 90, 3), 90, "cpu")
    x[0] = x[0] % 51
    for name in ("jet", "heat", "turbo", "viridis", "inferno"):
        for lo, hi in ((None, None), (13, 200), (0, 50)):
            cm = Colormap(name, lo, hi)
            got = ImageBatch(x, device=cuda).apply_colormap(cm)
            want = ImageBatch(x, device="cpu").apply_colormap(cm)
            assert got.device.type == "cuda"
            assert torch.equal(got.device_array().cpu(), want.device_array())
            img = Image.from_numpy(x[0].numpy().copy(), device=cuda)
            assert img.apply_colormap(cm).device.type == "cuda"
            assert np.array_equal(
                img.apply_colormap(cm).to_numpy(),
                Image.from_numpy(x[0].numpy().copy(), device="cpu")
                .apply_colormap(cm).to_numpy())


def test_flood_fill_on_the_card_equals_the_cpu(cuda):
    from zignal_tpu_torch import Image
    from zignal_tpu_torch.ops import flood_fill as ff

    x = (_u8((2, 64, 80, 3), 91, "cpu") // 64) * 64
    for neighbor in (False, True):
        for conn in (4, 8):
            got = ff.flood_region(x.to(cuda), 5, 7, 2, conn, neighbor)
            want = ff.flood_region(x, 5, 7, 2, conn, neighbor)
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
            out = ImageBatch(x, device=cuda).flood_fill(5, 7, (1, 2, 3), 1.5,
                                                        conn, int(neighbor))
            ref = ImageBatch(x, device="cpu").flood_fill(5, 7, (1, 2, 3),
                                                         1.5, conn,
                                                         int(neighbor))
            assert torch.equal(out.device_array().cpu(), ref.device_array())
    img = Image.from_numpy(x[0].numpy().copy(), device=cuda)
    cpu = Image.from_numpy(x[0].numpy().copy(), device="cpu")
    img.flood_fill(0, 0, (9, 9, 9), 10.0, 8)
    cpu.flood_fill(0, 0, (9, 9, 9), 10.0, 8)
    assert np.array_equal(img.to_numpy(), cpu.to_numpy())


def test_perlin_array_on_the_card_equals_the_cpu(cuda):
    from zignal_tpu_torch import perlin_array

    yy, xx = np.mgrid[0:128, 0:96].astype(np.float32) * 0.37
    got = perlin_array(xx, yy, 0.5, octaves=4, frequency=0.1, device=cuda)
    want = perlin_array(xx, yy, 0.5, octaves=4, frequency=0.1, device="cpu")
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_qr_binarize_on_the_card_equals_the_cpu(cuda):
    from zignal_tpu_torch import Image, qrcode_decode, qrcode_encode
    from zignal_tpu_torch.qrcode import decoder

    code = qrcode_encode("on the card", module_size=3, device="cpu")
    plane = torch.from_numpy(code.to_numpy()[..., 0].copy())
    assert np.array_equal(decoder._binarize(plane.to(cuda)),
                          decoder._binarize(plane))
    blank = torch.full((64, 64), 255, dtype=torch.uint8)  # the Otsu branch
    assert np.array_equal(decoder._binarize(blank.to(cuda)),
                          decoder._binarize(blank))
    img = Image.from_numpy(code.to_numpy().copy(), device=cuda)
    got, want = qrcode_decode(img), qrcode_decode(code)
    assert got.text == want.text == "on the card"
    assert got.corners == want.corners


def test_kitty_scaling_launches_k1_once(cuda):
    from zignal_tpu_torch import Image
    from zignal_tpu_torch.terminal import kitty_from_image

    arr = np.random.default_rng(92).integers(0, 256, (96, 128, 3), np.uint8)
    img = Image.from_numpy(arr, device=cuda)
    before = (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES)
    got = kitty_from_image(img, width=64)
    assert (fp.LAUNCHES, fc.LAUNCHES, cc.LAUNCHES, sc.LAUNCHES) == \
        (before[0] + 1,) + before[1:]
    assert got == kitty_from_image(
        Image.from_numpy(arr.copy(), device="cpu"), width=64)


# -- the CLI and the optimizer on the card ------------------------------------

def _cli_outputs(tmp_path, device, argv):
    """Run the port's CLI on ``device`` with ``{out}`` a directory of its
    own; returns the (K1, K4) launches and {file name: bytes}."""
    from zignal_tpu_torch.cli.main import main

    out = tmp_path / device
    before = (fp.LAUNCHES, sc.LAUNCHES)
    assert main(["--device", device] + [str(out) + "/" if a == "{out}"
                                        else a for a in argv]) == 0
    torch.cuda.synchronize()
    launches = (fp.LAUNCHES - before[0], sc.LAUNCHES - before[1])
    return launches, {p.name: p.read_bytes() for p in sorted(out.iterdir())}


@pytest.fixture
def photos(tmp_path):
    from zignal_tpu_torch import Image

    rng = np.random.default_rng(93)
    paths = []
    for k, (h, w) in enumerate(((120, 160), (97, 131), (64, 64))):
        paths.append(str(tmp_path / f"in{k}.png"))
        Image.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8),
                         device="cpu").save(paths[-1])
    return paths


@pytest.mark.parametrize("argv,launches", [
    (["resize", "--scale", "0.5"], (3, 0)),
    (["resize", "--width", "50", "--filter", "lanczos"], (0, 0)),
    (["blur", "--type", "gaussian", "--sigma", "2"], (0, 3)),
    (["blur", "--type", "median", "--radius", "2"], (0, 0)),
], ids=["resize-bilinear", "resize-lanczos", "blur-gaussian", "blur-median"])
def test_cli_on_the_card_equals_the_cpu_and_launches_k1_k4(
        cuda, tmp_path, photos, argv, launches):
    argv = argv[:1] + photos + argv[1:] + ["-o", "{out}"]
    got, on_card = _cli_outputs(tmp_path, "cuda", argv)
    assert got == launches
    assert on_card == _cli_outputs(tmp_path, "cpu", argv)[1]


def test_cli_pipeline_on_the_card_equals_the_cpu(cuda, tmp_path, photos):
    recipe = tmp_path / "recipe.zon"
    recipe.write_text(".{ .steps = .{ .{ .resize = .{ .scale = 0.5 } }, "
                      ".{ .blur = .{ .type = .gaussian, .sigma = 2.0 } }, "
                      ".{ .edges = .{ .filter = .sobel } } } }")
    argv = ["pipeline", str(recipe)] + photos + ["-o", "{out}"]
    got, on_card = _cli_outputs(tmp_path, "cuda", argv)
    assert got == (3, 3)
    assert on_card == _cli_outputs(tmp_path, "cpu", argv)[1]


def test_global_optimizer_tell_takes_a_cuda_tensor(cuda):
    from zignal_tpu_torch import GlobalOptimizer

    runs = []
    for on_card in (True, False):
        opt = GlobalOptimizer([(-5, 5), (-5, 5)], seed=7,
                              num_random_samples=400)
        for _ in range(6):
            X = opt.ask(8)
            Y = ((torch.tensor(X, dtype=torch.float64, device=cuda) - 1.5)
                 ** 2).sum(dim=1)
            opt.tell(X, Y if on_card else Y.cpu().numpy())
        runs.append((opt.best(), opt.num_evaluations))
    assert runs[0] == runs[1]
    assert runs[0][1] == 48


@pytest.fixture
def nccl_mesh(cuda):
    """A 1-D mesh of this process's card (a process group of one on
    NCCL), torn down after the test."""
    import torch.distributed as dist

    from zignal_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device="cuda")
    yield mesh
    dist.destroy_process_group()


def test_mesh_of_one_card_runs_nccl_and_k1_k4(nccl_mesh):
    """The mesh paths on a 1-rank NCCL mesh equal the same calls without a
    mesh, and reach K1 and K4."""
    import torch.distributed as dist

    from zignal_tpu_torch import parallel as P
    from zignal_tpu_torch.ops.convolution import gaussian_blur

    assert dist.get_backend() == "nccl"
    img = _u8((256, 192, 3), 3, "cuda")
    for border in BorderMode:
        before = sc.LAUNCHES
        got = P.spatial_gaussian_blur(nccl_mesh, 2.0, border)(img)
        assert sc.LAUNCHES > before
        assert torch.equal(got.to_local(), gaussian_blur(img, 2.0, border))
    batch = _u8((4, 128, 128, 3), 4, "cuda")
    before = fp.LAUNCHES
    got = P.sharded_pipeline(nccl_mesh, 64, 64, 2.0)(batch)
    assert fp.LAUNCHES == before + 1
    assert torch.equal(got.to_local(),
                       pipeline.resize_blur_oklab(batch, 64, 64, 2.0))
    b = ImageBatch(batch, mesh=nccl_mesh)
    assert torch.equal(b.resize_blur_oklab((64, 64)).to_local(),
                       ImageBatch(batch, device="cuda")
                       .resize_blur_oklab((64, 64)))
    mesh2 = P.make_mesh((1, 1), ("batch", "space"), device="cuda")
    b2 = ImageBatch(batch, mesh=mesh2)
    plain = ImageBatch(batch, device="cuda")
    for name, args in (("gaussian_blur", (1.5,)), ("box_blur", (2,)),
                       ("equalize", ()), ("median_blur", (1,))):
        assert torch.equal(getattr(b2, name)(*args).device_array()
                           .to_local(),
                           getattr(plain, name)(*args).device_array())


def test_measure_of_k1_is_within_2x_of_cuda_events(cuda):
    """profiling.measure times a card's output with CUDA events: K1 at B=4
    of 1024^2 -> 512^2 sigma 2, against events around 20 calls."""
    from zignal_tpu_torch.profiling import measure

    x = _u8((4, 1024, 1024, 3), 0, cuda)

    def call():
        return fp.fused_resize_blur_oklab(x, 512, 512, 2.0)

    before = fp.LAUNCHES
    secs, gpix = measure(call, pixels=4 * 1024 * 1024)
    assert fp.LAUNCHES > before
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    stop.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(stop) / 1e3 / 20
    assert 0 < secs and events / 2 <= secs <= 2 * events, (secs, events)
    assert gpix == 4 * 1024 * 1024 / secs / 1e9


def test_trace_holds_k1s_kernel_event(cuda, tmp_path):
    import json

    from zignal_tpu_torch.profiling import trace

    x = _u8((2, 256, 256, 3), 0, cuda)
    with trace(tmp_path):
        fp.fused_resize_blur_oklab(x, 128, 128, 2.0)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "resize_blur_kernel" in e.get("name", "")]
    assert kernels and kernels[0]["dur"] > 0
    assert kernels[0]["args"]["device"] == torch.cuda.current_device()


# the spans one call of each entry records on the card, in the order they
# end: the wrapper's stages one after the other (a new shape's plan built
# inside K*.plan), then the launch, then the entry
_STAGES = ("check", "plan_build", "plan", "alloc", "params")


def _call_spans(kernel, entry, built):
    stages = [f"{kernel}.{s}" for s in _STAGES if built or s != "plan_build"]
    return stages + ["launch", entry]


@pytest.mark.parametrize("entry", ["filter_chain", "resize_blur_oklab"])
def test_recorder_holds_each_calls_stages_on_the_card(cuda, entry):
    from torch.profiler import ProfilerActivity, profile

    from zignal_tpu_torch.profiling import RECORDER

    if entry == "filter_chain":  # shapes and sigmas no other test plans
        kernel, x, args = "K2", _u8((1, 97, 83), 5, cuda), (1.7, 3, 100.0)
    else:
        kernel, x, args = "K1", _u8((1, 71, 89, 3), 5, cuda), (37, 41, 1.3)
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            getattr(pipeline, entry)(x, *args)
        torch.cuda.synchronize()
    spans = RECORDER.spans
    assert [s[0] for s in spans] == (_call_spans(kernel, entry, True)
                                     + _call_spans(kernel, entry, False))
    for call in (spans[:7], spans[7:]):
        by = {name: (t0, t1) for name, t0, t1, _ in call}
        stages = [by[f"{kernel}.{s}"] for s in ("check", "plan", "alloc",
                                                 "params")]
        # stamped at the stage boundaries: each starts where the last ended
        assert all(a[1] == b[0] for a, b in zip(stages, stages[1:]))
        assert by[entry][0] <= stages[0][0]
        assert stages[-1][1] <= by["launch"][0] <= by["launch"][1] \
            <= by[entry][1]
    built = spans[1]
    assert spans[2][1] <= built[1] <= built[2] <= spans[2][2]


def test_trace_launch_spans_enclose_their_kernels_launch_call(cuda,
                                                              tmp_path):
    import json

    from zignal_tpu_torch.profiling import trace

    x = _u8((1, 256, 256), 6, cuda)
    pipeline.filter_chain(x)
    with trace(tmp_path):
        for _ in range(100):
            pipeline.filter_chain(x)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    # K2's launch is the only kernel launch of a filter_chain call (a
    # session's first kernel events can drop out; the runtime calls stay)
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "LaunchKernel" in e.get("name", "")]
    spans = [e for e in events if e.get("cat") == "zignal"
             and e["name"] == "launch"]
    assert len(spans) == 100 and len(calls) >= 100
    enclosing = sum(any(s["ts"] <= c["ts"] and c["ts"] + c["dur"]
                        <= s["ts"] + s["dur"] for c in calls)
                    for s in spans)
    assert enclosing >= 99, enclosing


def test_entry_runs_on_the_card_as_returned(cuda):
    from zignal_tpu_torch.entry import entry

    fn, args = entry()
    assert args[0].device.type == "cuda" and args[0].dtype == torch.uint8
    before = fp.LAUNCHES
    got = fn(*args)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    want = fp.fused_resize_blur_oklab_reference(args[0], 128, 128, 1.5)
    assert float((got - want).abs().max()) <= OKLAB_TOL


def test_bench_smoke_on_the_card_checks_and_launches(cuda, capsys):
    import json

    from zignal_tpu_torch import bench

    assert bench.main(["--smoke"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    configs = lines[:-1]
    assert [x["metric"] for x in configs] == \
        [bench._METRIC_NAMES[n] for n in bench._CONFIGS]
    assert all(x["value"] > 0 and x["device"] != "cpu" for x in configs)
    for k in ("K1", "K2", "K3", "K4"):
        assert sum(x["launches"][k] for x in configs) >= 1, k


# -- equalize: the histogram, tables and lookup kernels (csrc/equalize_u8.cu)


def _frames(shape, seed, device):
    """Camera-like u8 frames: a smooth scene under a gamma, with grain of
    +-6, so a warp's lanes crowd a few histogram bins."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    phase = rng.random((b, 1, 1, c)) * 6
    s = 0.5 + 0.5 * np.sin(3 * x + 2 * y + phase)
    v = np.round(16 + 128 * s ** 1.8) + rng.integers(-6, 7, (b, h, w, c))
    return torch.from_numpy(np.clip(v, 0, 255).astype(np.uint8)).to(device)


def _check_equalize(x, skip_alpha=True):
    """The kernels' histograms and equalized bytes equal the plain ones."""
    before = (eb.HIST_LAUNCHES, eb.LUT_LAUNCHES, en.TABLE_LAUNCHES)
    hists = eb.histogram256_batch(x)
    got = en.equalize(x, skip_alpha)
    torch.cuda.synchronize()
    assert (eb.HIST_LAUNCHES, eb.LUT_LAUNCHES, en.TABLE_LAUNCHES) == tuple(
        n + k for n, k in zip(before, (2, 1, 1)))
    assert hists.dtype == torch.int32
    assert torch.equal(hists, eb.histogram256_batch_reference(x))
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, en.equalize_reference(x, skip_alpha))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("skip_alpha", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_equalize_kernels_equal_plain(cuda, c, skip_alpha, b):
    _check_equalize(_frames((b, 480, 640, c), 40 + c, cuda), skip_alpha)
    _check_equalize(_u8((b, 97, 131, c), 41 + c, cuda), skip_alpha)


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (3, 7), (17, 29), (33, 171),
                                (255, 257), (1000, 999)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("c", [1, 3, 4])
def test_equalize_kernels_at_ragged_tails_equal_plain(cuda, c, hw):
    """Images whose bytes are no whole number of chunks (512 * C) or of
    16-byte vectors, so each image of a batch starts at another offset."""
    for b in (1, 3):
        _check_equalize(_frames((b, *hw, c), 42, cuda))


@pytest.mark.parametrize("offset", [1, 3, 8, 13])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_equalize_kernels_on_unaligned_views_equal_plain(cuda, c, offset):
    shape = (2, 301, 403, c)
    base = _frames((1, 1, 2 * 301 * 403 * c + 16, 1), 43, cuda).reshape(-1)
    x = base[offset:offset + 2 * 301 * 403 * c].view(shape)
    assert x.data_ptr() % 16 == offset % 16
    _check_equalize(x)
    luts = _u8((2, c, 256), 44, cuda)
    assert torch.equal(eb.lut_apply_u8_per_channel(x, luts),
                       eb.lut_apply_u8_per_channel_reference(x, luts))


def test_equalize_kernels_take_strided_input(cuda):
    x = _frames((2, 200, 300, 3), 45, cuda)[:, ::2, 1:]
    assert not x.is_contiguous()
    _check_equalize(x)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_equalize_kernels_on_one_and_two_values_equal_plain(cuda, c):
    """One value: every lane on one bin, denom 0, the identity table;
    then two values."""
    x = torch.full((2, 1024, 768, c), 77, dtype=torch.uint8, device=cuda)
    _check_equalize(x)
    assert torch.equal(en.equalize(x), x)
    x[:, ::3] = 200
    x[1, :, ::5] = 0
    _check_equalize(x)


def test_equalize_kernels_wrap_as_the_reference_u32(cuda):
    """4352^2 = 18.9 Mpix in one channel: (cdf - cdf_min) * 255 passes
    2^32, and the tables wrap as the reference's u32 arithmetic does."""
    x = _frames((1, 4352, 4352, 1), 46, cuda)
    _check_equalize(x)
    hists = eb.histogram256_batch(x).to(torch.int64)
    cdf = hists.cumsum(-1)
    cdf_min = cdf[cdf > 0][0]
    assert int(((cdf - cdf_min) * 255).max()) >= 1 << 32


def test_equalize_from_hists_made_elsewhere(cuda):
    """Histograms summed over two halves of each image, as the mesh sums
    its ranks', in int32 and int64 and from the CPU, give the tables of
    the whole image."""
    x = _frames((2, 600, 800, 3), 47, cuda)
    top, bottom = x[:, :300], x[:, 300:]
    hists = eb.histogram256_batch(top) + eb.histogram256_batch(bottom)
    want = en.equalize_reference(x)
    for h in (hists, hists.to(torch.int64), hists.cpu().to(cuda)):
        got = torch.cat([en.equalize_from_hists(part, h, 600 * 800)
                         for part in (top, bottom)], dim=1)
        assert torch.equal(got, want)
    single = en.equalize_from_hists(x[1, :300], hists[1], 600 * 800, False)
    assert torch.equal(single, en.equalize_reference(x[1:], False)[0, :300])


@pytest.mark.parametrize("c", [1, 3, 4])
def test_lut_kernel_equals_plain(cuda, c):
    """Any tables, per image or one set for one image."""
    x = _u8((3, 77, 91, c), 48, cuda)
    luts = _u8((3, c, 256), 49, cuda)
    before = eb.LUT_LAUNCHES
    got = eb.lut_apply_u8_per_channel(x, luts)
    one = eb.lut_apply_u8_per_channel(x[1], luts[1])
    torch.cuda.synchronize()
    assert eb.LUT_LAUNCHES == before + 2
    assert torch.equal(got, eb.lut_apply_u8_per_channel_reference(x, luts))
    assert torch.equal(one, got[1])


def test_equalize_kernels_refuse_other_channel_counts(cuda):
    x = _u8((1, 16, 16, 2), 50, cuda)
    with pytest.raises(ValueError, match="C in"):
        eb.histogram256_batch(x)
    with pytest.raises(ValueError, match="C in"):
        eb.lut_apply_u8_per_channel(x, _u8((1, 2, 256), 51, cuda))


@pytest.mark.parametrize("shape,low,high", [
    ((3, 61, 97), 0.3, 0.7), ((1, 1, 300), 0.2, 0.9), ((2, 300, 1), 0.5, 0.5),
    ((4, 33, 40), 0.8, 0.2), ((2, 128, 128), 0.05, 0.95)])
def test_hysteresis_kernel_equals_plain(cuda, shape, low, high):
    """The union-find kernel against the plain growth on random
    candidates and magnitudes, thresholds either way round; each plane's
    components stay their own."""
    from zignal_tpu_torch.ops import edges, hysteresis

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    cand = torch.rand(shape, generator=g, device=cuda) < 0.6
    mag = torch.rand(shape, generator=g, device=cuda)
    before = hysteresis.LAUNCHES
    got = hysteresis.hysteresis_u8(cand, mag, low, high)
    want = edges._hysteresis(cand, mag, low, high).to(torch.uint8) * 255
    torch.cuda.synchronize()
    assert hysteresis.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_canny_on_the_card_equals_the_cpu(cuda):
    """A road-like plane with a long fading edge: the card's Canny (the
    kernel's hysteresis) against the CPU's plain growth."""
    from zignal_tpu_torch.ops import edges

    x = torch.full((2, 120, 400), 60.0)
    x[:, 40:44, 10:390] += torch.linspace(160, 30, 380)
    x += torch.randint(0, 6, x.shape, generator=torch.Generator()
                       .manual_seed(8))
    assert torch.equal(edges.canny(x.to(cuda)).cpu(), edges.canny(x))


@pytest.mark.parametrize("shape", [(2, 45, 70), (1, 3, 200), (3, 130, 2),
                                   (1, 1, 9), (2, 97, 33)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.4, 3.0])
def test_canny_front_kernel_equals_plain(cuda, shape, sigma):
    """The blur, Sobel, magnitude and NMS kernel against the plain route's
    stages on the card, at tile edges and on axes shorter than the blur."""
    from zignal_tpu_torch.ops import canny_front, edges
    from zignal_tpu_torch.ops.convolution import gradient_magnitude, \
        sobel_gradients

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randint(0, 256, shape, generator=g, device=cuda).float()
    mag, mask = canny_front.front(x, sigma)
    s = x
    if sigma > 0:
        k = tables.gaussian_kernel(sigma)
        s = convolve_separable(x[..., None], k, k, BorderMode.MIRROR)[..., 0]
    gx, gy = sobel_gradients(s, BorderMode.REPLICATE)
    want = gradient_magnitude(gx, gy)
    assert torch.equal(mag, want)
    assert torch.equal(mask, edges._quantized_nms(gx, gy, want))


@pytest.mark.parametrize("planes,size", [((3, 40, 70), 64), ((2, 70, 40), 256),
                                         ((1, 376, 1241), 1024),
                                         ((2, 64, 64), 64), ((2, 50, 90), 37),
                                         ((1, 200, 300), 2048)])
def test_hough_kernels_equal_plain(cuda, planes, size):
    """The vote kernel against the plain votes on the card, at 16, 8 and 4
    thetas a block and a last block short of its thetas; the lines kernel
    against ``find_lines``' own on the host."""
    from zignal_tpu_torch.enums import Interpolation
    from zignal_tpu_torch.ops import hough

    g = torch.Generator(device=cuda).manual_seed(size)
    e = (torch.rand(planes, generator=g, device=cuda) < 0.02).to(
        torch.uint8) * 255
    e[:, planes[1] // 2, :] = 255
    ht = hough.HoughTransform(size)
    acc = ht.compute_batch(e)
    p = e if planes[1:] == (size, size) else resize(
        e[..., None], size, size, Interpolation.NEAREST)[..., 0]
    assert torch.equal(acc, hough._vote(p, size))
    for threshold in (5, 20):
        for max_lines in (3, 32):
            got = ht.find_lines_tensors(acc, threshold, 4.0, 8.0, max_lines)
            want = ht.find_lines_tensors(acc.cpu(), threshold, 4.0, 8.0,
                                         max_lines)
            assert int(want[1].sum()) > 0
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])


def test_lane_hough_request_at_kitti_size_waits_for_nothing(cuda):
    """One lane_hough request of 8 road frames of 1241 x 376 (Canny, then
    the Hough lines at 1024) after a warm-up call issues no host-device
    synchronization; it launches each of the front, hysteresis, vote and
    lines kernels once and votes 8 frames, and equals the same request on
    the CPU."""
    from benchmarks.sources import device_road
    from zignal_tpu_torch.ops import canny_front, edges, hough, \
        hough_kernels, hysteresis

    gen = torch.Generator().manual_seed(2 ** 35 + 7)
    x = device_road.frames((8, 376, 1241), gen, torch.device("cpu"))
    ht = hough.HoughTransform(1024)

    def request(planes):
        e = edges.canny(planes.to(torch.float32), 1.4, 50.0, 150.0)
        return (e,) + ht.lines_batch(e, 100, 5.0, 10.0, 32)

    card = x.to(cuda)
    request(card)
    torch.cuda.synchronize()
    counters = ((canny_front, "LAUNCHES"), (hysteresis, "LAUNCHES"),
                (hough_kernels, "VOTE_LAUNCHES"),
                (hough_kernels, "LINES_LAUNCHES"), (hough, "FRAMES"),
                (edges, "HYSTERESIS_TESTS"))
    before = [getattr(m, n) for m, n in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = request(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [getattr(m, n) - b for (m, n), b in zip(counters, before)] == \
        [1, 1, 1, 1, 8, 0]
    want = request(x)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert int(want[3].sum()) > 8


def test_the_lane_path_on_a_card_refuses_what_its_kernels_cannot_take(cuda):
    """No plain route on a card: Canny of a plane that is not f32 or with
    a blur wider than the front kernel's, and lines past the lines
    kernel's count or of an accumulator that is not int32, raise; an
    accumulator with no interior has no line."""
    from zignal_tpu_torch.ops import edges, hough

    x = torch.zeros((1, 20, 30), device=cuda)
    with pytest.raises(ValueError, match="f32"):
        edges.canny(x.double())
    with pytest.raises(ValueError, match="taps"):
        edges.canny(x, sigma=6.0)
    ht = hough.HoughTransform(16)
    acc = torch.zeros((1, 16, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="lines"):
        ht.find_lines_tensors(acc, 1, max_lines=257)
    with pytest.raises(ValueError, match="int32"):
        ht.find_lines_tensors(acc.long(), 1)
    rows, valid = hough.HoughTransform(2).find_lines_tensors(
        torch.ones((1, 2, 2), dtype=torch.int32, device=cuda), 1)
    assert rows.device.type == "cuda" and not bool(valid.any())


# -- device spans: the stages' time on the card (profiling.RECORDER) --------

ORB_STAGES = ("orb.pyramid", "orb.detect", "orb.select", "orb.describe")
# the stages whose device spans each request records, in order
STAGES = {"stereo": ORB_STAGES + ("match",), "lane": ("canny", "hough")}


def _stage_request(kind, device):
    """The stereo request (ORB of 8 frames of 1241 x 376, then each left
    frame matched with its right) or the lane request (Canny, then the
    Hough lines at 1024) on ``device``, as the benchmark's cells issue
    them."""
    gen = torch.Generator().manual_seed(2 ** 33 + 29)
    if kind == "stereo":
        from zignal_tpu_torch.features import matcher

        x = torch.randint(0, 256, (8, 376, 1241), generator=gen,
                          dtype=torch.uint8)
        x[:, 100:250, 300:900] //= 4
        x, det = x.to(device), Orb(n_features=2000, edge_threshold=31)

        def request():
            kps, desc, valid = det.detect_and_compute_tensors(x)
            return matcher.match_tensors(desc[0::2], valid[0::2],
                                         desc[1::2], valid[1::2])

        return request
    from benchmarks.sources import device_road
    from zignal_tpu_torch.ops import edges, hough

    x = device_road.frames((8, 376, 1241), gen, torch.device("cpu"))
    x, ht = x.to(device), hough.HoughTransform(1024)

    def request():
        e = edges.canny(x.to(torch.float32), 1.4, 50.0, 150.0)
        return ht.lines_batch(e, 100, 5.0, 10.0, 32)

    return request


@pytest.mark.parametrize("kind", ["stereo", "lane"])
def test_a_request_under_a_session_gives_its_device_spans_in_order(cuda,
                                                                  kind):
    """One request in a session: its host spans as before, then at the
    stop one ``@device`` span a stage, in the stages' order, on the
    recording thread; ORB's four share their boundaries; each stage starts
    on the card no earlier than the last one ended and lasts longer than
    nothing. Outside a session no device span is kept."""
    from torch.profiler import ProfilerActivity, profile

    from zignal_tpu_torch.profiling import RECORDER

    request, stages = _stage_request(kind, cuda), STAGES[kind]
    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        request()
        assert RECORDER.device and not any(
            s[0].endswith("@device") for s in RECORDER.spans)
    device = [s for s in RECORDER.spans if s[0].endswith("@device")]
    host = [s for s in RECORDER.spans if not s[0].endswith("@device")]
    assert [s[0] for s in device] == [f"{s}@device" for s in stages]
    assert set(stages) <= {s[0] for s in host}
    assert RECORDER.spans[-len(device):] == device and RECORDER.dropped == 0
    assert {s[3] for s in device} == {s[3] for s in host}
    for a, b in zip(device, device[1:]):
        assert a[1] < a[2] <= b[1]
        if {a[0].removesuffix("@device"),
                b[0].removesuffix("@device")} <= set(ORB_STAGES):
            assert a[2] == b[1]
    request()
    torch.cuda.synchronize()
    assert RECORDER.spans[-len(device):] == device  # nothing kept after
    assert RECORDER.device == []


def _trace_requests(kind, log_dir):
    """``profiling.trace`` of three requests of ``kind`` into ``log_dir``
    after a warm-up call, in this process."""
    from zignal_tpu_torch.profiling import trace

    request = _stage_request(kind, torch.device("cuda"))
    request()
    torch.cuda.synchronize()
    with trace(log_dir):
        for _ in range(3):
            request()


def _device_ops(events) -> dict:
    """The trace's device operations by correlation id."""
    return {e["args"]["correlation"]: e for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "correlation" in e.get("args", {})}


def _runtime_calls(events) -> list:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cuda_runtime", "cuda_driver")]


def _traced_in_a_fresh_process(kind, log_dir, attempts=3):
    """The events of ``_trace_requests(kind)`` run in a process of its
    own, whose first profiler session it is: kernel events have been seen
    to drop out of sessions opened long after a process's first one. A
    trace that puts a device operation before its own runtime call (the
    profiler's card clock off the host's: 0.07-2 ms in some sessions) is
    no yardstick, and is taken again in a new process."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, "
            f"{str(here.parent)!r}]; import test_torch_kernels as t; "
            f"t._trace_requests({kind!r}, {str(log_dir)!r})")
    early = []
    for _ in range(attempts):
        subprocess.run([sys.executable, "-c", code], check=True,
                       timeout=600, cwd=here.parent)
        (path,) = Path(log_dir).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        ops = _device_ops(events)
        early = [c["ts"] - ops[c["args"]["correlation"]]["ts"]
                 for c in _runtime_calls(events)
                 if c.get("args", {}).get("correlation") in ops
                 and ops[c["args"]["correlation"]]["ts"] < c["ts"]]
        if not early:
            return events
    raise AssertionError(f"{attempts} traces put device operations before "
                         f"their runtime calls, by up to {max(early)} us")


@pytest.mark.parametrize("kind", ["stereo", "lane"])
def test_trace_device_spans_enclose_their_stages_device_ops(cuda, kind,
                                                           tmp_path):
    """In a ``profiling.trace`` file, each stage's device span encloses,
    within 10 us at each end, the device operations whose runtime calls
    lie inside the stage's host span (paired by the trace's correlation
    ids): 99 % of them or more, and every stage has some. The device
    spans lie on a track of their own."""
    events = _traced_in_a_fresh_process(kind, tmp_path)
    calls, ops = _runtime_calls(events), _device_ops(events)
    zignal = [e for e in events if e.get("cat") == "zignal"]
    checked, outside = 0, []
    for stage in STAGES[kind]:
        host = sorted((e for e in zignal if e["name"] == stage),
                      key=lambda e: e["ts"])
        device = sorted((e for e in zignal if e["name"] == f"{stage}@device"),
                        key=lambda e: e["ts"])
        assert len(host) == len(device) == 3, stage
        assert {e["tid"] for e in device}.isdisjoint(e["tid"] for e in host)
        for h, d in zip(host, device):
            mine = [ops[c["args"]["correlation"]] for c in calls
                    if h["ts"] <= c["ts"]
                    and c["ts"] + c["dur"] <= h["ts"] + h["dur"]
                    and c.get("args", {}).get("correlation") in ops]
            assert mine, stage
            checked += len(mine)
            # how far each op starts before the span or ends after it
            outside += [(stage, d["ts"] - op["ts"],
                         op["ts"] + op["dur"] - d["ts"] - d["dur"])
                        for op in mine if not (
                            d["ts"] - 10 <= op["ts"] and op["ts"] + op["dur"]
                            <= d["ts"] + d["dur"] + 10)]
    assert len(outside) <= 0.01 * checked, (checked, outside)
