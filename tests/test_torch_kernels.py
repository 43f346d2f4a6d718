"""The CUDA kernels against their plain PyTorch versions on the card. A
CUDA kernel has no CPU mode, so every test here needs a device and skips
without one. On a GPU machine (no jax needed):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from zignal_tpu_torch import BorderMode, Gray, ImageBatch, pipeline
from zignal_tpu_torch.color import convert_chain
from zignal_tpu_torch.ops import color_chain as cc
from zignal_tpu_torch.ops import filter_chain as fc
from zignal_tpu_torch.ops import fused_pipeline as fp
from zignal_tpu_torch.ops import separable_conv as sc
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.convolution import convolve_separable, \
    convolve_separable_reference
from zignal_tpu_torch.ops.interpolation import resize

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
    monkeypatch.setattr(fp, "_TABLES", {})
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
    monkeypatch.setattr(fc, "_TABLES", {})
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

    monkeypatch.setattr(fc, "_TABLES", {})
    monkeypatch.setattr(fc, "sums_fit_f32", lambda *a: False)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    x = _u8((2, 300, 200), 6, cuda)
    got = fc.fused_blur_sharpen_morph(x, 2.0, 3, 128.0)
    assert torch.equal(got, fc.fused_blur_sharpen_morph_reference(x, 2.0, 3,
                                                                  128.0))


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
    monkeypatch.setattr(sc, "_TABLES", {})
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
    table = cc.gamma_table(cuda)
    assert table.dtype == torch.float32 and table.shape == (256,)
    assert float((table.cpu() - cc.gamma_table("cpu")).abs().max()) <= 1e-5


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
