"""The port's plain CPU path against the JAX package on JAX-CPU: u8
stages array_equal, Oklab within 5e-6 (the bound of
tests/test_pallas_pipeline.py:40). Inputs come from numpy with a seed and
go to both packages as the same arrays."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu import pipeline as jax_pipeline
from zignal_tpu.color import convert_array as jax_convert
from zignal_tpu.ops.convolution import gaussian_blur as jax_blur
from zignal_tpu.ops.interpolation import resize as jax_resize
from zignal_tpu.pipeline import resize_blur_oklab as jax_rbo

import zignal_tpu_torch as zp
from zignal_tpu_torch import pipeline
from zignal_tpu_torch.color import convert_array
from zignal_tpu_torch.ops import fused_pipeline as fp
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.convolution import convolve_separable, \
    gaussian_blur
from zignal_tpu_torch.ops.interpolation import resize

OKLAB_TOL = 5e-6
REPO = Path(__file__).resolve().parent.parent

# the shapes of tests/test_pallas_pipeline.py scaled down to <= 2x256^2,
# plus an upscale whose blur radius is wider than an axis and 1-px axes
CASES = [  # (shape, out_rows, out_cols, sigma)
    ((2, 256, 256, 3), 128, 128, 2.0),
    ((1, 192, 256, 3), 96, 128, 2.0),
    ((1, 250, 200, 3), 64, 64, 2.0),
    ((1, 96, 128, 3), 64, 64, 0.5),
    ((1, 96, 128, 3), 64, 64, 1.0),
    ((1, 96, 128, 3), 64, 64, 3.5),
    ((1, 216, 192, 3), 72, 128, 1.5),
    ((1, 60, 102, 3), 30, 61, 1.5),
    ((2, 64, 64, 4), 25, 25, 1.5),
    ((2, 64, 64, 1), 25, 47, 1.5),
    ((1, 64, 64, 3), 80, 72, 1.5),
    ((2, 75, 100, 3), 32, 32, 0.0),
    ((1, 37, 53, 3), 100, 9, 3.5),
    ((2, 1, 64, 3), 3, 32, 1.0),
    ((2, 64, 1, 4), 31, 1, 2.0),
]
RGB_CASES = [c for c in CASES if c[0][-1] == 3]


def _ids(cases):
    return [f"{s[0]}x{s[1]}x{s[2]}x{s[3]}-{oh}x{ow}-s{sg}"
            for s, oh, ow, sg in cases]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape,oh,ow,sigma", CASES, ids=_ids(CASES))
def test_resize_matches_jax(shape, oh, ow, sigma):
    x = _u8(shape, 1)
    got = resize(torch.from_numpy(x), oh, ow).numpy()
    assert np.array_equal(got, np.asarray(jax_resize(x, oh, ow)))


@pytest.mark.parametrize("shape,oh,ow,sigma",
                         [c for c in CASES if c[3] > 0],
                         ids=_ids([c for c in CASES if c[3] > 0]))
def test_gaussian_blur_matches_jax(shape, oh, ow, sigma):
    x = _u8((shape[0], oh, ow, shape[3]), 2)
    got = gaussian_blur(torch.from_numpy(x), sigma).numpy()
    assert np.array_equal(got, np.asarray(jax_blur(x, sigma)))


@pytest.mark.parametrize("shape,oh,ow,sigma", CASES, ids=_ids(CASES))
def test_fused_reference_u8_matches_jax_stages(shape, oh, ow, sigma):
    x = _u8(shape, 3)
    got = fp.fused_resize_blur_oklab_reference(torch.from_numpy(x), oh, ow,
                                               sigma, oklab=False)
    want = jax_blur(jax_resize(x, oh, ow), sigma)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,oh,ow,sigma", RGB_CASES,
                         ids=_ids(RGB_CASES))
def test_image_batch_resize_blur_oklab_matches_jax(shape, oh, ow, sigma):
    x = _u8(shape, 4)
    got = zp.ImageBatch(x, device="cpu").resize_blur_oklab((oh, ow), sigma)
    want = np.asarray(jz.ImageBatch(x).resize_blur_oklab((oh, ow), sigma))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= OKLAB_TOL


@pytest.mark.parametrize("shape,oh,ow,sigma", CASES[:4], ids=_ids(CASES[:4]))
def test_pipeline_resize_blur_oklab_matches_jax(shape, oh, ow, sigma):
    x = _u8(shape, 5)
    got = pipeline.resize_blur_oklab(torch.from_numpy(x), oh, ow, sigma)
    want = np.asarray(jax_rbo(x, oh, ow, sigma))
    assert np.max(np.abs(got.numpy() - want)) <= OKLAB_TOL


@pytest.mark.parametrize("shape,oh,ow", [((2, 64, 64, 3), 32, 48),
                                         ((1, 37, 53, 4), 100, 9),
                                         ((2, 20, 30, 1), 20, 30)])
def test_image_batch_resize_matches_jax(shape, oh, ow):
    x = _u8(shape, 6)
    got = zp.ImageBatch(x, device="cpu").resize((oh, ow))
    want = jz.ImageBatch(x).resize((oh, ow))
    assert (got.rows, got.cols, got.channels) == (oh, ow, shape[3])
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_scale_factor_size_matches_jax():
    x = _u8((1, 50, 70, 3), 7)
    got = zp.ImageBatch(x, device="cpu").resize(0.37)
    want = jz.ImageBatch(x).resize(0.37)
    assert np.array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_convert_array_rgb_to_oklab_matches_jax(seed):
    rgb = np.random.default_rng(seed).random((2, 33, 17, 3), np.float32)
    rgb[0, 0, :3] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.5, 0.0031308]]
    got = convert_array(torch.from_numpy(rgb), "rgb", "oklab").numpy()
    want = np.asarray(jax_convert(rgb, "rgb", "oklab"))
    assert np.max(np.abs(got - want)) <= OKLAB_TOL


def test_convolve_separable_uneven_kernels_match_jax():
    from zignal_tpu.ops.convolution import convolve_separable as jax_sep

    x = _u8((2, 20, 24, 3), 8)
    kx, ky = (0.25, 0.5, 0.25), (0.1, 0.2, 0.4, 0.2, 0.1)
    got = convolve_separable(torch.from_numpy(x), kx, ky).numpy()
    assert np.array_equal(got, np.asarray(jax_sep(x, kx, ky)))


@pytest.mark.parametrize("shape,oh,ow,sigma,tile", [
    ((2, 64, 64, 3), 40, 24, 2.0, 8),
    ((1, 37, 53, 3), 100, 9, 3.5, 32),
    ((1, 37, 53, 4), 100, 9, 3.5, 8),
    ((2, 1, 64, 1), 3, 32, 1.0, 8),
    ((1, 50, 40, 3), 17, 33, 0.0, 8),
])
def test_kernel_tiling_reproduces_plain(shape, oh, ow, sigma, tile):
    """A numpy transcription of fused_kernel's index arithmetic: per
    output tile, resize tile + halo through the halo tables, width pass
    over every halo row, height pass, (acc + 32768) >> 16. It must give
    the plain version's u8 at ragged edge tiles and short axes, which
    checks the tables and tile bounds the CUDA kernel relies on."""
    x = _u8(shape, 9)
    b, h, w, c = shape
    r = tables.blur_radius(sigma)
    ty = tables.halo_axis_table(h, oh, r).astype(np.int64)
    tx = tables.halo_axis_table(w, ow, r).astype(np.int64)
    kint = (tables._kernel_to_int(tables.gaussian_kernel(sigma)) if r
            else np.ones(1, np.int32)).astype(np.int64)
    out = np.zeros((b, oh, ow, c), np.uint8)
    for y0 in range(0, oh, tile):
        for x0 in range(0, ow, tile):
            th, tw = min(tile, oh - y0), min(tile, ow - x0)
            ya, yb, fy = ty[:, y0:y0 + th + 2 * r]
            xa, xb, fx = tx[:, x0:x0 + tw + 2 * r]
            ya, yb, fy = ya[:, None], yb[:, None], fy[:, None, None]
            xa, xb, fx = xa[None, :], xb[None, :], fx[:, None]
            img = x.astype(np.int64)
            top = img[:, ya, xa] * (256 - fx) + img[:, ya, xb] * fx
            bot = img[:, yb, xa] * (256 - fx) + img[:, yb, xb] * fx
            res = np.minimum((top * (256 - fy) + bot * fy) >> 16, 255)
            if r == 0:
                out[:, y0:y0 + th, x0:x0 + tw] = res
                continue
            tmp = sum(kint[k] * res[:, :, k:k + tw] for k in range(2 * r + 1))
            acc = sum(kint[k] * tmp[:, k:k + th] for k in range(2 * r + 1))
            out[:, y0:y0 + th, x0:x0 + tw] = np.minimum(
                (acc + 32768) >> 16, 255)
    want = fp.fused_resize_blur_oklab_reference(torch.from_numpy(x), oh, ow,
                                                sigma, oklab=False)
    assert np.array_equal(out, want.numpy())


# the kernel's staged tile plans (ops/fused_pipeline.py:tile_plan) at the
# sizes of these tests: a main-path downscale, an upscale wider than its
# halo, RGBA, a 1-px axis, no blur, and channel groups (C = 2, 5)
PLAN_CASES = [  # (shape, out_rows, out_cols, sigma)
    ((2, 64, 64, 3), 40, 24, 2.0),
    ((1, 37, 53, 3), 100, 9, 3.5),
    ((1, 37, 53, 4), 100, 9, 3.5),
    ((2, 1, 64, 1), 3, 32, 1.0),
    ((1, 50, 40, 3), 17, 33, 0.0),
    ((3, 130, 70, 3), 65, 35, 1.5),
    ((2, 17, 19, 5), 9, 11, 1.0),
    ((2, 17, 19, 2), 9, 11, 0.0),
]


def _emulate_plan(x, oh, ow, sigma, tw, th, sms):
    """A numpy transcription of resize_blur_kernel over the host's plan:
    per tile, the source span it stages (or the whole image when the plan
    gathers), the tables as byte offsets into it, the resize, the int32
    width pass and the height pass with (acc + 32768) >> 16, for one
    channel group of at most 4 channels at a time."""
    b, h, w, cs = x.shape
    r = tables.blur_radius(sigma)
    ty = tables.halo_axis_table(h, oh, r)
    tx = tables.halo_axis_table(w, ow, r)
    monkey = fp.TILES
    fp.TILES = ((tw, th),)
    try:
        plan, sy, sx = fp.tile_plan(b, oh, ow, r, cs, False, ty, tx, sms)
    finally:
        fp.TILES = monkey
    kint = (tables._kernel_to_int(tables.gaussian_kernel(sigma)) if r
            else np.ones(1, np.int32)).astype(np.int64)
    out = np.zeros((b, oh, ow, cs), np.uint8)
    flat = x.reshape(b, -1).astype(np.int64)
    for z in range(b):
        for by in range(-(-oh // th)):
            for bx in range(-(-ow // tw)):
                y0, x0 = by * th, bx * tw
                cth, ctw = min(th, oh - y0), min(tw, ow - x0)
                ya, yb, fy = ty[:, y0:y0 + cth + 2 * r].astype(np.int64)
                xa, xb, fx = tx[:, x0:x0 + ctw + 2 * r].astype(np.int64)
                if plan.staged:
                    ylo, ny, xlo, nx = sy[0][by], sy[1][by], sx[0][bx], \
                        sx[1][bx]
                    assert ylo >= 0 and ylo + ny <= h and xlo >= 0 \
                        and xlo + nx <= w
                    for a in (ya, yb):
                        assert ((a >= ylo) & (a < ylo + ny)).all()
                    for a in (xa, xb):
                        assert ((a >= xlo) & (a < xlo + nx)).all()
                    soff = (xlo * cs) % 16
                    src = np.zeros((ny, plan.sp), np.int64)
                    assert soff + nx * cs <= plan.sp
                    src[:, soff:soff + nx * cs] = \
                        x[z, ylo:ylo + ny, xlo:xlo + nx].reshape(ny, -1)
                    assert ny * plan.sp <= plan.off_y - plan.off_x
                    src = src.ravel()
                    ra, rb = (ya - ylo) * plan.sp, (yb - ylo) * plan.sp
                    ca, cb = (xa - xlo) * cs + soff, (xb - xlo) * cs + soff
                else:
                    src = flat[z]
                    ra, rb, ca, cb = ya * w * cs, yb * w * cs, xa * cs, \
                        xb * cs
                for c in range(cs):
                    top = src[ra[:, None] + ca + c] * (256 - fx) \
                        + src[ra[:, None] + cb + c] * fx
                    bot = src[rb[:, None] + ca + c] * (256 - fx) \
                        + src[rb[:, None] + cb + c] * fx
                    res = np.minimum((top * (256 - fy[:, None])
                                      + bot * fy[:, None]) >> 16, 255)
                    if r:
                        t = sum(kint[k] * res[:, k:k + ctw]
                                for k in range(2 * r + 1))
                        acc = sum(kint[k] * t[k:k + cth]
                                  for k in range(2 * r + 1))
                        res = np.minimum((acc + 32768) >> 16, 255)
                    out[z, y0:y0 + cth, x0:x0 + ctw, c] = res
    return out, plan


@pytest.mark.parametrize("tile", fp.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shape,oh,ow,sigma", PLAN_CASES,
                         ids=_ids(PLAN_CASES))
def test_staged_tile_plan_reproduces_plain(shape, oh, ow, sigma, tile):
    """The kernel's staged source spans and local offsets, per tile of
    every tile shape: every position a tile reads lies in its span, the
    span fits the region the plan gives it, and resizing from it gives
    the plain version's u8."""
    x = _u8(shape, 14)
    got, plan = _emulate_plan(x, oh, ow, sigma, *tile, 132)
    assert plan.staged == (shape[3] in (1, 3, 4) and sigma > 0)
    assert plan.smem <= 232448
    want = fp.fused_resize_blur_oklab_reference(torch.from_numpy(x), oh, ow,
                                                sigma, oklab=False)
    assert np.array_equal(got, want.numpy())


def test_tile_plan_takes_a_smaller_tile_below_four_blocks_an_sm():
    r = tables.blur_radius(2.0)
    ty = tx = tables.halo_axis_table(1024, 512, r)
    big, _, _ = fp.tile_plan(16, 512, 512, r, 3, True, ty, tx, 132)
    one, _, _ = fp.tile_plan(1, 512, 512, r, 3, True, ty, tx, 132)
    assert (big.tw, big.th) == fp.TILES[0] and big.staged
    assert one.blocks >= fp.MIN_BLOCKS_PER_SM * 132 and one.staged
    assert one.tw * one.th < big.tw * big.th


def test_axis_spans_cover_mirrored_edges():
    t = tables.halo_axis_table(10, 37, 11)   # upscale, radius past the axis
    first, count = fp.axis_spans(t, 8, 5, 11)
    for i in range(5):
        seg = t[:2, i * 8:i * 8 + 8 + 22]
        assert first[i] == seg.min()
        assert first[i] + count[i] - 1 == seg.max()


def test_filter_chain_on_a_strided_plane_matches_jax():
    """F1: pipeline.filter_chain hands the kernel a contiguous plane, so a
    strided view (one channel of a batch) runs on the card as here."""
    x = _u8((2, 40, 56, 3), 15)
    plane = torch.from_numpy(x)[..., 0]
    assert not plane.is_contiguous()
    got = pipeline.filter_chain(plane)
    want = np.asarray(jax_pipeline.filter_chain(x[..., 0]))
    assert np.array_equal(got.numpy(), want)


def test_resize_blur_oklab_on_a_strided_batch_matches_jax():
    """F1: the same for pipeline.resize_blur_oklab on every other row."""
    x = _u8((2, 24, 20, 3), 16)
    batch = torch.from_numpy(x)[:, ::2]
    assert not batch.is_contiguous()
    got = pipeline.resize_blur_oklab(batch, 5, 6, 1.0)
    want = np.asarray(jax_rbo(np.ascontiguousarray(x[:, ::2]), 5, 6, 1.0))
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= OKLAB_TOL


def test_fused_wrapper_on_cpu_runs_plain_without_launching():
    x = torch.from_numpy(_u8((1, 40, 40, 3), 10))
    before = fp.LAUNCHES
    got = fp.fused_resize_blur_oklab(x, 20, 20, 2.0)
    want = fp.fused_resize_blur_oklab_reference(x, 20, 20, 2.0)
    assert fp.LAUNCHES == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels,k1,k4", [
    (1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1), (5, 2, 2), (8, 2, 2),
    (9, 3, 3)])
def test_launch_counts_follow_the_channel_groups(channels, k1, k4):
    """K1 runs C in {1, 3, 4} in one launch and any other C, like K4 every
    C, in groups of at most 4 channels, one launch each: LAUNCHES counts
    launches, not calls."""
    from zignal_tpu_torch.ops import separable_conv as sc

    assert fp.launches_for(channels) == k1
    assert sc.launches_for(channels) == k4


def test_fused_wrapper_raises_off_cpu_without_a_kernel():
    x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fp.fused_resize_blur_oklab(x, 4, 4, 1.0)


@pytest.mark.parametrize("args,err", [
    (((1, 8, 8, 4), 4, 4, 1.0, True), "Oklab epilogue needs RGB"),
    (((1, 8, 8, 0), 4, 4, 1.0, False), "channel count"),
    (((1, 8, 8, 3), 0, 4, 1.0, False), "at least 1"),
    (((1, 8, 8, 3), 4, 4, -1.0, False), "sigma"),
])
def test_fused_wrapper_rejects_bad_arguments(args, err):
    shape, oh, ow, sigma, oklab = args
    x = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match=err):
        fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab)


def test_resize_same_size_returns_input():
    x = torch.from_numpy(_u8((1, 9, 7, 3), 11))
    assert resize(x, 9, 7) is x


def test_unported_paths_raise_not_implemented():
    """Every resampling method and float inputs are ported, and integer
    dtypes other than uint8 take the JAX package's float route (f32
    out); complex inputs are not ported."""
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert resize(x, 4, 4, zp.Interpolation.BICUBIC).shape == (1, 4, 4, 3)
    assert resize(x.float(), 4, 4).dtype == torch.float32
    assert torch.equal(gaussian_blur(x.float(), 1.0, zp.BorderMode.ZERO),
                       x.float())
    assert resize(x.int(), 4, 4, zp.Interpolation.BICUBIC).dtype == \
        torch.float32
    assert torch.equal(gaussian_blur(x.int(), 1.0, zp.BorderMode.ZERO),
                       x.float())
    for call in (lambda a: resize(a, 4, 4), lambda a: gaussian_blur(a, 1.0)):
        with pytest.raises(NotImplementedError, match="complex64 is not "
                                                      "ported"):
            call(x.to(torch.complex64))


@pytest.mark.parametrize("method", [zp.Interpolation.LANCZOS,
                                    zp.Interpolation.NEAREST],
                         ids=lambda m: m.name)
def test_resize_blur_oklab_other_methods_match_jax(method):
    x = _u8((2, 40, 36, 3), 13)
    got = pipeline.resize_blur_oklab(torch.from_numpy(x), 17, 23, 1.5, method)
    want = jax_rbo(x, 17, 23, 1.5, jz.Interpolation(int(method)))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= OKLAB_TOL


def test_image_batch_validation_matches_jax():
    with pytest.raises(TypeError):
        zp.ImageBatch(_u8((1, 4, 4, 3), 0))            # no device given
    for bad, exc in [(np.zeros((4, 4, 3), np.uint8), ValueError),
                     (np.zeros((1, 4, 4, 2), np.uint8), ValueError),
                     (np.zeros((1, 4, 4, 3), np.float32), TypeError)]:
        with pytest.raises(exc):
            jz.ImageBatch(bad)
        with pytest.raises(exc):
            zp.ImageBatch(bad, device="cpu")
    with pytest.raises(ValueError, match="Rgb"):
        zp.ImageBatch(_u8((1, 8, 8, 4), 0), device="cpu").resize_blur_oklab(
            (4, 4))
    with pytest.raises(TypeError):
        zp.ImageBatch.from_numpy(torch.zeros((1, 4, 4, 3)), device="cpu")


def test_image_batch_metadata_and_round_trip():
    x = _u8((3, 10, 12, 4), 12)
    ib = zp.ImageBatch.from_numpy(x, device="cpu")
    assert (ib.rows, ib.cols, ib.channels) == (10, 12, 4)
    assert ib.device_array().device == torch.device("cpu")
    assert ib.device_array().dtype == torch.uint8
    assert np.array_equal(ib.to_numpy(), x)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, zignal_tpu_torch, zignal_tpu_torch.pipeline, "
            "zignal_tpu_torch.ops.fused_pipeline, "
            "zignal_tpu_torch.ops._build, zignal_tpu_torch.ops.filter_chain, "
            "zignal_tpu_torch.ops.separable_conv, "
            "zignal_tpu_torch.ops.color_chain, "
            "zignal_tpu_torch.ops.enhancement, zignal_tpu_torch.color, "
            "zignal_tpu_torch.ops.edges, zignal_tpu_torch.ops.order_stat, "
            "zignal_tpu_torch.ops.pyramid, zignal_tpu_torch.ops.fma\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'zignal_tpu.')) or "
            "m == 'zignal_tpu')\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- the file paths: BASELINE config 1 and the north star from files ----------

def _photo(h, w, seed):
    """A seeded photo-like RGB image: smooth gradients plus noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * (2 + k) + xx * (3 - k) + 40 * k) % 256
                     for k in range(3)], -1)
    noise = np.random.default_rng(seed).integers(-16, 17, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def test_config1_path_gives_the_jax_bytes():
    """bench.py's config 1 (JPEG decode -> Image.resize to half size ->
    PNG encode) at 60x80: every PNG byte equal."""
    from zignal_tpu.codecs import jpeg as jjpeg
    from zignal_tpu.codecs import png as jpng

    from zignal_tpu_torch.codecs import jpeg, png

    for k in range(3):
        jpg = jpeg.encode(_photo(60, 80, 100 + k), quality=90)
        assert jpg == jjpeg.encode(_photo(60, 80, 100 + k), quality=90)
        img = zp.Image.load_from_bytes(jpg, device="cpu")
        ours = png.encode(img.resize((img.rows // 2, img.cols // 2))
                          .to_numpy())
        arr, _ = jjpeg.decode(jpg)
        want = jz.Image.from_numpy(arr).resize((arr.shape[0] // 2,
                                                arr.shape[1] // 2))
        assert ours == jpng.encode(want.to_numpy())


def test_north_star_from_files_matches_jax(tmp_path):
    """Files (PNG and JPEG) -> ImageBatch.from_paths ->
    .resize_blur_oklab((32, 32), sigma=2) within 5e-6 of JAX, and the
    u8 resize output saved byte for byte as JAX saves it."""
    from zignal_tpu.native import get_lib as jax_native

    from zignal_tpu_torch.codecs import save_array

    assert jax_native() is not None   # before JAX's loader threads (§3)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"in{i}.{('png', 'jpg')[i % 2]}"))
        save_array(paths[-1], _photo(64, 64, 200 + i))
    ib = zp.ImageBatch.from_paths(paths, device="cpu")
    jb = jz.ImageBatch.from_paths(paths)
    assert np.array_equal(ib.to_numpy(), jb.to_numpy())
    lab = ib.resize_blur_oklab((32, 32), sigma=2.0)
    want = np.asarray(jb.resize_blur_oklab((32, 32), sigma=2.0))
    assert lab.shape == (4, 32, 32, 3) and bool(torch.isfinite(lab).all())
    assert float(np.abs(lab.numpy() - want).max()) <= OKLAB_TOL
    ours = [str(tmp_path / f"p{i}.png") for i in range(4)]
    theirs = [str(tmp_path / f"j{i}.png") for i in range(4)]
    ib.resize((32, 32)).save(ours)
    jb.resize((32, 32)).save(theirs)
    for a, b in zip(ours, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes()


# -- ImageBatch's item-10 members --------------------------------------------

_CLASS = {1: "Gray", 3: "Rgb", 4: "Rgba"}


@pytest.mark.parametrize("c", [1, 3, 4])
def test_image_batch_interop_members_match_jax(c):
    x = _u8((3, 9, 11, c), 60 + c)
    ib, jb = zp.ImageBatch(x, device="cpu"), jz.ImageBatch(x)
    assert repr(ib) == repr(jb)
    assert ib.dtype.__name__ == jb.dtype.__name__ == _CLASS[c]
    assert (len(ib), ib.batch_size) == (len(jb), 3)
    assert ib.block_until_ready() is ib
    for i in (0, 2, -1):
        assert np.array_equal(ib[i].to_numpy(), jb[i].to_numpy())
        assert ib[i].dtype is getattr(zp, _CLASS[c])
    with pytest.raises(IndexError):
        ib[3]
    images = ib.to_images()
    assert all(np.array_equal(a.to_numpy(), b.to_numpy())
               for a, b in zip(images, jb.to_images(), strict=True))
    images[0].to_numpy()[:] = 0   # a copy: the batch keeps its pixels
    assert np.array_equal(ib.to_numpy(), x)
    back = zp.ImageBatch.from_images(ib.to_images(), device="cpu")
    assert back.dtype is ib.dtype and np.array_equal(back.to_numpy(), x)
    assert np.array_equal(ib.copy().to_numpy(), x)
    r = ib.get_rectangle()
    assert (r.left, r.top, r.right, r.bottom) == (0, 0, 11, 9)
    with pytest.raises(ValueError):
        zp.ImageBatch.from_images([], device="cpu")
    with pytest.raises(ValueError):
        zp.ImageBatch.from_images([images[0], images[1].resize((4, 4))],
                                  device="cpu")
    with pytest.raises(ValueError):
        zp.ImageBatch(x, getattr(zp, _CLASS[3 if c != 3 else 4]),
                      device="cpu")
    assert zp.ImageBatch(x, getattr(zp, _CLASS[c]), device="cpu").dtype \
        is getattr(zp, _CLASS[c])


@pytest.mark.parametrize("c", [1, 3, 4])
def test_image_batch_pointwise_members_match_jax(c):
    x = _u8((3, 9, 11, c), 80 + c)
    ib, jb = zp.ImageBatch(x, device="cpu"), jz.ImageBatch(x)
    for name, args in [("invert", ()), ("flip_left_right", ()),
                       ("flip_top_bottom", ()), ("fill", ((12, 34, 56),)),
                       ("fill", (200,)), ("fill", (zp.Hsv(10.0, 50.0,
                                                          50.0),)),
                       ("set_border", ((2, 1, 8, 7),)),
                       ("set_border", ((2, 1, 8, 7), (255, 0, 0))),
                       ("set_border", ((-2, 3, 40, 6), 7)),
                       ("set_border", ((20, 20, 30, 30), (1, 2, 3)))]:
        jargs = tuple(jz.Hsv(*a._v) if isinstance(a, zp.Hsv) else a
                      for a in args)
        got, want = getattr(ib, name)(*args), getattr(jb, name)(*jargs)
        assert got.dtype.__name__ == want.dtype.__name__
        assert np.array_equal(got.to_numpy(), want.to_numpy()), (name, args)
    assert np.array_equal(ib.to_numpy(), x)   # the batch is not written
    with pytest.raises(TypeError):
        ib.set_border(None)


# every mode but SOFT_LIGHT is held equal to JAX's compiled blend: the FMAs
# sit where XLA's CPU backend contracts them (blending.blend_arrays). In
# SOFT_LIGHT (a square root) XLA's contraction depends on the fusion
# around it, so the port is held within 1 u8 step there, the bound the
# JAX package itself states between its device and host blends.
BLEND_WITHIN_ONE = {zp.Blending.SOFT_LIGHT}


@pytest.mark.parametrize("mode", list(zp.Blending), ids=lambda m: m.name)
@pytest.mark.parametrize("c,oc", [(4, 4), (3, 4), (1, 4), (3, 1), (4, 3)])
def test_image_batch_blend_matches_jax(mode, c, oc):
    rng = np.random.default_rng(90 + c + int(mode))
    x = rng.integers(0, 256, (3, 24, 20, c), np.uint8)
    over = rng.integers(0, 256, (3, 24, 20, oc), np.uint8)
    if oc == 4:
        over[:, 0, :, 3] = 0
        over[:, 1, :, 3] = 255
    if c == 4:
        x[:, 2, :, 3] = 0
    got = zp.ImageBatch(x, device="cpu").blend(
        zp.ImageBatch(over, device="cpu"), mode)
    want = jz.ImageBatch(x).blend(jz.ImageBatch(over), jz.Blending(mode))
    assert got.dtype.__name__ == want.dtype.__name__
    diff = np.abs(got.to_numpy().astype(int) - want.to_numpy().astype(int))
    assert diff.max() <= (1 if mode in BLEND_WITHIN_ONE else 0)
    with pytest.raises(ValueError):
        zp.ImageBatch(x, device="cpu").blend(
            zp.ImageBatch(over[:, :5], device="cpu"))
