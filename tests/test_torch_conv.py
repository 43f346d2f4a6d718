"""The port's convolutions (ops/convolution.py: separable u8 and float,
2-D u8 and float, Sobel), the plain version of its separable kernel
(ops/separable_conv.py) and ``ImageBatch.convolve`` against the JAX
package on JAX-CPU: u8 outputs array_equal, float outputs within the
bound stated below. Inputs come from numpy with a seed and go to both
packages as the same arrays."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import zignal_tpu as jz
from zignal_tpu.enums import BorderMode as JaxBorder
from zignal_tpu.ops import convolution as jax_conv
from zignal_tpu.ops import pallas_pipeline
from zignal_tpu.ops.pallas_conv import pallas_separable_u8

import zignal_tpu_torch as zp
from zignal_tpu_torch import pipeline
from zignal_tpu_torch.enums import BorderMode
from zignal_tpu_torch.ops import separable_conv as sc
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.convolution import convolve2d, \
    convolve_separable, convolve_separable_reference, gaussian_blur, \
    sobel_gradients, sobel_magnitude

SIGNED = (-0.25, 0.5, 1.5, 0.5, -0.25)
GAUSS = tables.gaussian_kernel(1.0)
GAUSS2 = tables.gaussian_kernel(2.0)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _band(n, kint, border):
    return tables.build_tap_matrix(
        tables.border_tap_table(n, len(kint), border), kint, n, n)


def _exact_zero_padded(x, k):
    """numpy: 8.8 integer taps over zero-padded axes, width then height,
    divClampU8 by 256^2, the band semantics of a ZERO border."""
    kint = tables._kernel_to_int(k).astype(np.int64)
    r = len(kint) // 2
    h, w = x.shape[:2]
    p = np.pad(x.astype(np.int64), ((r, r), (r, r), (0, 0)))
    t = sum(kint[i] * p[:, i:i + w] for i in range(len(kint)))
    acc = sum(kint[i] * t[i:i + h] for i in range(len(kint)))
    rounded = np.where(acc >= 0, acc + 32768, acc - 32768)
    q = np.sign(rounded) * (np.abs(rounded) // 65536)
    return np.clip(q, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("kernel", [GAUSS, GAUSS2, SIGNED],
                         ids=["g1", "g2", "signed"])
@pytest.mark.parametrize("shape", [(2, 20, 24, 3), (1, 9, 40, 4),
                                   (2, 33, 7, 1)])
def test_convolve_separable_matches_jax(border, kernel, shape):
    x = _u8(shape, 1)
    got = convolve_separable(torch.from_numpy(x), kernel, kernel, border)
    want = jax_conv.convolve_separable(jnp.asarray(x), kernel, kernel,
                                       JaxBorder(int(border)))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_convolve_separable_uneven_kernels_on_one_image(border):
    x = _u8((20, 24, 3), 2)
    kx, ky = (0.25, 0.5, 0.25), (0.1, 0.2, 0.4, 0.2, 0.1)
    got = convolve_separable(torch.from_numpy(x), kx, ky, border).numpy()
    want = jax_conv.convolve_separable(jnp.asarray(x), kx, ky,
                                       JaxBorder(int(border)))
    assert np.array_equal(got, np.asarray(want))


def test_zero_border_tiny_axis_is_the_exact_zero_padded_answer():
    """The JAX package's fault (ROADMAP §3): a signed kernel on an axis
    shorter than its radius takes the tiny-axis branch, which reads pixel
    0 for ZERO-border taps outside the axis. The port computes the band
    semantics, the exact zero-padded answer."""
    x = _u8((1, 9, 1), 3) // 4   # below 64: the kernel's gain saturates
    got = convolve_separable(torch.from_numpy(x), SIGNED, SIGNED,
                             BorderMode.ZERO).numpy()
    exact = _exact_zero_padded(x, SIGNED)
    assert np.array_equal(got, exact)
    jax_out = np.asarray(jax_conv.convolve_separable(
        jnp.asarray(x), SIGNED, SIGNED, JaxBorder.ZERO))
    assert not np.array_equal(jax_out, exact)  # the fault is still there


@pytest.mark.parametrize("shape,kernel", [((1, 9, 1), GAUSS),
                                          ((1, 9, 1), GAUSS2),
                                          ((12, 9, 1), SIGNED),
                                          ((2, 9, 1), SIGNED),
                                          ((2, 2, 1), SIGNED)])
def test_zero_border_equals_jax_where_jax_is_right(shape, kernel):
    x = _u8(shape, 4)
    got = convolve_separable(torch.from_numpy(x), kernel, kernel,
                             BorderMode.ZERO).numpy()
    want = np.asarray(jax_conv.convolve_separable(
        jnp.asarray(x), kernel, kernel, JaxBorder.ZERO))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _exact_zero_padded(x, kernel))


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_separable_reference_matches_pallas_interpret(sigma):
    """The plain version of K4 against the TPU kernel in interpret mode,
    in the pattern of tests/test_diff_mxu.py:126-155."""
    x = _u8((2, 40, 56, 3), 15)
    ki = tables._kernel_to_int(tables.gaussian_kernel(sigma))
    mx = _band(56, ki, BorderMode.MIRROR)
    my = _band(40, ki, BorderMode.MIRROR)
    got = sc.separable_u8_reference(torch.from_numpy(x), mx, my)
    want = pallas_separable_u8(jnp.asarray(x), mx, my, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_separable_reference_non_square_band_matches_pallas_interpret():
    """A 2:1 bilinear band (256 - f, f taps): OH, OW differ from H, W."""
    x = _u8((1, 64, 48, 4), 16)
    mx = pallas_pipeline._bilinear_matrix(48, 24)
    my = pallas_pipeline._bilinear_matrix(64, 32)
    got = sc.separable_u8_reference(torch.from_numpy(x), mx, my)
    want = pallas_separable_u8(jnp.asarray(x), mx, my, interpret=True)
    assert got.shape == (1, 32, 24, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _kernel_tiles(x, mx, my, tile):
    """A numpy transcription of separable_kernel's index arithmetic: per
    output tile, stage the listed source rows x columns, column pass over
    every staged row through local tap positions, row pass, divClampU8."""
    yi, yw = tables.band_to_taps(my)
    xi, xw = tables.band_to_taps(mx)
    ysrc, yl = tables.tile_sources(yi, yw, tile)
    xsrc, xl = tables.tile_sources(xi, xw, tile)
    oh, ow = my.shape[0], mx.shape[0]
    out = np.zeros((x.shape[0], oh, ow, x.shape[3]), np.uint8)
    for ty, y0 in enumerate(range(0, oh, tile)):
        for tx, x0 in enumerate(range(0, ow, tile)):
            th, tw = min(tile, oh - y0), min(tile, ow - x0)
            staged = x[:, ysrc[ty]][:, :, xsrc[tx]].astype(np.int64)
            tmp = sum(xw[x0:x0 + tw, k][None, None, :, None]
                      * staged[:, :, xl[x0:x0 + tw, k]]
                      for k in range(xw.shape[1]))
            acc = sum(yw[y0:y0 + th, k][None, :, None, None]
                      * tmp[:, yl[y0:y0 + th, k]]
                      for k in range(yw.shape[1]))
            out[:, y0:y0 + th, x0:x0 + tw] = np.where(
                acc < 0, 0, np.minimum((acc + 32768) >> 16, 255))
    return out


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("tile", [32, 8])
def test_kernel_tiling_reproduces_plain(border, tile):
    """The tables and tile bounds the CUDA kernel relies on give the
    plain version's u8 at ragged edge tiles, WRAP edges and short axes."""
    x = _u8((2, 45, 70, 3), 17)
    for kernel in (tables.gaussian_kernel(2.0), SIGNED):
        ki = tables._kernel_to_int(kernel)
        mx, my = _band(70, ki, border), _band(45, ki, border)
        want = sc.separable_u8_reference(torch.from_numpy(x), mx, my)
        assert np.array_equal(_kernel_tiles(x, mx, my, tile), want.numpy())


def test_kernel_tiling_reproduces_plain_on_a_downscale_band():
    x = _u8((1, 70, 3, 1), 18)
    mx = pallas_pipeline._bilinear_matrix(3, 1)
    my = pallas_pipeline._bilinear_matrix(70, 33)
    want = sc.separable_u8_reference(torch.from_numpy(x), mx, my)
    assert np.array_equal(_kernel_tiles(x, mx, my, 8), want.numpy())


def _div_clamp(a):
    return np.where(a < 0, 0, np.minimum((a + 32768) >> 16, 255))


def _fma_f32(a, b, c):
    """f32 fused multiply-add: a * b + c rounded once (exact in f64 for
    f32 a, b and c of these sizes)."""
    return (a.astype(np.float64) * np.float64(b)
            + c.astype(np.float64)).astype(np.float32)


def _conv_tiles(x, kx, ky, border, tw, th, f32):
    """A numpy transcription of conv_kernel, tile by tile: the source
    region through the halo tables (contiguous where the kernel's interior
    test holds), the int32 width pass, the height pass as f32 FMAs in tap
    order (``f32``) or in int32, divClampU8 (>= 2^24 clips to 255)."""
    b, h, w, c = x.shape
    kx = tables._kernel_to_int(kx).astype(np.int64)
    ky = tables._kernel_to_int(ky).astype(np.int64)
    ty = tables.halo_positions(h, len(ky), border, "cpu").numpy()
    tx = tables.halo_positions(w, len(kx), border, "cpu").numpy()
    out = np.zeros_like(x)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            tth, ttw = min(th, h - y0), min(tw, w - x0)
            sh, sw = tth + len(ky) - 1, ttw + len(kx) - 1
            rows, cols = ty[y0:y0 + sh], tx[x0:x0 + sw]
            staged = x[:, np.maximum(rows, 0)][:, :, np.maximum(cols, 0)] \
                .astype(np.int64)
            staged[:, rows < 0] = 0
            staged[:, :, cols < 0] = 0
            sy0, sx0 = y0 - len(ky) // 2, x0 - len(kx) // 2
            if sy0 >= 0 and sy0 + sh <= h and sx0 >= 0 and sx0 + sw <= w:
                assert np.array_equal(staged, x[:, sy0:sy0 + sh,
                                                sx0:sx0 + sw])
            t = sum(kx[j] * staged[:, :, j:j + ttw] for j in range(len(kx)))
            if f32:
                tf = t.astype(np.float32)
                acc = np.zeros((b, tth, ttw, c), np.float32)
                for k in range(len(ky)):
                    acc = _fma_f32(tf[:, k:k + tth], np.float32(ky[k]), acc)
                v = np.where(acc >= 2 ** 24, 255,
                             _div_clamp(acc.astype(np.int64)))
            else:
                acc = sum(ky[k] * t[:, k:k + tth] for k in range(len(ky)))
                v = _div_clamp(acc)
            out[:, y0:y0 + tth, x0:x0 + ttw] = v
    return out


CONV_KERNELS = [GAUSS2, GAUSS, tables.gaussian_kernel(1.5), SIGNED,
                tables.gaussian_kernel(3.5), (0.25, 0.5, 0.25, 0.125)]


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("tile", [(64, 32), (16, 8), (4, 8)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_conv_kernel_tiling_reproduces_plain(border, tile):
    """conv_kernel's halo tables, tile bounds and interior test give the
    plain version's u8 at ragged edge tiles, WRAP and ZERO edges, an axis
    shorter than the radius and an even kernel, in the form (f32 or int32)
    the wrapper picks."""
    for shape in ((2, 45, 70, 3), (1, 3, 20, 1), (1, 33, 65, 4)):
        x = _u8(shape, 24)
        for k in CONV_KERNELS:
            f32 = sc.f32_exact(tables._kernel_to_int(k),
                               tables._kernel_to_int(k))
            want = convolve_separable_reference(torch.from_numpy(x), k, k,
                                                border)
            got = _conv_tiles(x, k, k, border, *tile, f32)
            assert np.array_equal(got, want.numpy()), (shape, len(k))


def test_f32_height_pass_is_exact_where_the_predicate_admits_it():
    """For every pair of kernels the predicate admits, f32 FMAs in the
    kernel's tap order give the int32 plain version on an all-255 plane
    (sigma 2's taps sum to 257: the sums pass 2^24 and clip) and on random
    planes; signed bands past 2^24 are refused."""
    k2 = tables._kernel_to_int(GAUSS2)
    assert k2.sum() == 257 and 255 * 257 * 257 >= 2 ** 24
    admitted = [(GAUSS2, GAUSS2), (GAUSS, GAUSS2), (SIGNED, (1 / 256,)),
                ((1 / 64, 1 / 32, 1 / 64), SIGNED[:3]),
                (tables.gaussian_kernel(5.0), tables.gaussian_kernel(0.5))]
    for kx, ky in admitted:
        assert sc.f32_exact(tables._kernel_to_int(kx),
                            tables._kernel_to_int(ky))
        for x in (np.full((1, 30, 41, 3), 255, np.uint8),
                  _u8((2, 30, 41, 3), 25), _u8((1, 16, 16, 1), 26) | 0xF0):
            for border in (BorderMode.MIRROR, BorderMode.ZERO):
                want = convolve_separable_reference(torch.from_numpy(x), kx,
                                                    ky, border)
                got = _conv_tiles(x, kx, ky, border, 16, 8, True)
                assert np.array_equal(got, want.numpy()), (len(kx), len(ky))
    for kx, ky in ((SIGNED, SIGNED), (SIGNED, GAUSS2), (GAUSS, SIGNED)):
        assert not sc.f32_exact(tables._kernel_to_int(kx),
                                tables._kernel_to_int(ky))
    mx = _band(40, k2, BorderMode.WRAP)
    assert sc.f32_exact(mx, mx)
    assert not sc.f32_exact(_band(40, tables._kernel_to_int(SIGNED),
                                  BorderMode.ZERO), mx)


@pytest.mark.parametrize("b,h,w", [(16, 1024, 1024), (1, 1024, 1024),
                                   (2, 63, 129), (1, 1, 65), (3, 65, 1)])
def test_conv_tile_plans_fit_shared_memory(b, h, w):
    """Every plan for sigma up to 5 and C in 1..4 fits 232,448 bytes,
    with power-of-two tiles and the staged rows and the width pass's
    values (8 rows of slack) in order."""
    for sigma in np.arange(0.5, 5.01, 0.5):
        k = len(tables.gaussian_kernel(float(sigma)))
        for c in range(1, 5):
            p = sc.conv_tile_plan(k, k, c, h, w, b, 132)
            assert p.smem <= 232448
            assert p.tw & (p.tw - 1) == 0 and p.th & (p.th - 1) == 0
            assert p.tw >= 4 and p.th >= 8
            assert p.sp % 16 == 0 and p.sp >= (p.tw + k - 1) * c + 16
            assert p.off_t % 16 == 0 and p.off_t >= (p.th + k - 1) * p.sp
            assert p.tw <= sc.TILE_W
            assert p.smem == p.off_t + 4 * (p.th + k - 1 + 8) * 64 * c
    big = sc.conv_tile_plan(13, 13, 3, 1024, 1024, 16, 132)
    assert big.blocks >= 4 * 132


def test_band_plans_fit_shared_memory():
    """band_kernel's plans for the bands the wrappers send it: convolution
    bands up to sigma 5 on every border, a 2:1 bilinear band, kernels of
    more than conv_kernel's 256 taps, and dense bands at the int32 bound."""
    bands = [_band(n, tables._kernel_to_int(tables.gaussian_kernel(s)), b)
             for n in (1, 40, 200) for s in (0.5, 2.0, 5.0)
             for b in BorderMode]
    bands.append(pallas_pipeline._bilinear_matrix(1024, 512))
    bands.append(_band(600, tables._kernel_to_int(tables.gaussian_kernel(
        43.0)), BorderMode.MIRROR))
    dense = np.full((64, 64), 45, np.int64)  # 255 * 2880^2 + 2^15 < 2^31
    sc._check(torch.zeros((1, 64, 64, 1), dtype=torch.uint8), dense, dense)
    bands.append(dense)
    for M in bands:
        for c in (1, 3, 4):
            plan = sc._BandPlan(M, M, 1, M.shape[1], M.shape[1], c, "cpu")
            assert plan.smem <= 232448


def test_kernels_too_long_for_a_conv_tile_take_the_band_kernel():
    """sigma 30 (181 taps) on RGB fits no conv_kernel tile; run_conv then
    sends its bands to band_kernel, whose plan fits; sigma 20 still fits
    a conv tile."""
    for sigma, c, fits in ((30.0, 3, False), (30.0, 1, True),
                           (20.0, 4, True)):
        k = tables._kernel_to_int(tables.gaussian_kernel(sigma))
        plan = sc._conv_plan(k, k, BorderMode.REPLICATE, 1, 64, 64, c, "cpu")
        assert (plan is not None) == fits
        if not fits:
            band = _band(64, k, BorderMode.REPLICATE)
            assert sc._BandPlan(band, band, 1, 64, 64, c, "cpu").smem \
                <= 232448


def test_halo_tables_resolve_each_border():
    """Entry y0 + r of a table is source position y0 - k // 2 + r under
    the border, -1 where ZERO reads 0, on axes longer and shorter than the
    kernel."""
    for n in (1, 2, 5, 40):
        for k in (1, 4, 5, 13):
            for border in BorderMode:
                got = tables.halo_positions(n, k, border, "cpu").numpy()
                want = tables.resolve_index_np(np.arange(-(k // 2),
                                                         n + k - 1 - k // 2),
                                               n, border)
                assert got.shape == (n + k - 1,)
                assert np.array_equal(got, want)


# integer inputs other than u8 over their whole range (int32: +-2^30,
# which f32 rounds; the JAX package rounds them the same way)
INT_DTYPES = [(np.int16, -32768, 32768), (np.uint16, 0, 65536),
              (np.int32, -2 ** 30, 2 ** 30)]


@pytest.mark.parametrize("dtype,lo,hi", INT_DTYPES,
                         ids=lambda d: getattr(d, "__name__", str(d)))
@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_integer_convolutions_match_jax(dtype, lo, hi, border):
    """convolve_separable, gaussian_blur and convolve2d take the JAX
    package's float route for other integer dtypes: f32 out. Bound: 0.0,
    the same f32 products summed in the same contracted order."""
    x = np.random.default_rng(26).integers(lo, hi, (1, 8, 9, 3)) \
        .astype(dtype)
    jb = JaxBorder(int(border))
    pairs = [
        (convolve_separable(torch.from_numpy(x), GAUSS, SIGNED, border),
         jax_conv.convolve_separable(jnp.asarray(x), GAUSS, SIGNED, jb)),
        (gaussian_blur(torch.from_numpy(x), 2.0, border),
         jax_conv.gaussian_blur(jnp.asarray(x), 2.0, jb)),
        (convolve2d(torch.from_numpy(x[0]), ((0.0, -1.0, 0.0),
                                             (-1.0, 5.0, -1.0),
                                             (0.0, -1.0, 0.0)), border),
         jax_conv.convolve2d(jnp.asarray(x[0]), ((0.0, -1.0, 0.0),
                                                 (-1.0, 5.0, -1.0),
                                                 (0.0, -1.0, 0.0)), jb)),
    ]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        assert float(np.abs(got - want).max()) <= 0.0


@pytest.mark.parametrize("channels", [5, 8])
def test_gaussian_blur_of_more_than_four_channels_matches_jax(channels):
    """F3: the u8 blur takes any channel count (the kernel runs groups of
    at most 4 on the card)."""
    x = _u8((2, 17, 19, channels), 50 + channels)
    got = gaussian_blur(torch.from_numpy(x), 1.0)
    want = np.asarray(jax_conv.gaussian_blur(jnp.asarray(x), 1.0))
    assert np.array_equal(got.numpy(), want)


def test_separable_wrapper_on_cpu_runs_plain_without_launching():
    x = torch.from_numpy(_u8((1, 30, 20, 3), 19))
    ki = tables._kernel_to_int(GAUSS)
    mx, my = _band(20, ki, BorderMode.WRAP), _band(30, ki, BorderMode.WRAP)
    before = sc.LAUNCHES
    got = sc.separable_u8(x, mx, my)
    assert sc.LAUNCHES == before
    assert torch.equal(got, sc.separable_u8_reference(x, mx, my))


def test_convolve_separable_reference_equals_the_wrapper_on_cpu():
    x = torch.from_numpy(_u8((2, 17, 13, 4), 20))
    assert torch.equal(convolve_separable(x, SIGNED, GAUSS, BorderMode.WRAP),
                       convolve_separable_reference(x, SIGNED, GAUSS,
                                                    BorderMode.WRAP))


def test_wrappers_raise_off_cpu_without_a_kernel():
    x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        gaussian_blur(x, 1.0)
    mx = np.eye(8, dtype=np.int64) * 256
    with pytest.raises(ValueError, match="no kernel for device"):
        sc.separable_u8(x, mx, mx)


@pytest.mark.parametrize("shape,mx,my,err", [
    ((1, 8, 8, 0), (8, 8), (8, 8), "channel count"),
    ((1, 8, 8), (8, 8), (8, 8), "uint8 \\[B, H, W, C\\]"),
    ((1, 8, 8, 3), (8, 7), (8, 8), "Mx \\[OW, W\\]"),
    ((1, 8, 8, 3), (0, 8), (8, 8), "at least 1"),
])
def test_separable_wrapper_rejects_bad_arguments(shape, mx, my, err):
    x = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match=err):
        sc.separable_u8(x, np.ones(mx, np.int64), np.ones(my, np.int64))


def test_separable_wrapper_rejects_int32_overflow():
    x = torch.zeros((1, 4, 4, 1), dtype=torch.uint8)
    big = np.full((4, 4), 2000, np.int64)   # 255 * 8000^2 > 2^31
    with pytest.raises(ValueError, match="overflow"):
        sc.separable_u8(x, big, big)


@pytest.mark.parametrize("sigma", [0.8, 2.0])
def test_image_batch_gaussian_blur_matches_jax(sigma):
    x = _u8((2, 30, 41, 3), 21)
    got = zp.ImageBatch(x, device="cpu").gaussian_blur(sigma)
    want = jz.ImageBatch(x).gaussian_blur(sigma)
    assert np.array_equal(got.to_numpy(), want.to_numpy())
    assert np.array_equal(
        pipeline.batched_gaussian_blur(torch.from_numpy(x), sigma).numpy(),
        want.to_numpy())


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_image_batch_convolve_separable_matches_jax(border):
    x = _u8((2, 25, 19, 4), 22)
    got = zp.ImageBatch(x, device="cpu").convolve_separable(
        GAUSS, SIGNED, border)
    want = jz.ImageBatch(x).convolve_separable(GAUSS, SIGNED,
                                               JaxBorder(int(border)))
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_conv_validation_matches_jax():
    x = _u8((1, 8, 8, 3), 0)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="sigma"):
            jz.ImageBatch(x).gaussian_blur(bad)
        with pytest.raises(ValueError, match="sigma"):
            zp.ImageBatch(x, device="cpu").gaussian_blur(bad)
    for kx, ky in (((0.5, 0.5), (1.0,)), (((1.0,),), (1.0,))):
        with pytest.raises(ValueError, match="odd length"):
            jz.ImageBatch(x).convolve_separable(kx, ky)
        with pytest.raises(ValueError, match="odd length"):
            zp.ImageBatch(x, device="cpu").convolve_separable(kx, ky)


# -- float separable convolution, 2-D convolution and Sobel -----------------

SHARPEN3 = ((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0))
BINOMIAL3 = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125),
             (0.0625, 0.125, 0.0625))
_k = np.random.default_rng(30).random((5, 5))
SMOOTH5 = tuple(tuple(float(v) for v in row)
                for row in (_k / _k.sum()).astype(np.float32))
WIDE35 = ((0.1, -0.2, 0.4, -0.2, 0.1), (0.0, 0.3, 0.5, 0.3, 0.0),
          (-0.1, 0.2, 0.0, 0.2, -0.1))
# float bounds (max-abs against the JAX package). Measured over these
# cases: separable 1.5e-5 on 0-255 data and 1.2e-7 on 0-1 data, 2-D
# 1.5e-5 and 6.0e-8 (at some shapes XLA leaves a multiply-add of the
# jitted sums uncontracted where the port contracts it: an ulp)
F255_TOL, F01_TOL = 1e-4, 1e-6


def _float(shape, seed, scale):
    return (np.random.default_rng(seed).random(shape, np.float32)
            * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("scale,tol", [(255.0, F255_TOL), (1.0, F01_TOL)],
                         ids=["0-255", "0-1"])
@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_float_convolve_separable_within_bound_of_jax(border, scale, tol):
    for shape in ((20, 24, 3), (2, 9, 40, 4), (33, 7, 1), (1, 9, 3)):
        x = _float(shape, 31, scale)
        for kernel in (GAUSS, SIGNED):
            if border == BorderMode.ZERO and min(shape[-3:-1]) <= \
                    len(kernel) // 2:
                continue  # the JAX package's tiny-axis fault (ROADMAP §3)
            got = convolve_separable(torch.from_numpy(x), kernel, kernel,
                                     border).numpy()
            want = np.asarray(jax_conv.convolve_separable(
                jnp.asarray(x), kernel, kernel, JaxBorder(int(border))))
            assert got.dtype == np.float32
            assert float(np.abs(got - want).max()) <= tol


def test_float_zero_border_tiny_axis_is_the_zero_padded_answer():
    x = _float((1, 9, 1), 32, 255.0)
    got = convolve_separable(torch.from_numpy(x), SIGNED, SIGNED,
                             BorderMode.ZERO).numpy()
    k = np.asarray(SIGNED, np.float64)
    p = np.pad(x[..., 0].astype(np.float64), 2)
    rows = sum(k[i] * p[:, i:i + 9] for i in range(5))
    want = sum(k[i] * rows[i:i + 1] for i in range(5))
    assert float(np.abs(got[..., 0] - want).max()) <= F255_TOL


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("kernel", [SHARPEN3, BINOMIAL3, SMOOTH5, WIDE35],
                         ids=["sharpen", "binomial", "smooth5", "wide3x5"])
def test_convolve2d_u8_matches_jax(kernel, border):
    for shape in ((13, 17, 3), (9, 6, 4), (1, 9, 1)):
        x = _u8(shape, 33)
        got = convolve2d(torch.from_numpy(x), kernel, border).numpy()
        want = np.asarray(jax_conv.convolve2d(jnp.asarray(x), kernel,
                                              JaxBorder(int(border))))
        assert got.dtype == np.uint8
        assert np.array_equal(got, want)


def test_convolve2d_on_a_batch_equals_each_image():
    x = _u8((3, 11, 8, 3), 34)
    got = convolve2d(torch.from_numpy(x), SMOOTH5, BorderMode.WRAP).numpy()
    for i in range(3):
        assert np.array_equal(got[i], np.asarray(jax_conv.convolve2d(
            jnp.asarray(x[i]), SMOOTH5, JaxBorder.WRAP)))


@pytest.mark.parametrize("scale,tol", [(255.0, F255_TOL), (1.0, F01_TOL)],
                         ids=["0-255", "0-1"])
@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_float_convolve2d_within_bound_of_jax(border, scale, tol):
    x = _float((20, 24, 3), 35, scale)
    for kernel in (SMOOTH5, WIDE35, BINOMIAL3):
        got = convolve2d(torch.from_numpy(x), kernel, border).numpy()
        want = np.asarray(jax_conv.convolve2d(jnp.asarray(x), kernel,
                                              JaxBorder(int(border))))
        assert float(np.abs(got - want).max()) <= tol


def test_convolve2d_rejects_even_kernels():
    with pytest.raises(ValueError, match="odd dimensions"):
        convolve2d(torch.zeros((4, 4, 1), dtype=torch.uint8),
                   ((0.5, 0.5), (0.5, 0.5)))


@pytest.mark.parametrize("shape", [(20, 24), (1, 9), (7, 1), (2, 13, 11)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sobel_matches_jax(shape):
    """Integer planes (as ImageBatch.sobel passes) and a blurred float
    plane: the gradients are exact sums of ±1, ±2 taps."""
    planes = [_u8(shape, 36).astype(np.float32), _float(shape, 37, 255.0)]
    for x in planes:
        got = sobel_magnitude(torch.from_numpy(x)).numpy()
        gx, gy = sobel_gradients(torch.from_numpy(x))
        for i in np.ndindex(shape[:-2]):
            assert np.array_equal(got[i], np.asarray(
                jax_conv.sobel_magnitude(jnp.asarray(x[i]))))
            wx, wy = jax_conv.sobel_gradients(jnp.asarray(x[i]))
            assert np.array_equal(gx[i].numpy(), np.asarray(wx))
            assert np.array_equal(gy[i].numpy(), np.asarray(wy))


@pytest.mark.parametrize("kernel,border", [
    (SHARPEN3, BorderMode.MIRROR), (SMOOTH5, BorderMode.ZERO),
    (WIDE35, BorderMode.WRAP), (BINOMIAL3, BorderMode.REPLICATE)])
def test_image_batch_convolve_matches_jax(kernel, border):
    x = _u8((2, 15, 12, 4), 38)
    got = zp.ImageBatch(x, device="cpu").convolve(kernel, border)
    want = jz.ImageBatch(x).convolve(kernel, JaxBorder(int(border)))
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_convolve_validation_matches_jax():
    x = _u8((1, 8, 8, 3), 0)
    for bad in (((1.0, 0.0),), (1.0, 2.0, 3.0), ((0.5, 0.5), (0.5, 0.5))):
        with pytest.raises(ValueError, match="odd dimensions"):
            jz.ImageBatch(x).convolve(bad)
        with pytest.raises(ValueError, match="odd dimensions"):
            zp.ImageBatch(x, device="cpu").convolve(bad)
