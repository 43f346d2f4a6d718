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
    ((1, 8, 8, 5), (8, 8), (8, 8), "channel count"),
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
