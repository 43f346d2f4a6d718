"""The port's resize (ops/interpolation.py: every method, u8 and float),
its resampling tables (ops/tables.py), ``ImagePyramid`` (ops/pyramid.py)
and ``ImageBatch.resize`` / ``.letterbox`` against the JAX package on
JAX-CPU. u8 outputs are array_equal; float outputs are held to the bound
each test states. Inputs come from numpy with a seed and go to both
packages as the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.enums import Interpolation as JaxInterp
from zignal_tpu.ops import interpolation as jax_interp
from zignal_tpu.ops.pyramid import ImagePyramid as JaxPyramid

import zignal_tpu_torch as zp
from zignal_tpu_torch.enums import Interpolation
from zignal_tpu_torch.ops import fma, tables
from zignal_tpu_torch.ops.interpolation import resize, resize_plane_f32
from zignal_tpu_torch.ops.pyramid import ImagePyramid

METHODS = list(Interpolation)
# (shape, rows, cols): odd downscale, upscale, 1-px axes, one axis kept
U8_CASES = [((2, 23, 31, 3), 11, 17), ((1, 16, 12, 4), 37, 29),
            ((2, 1, 9, 1), 3, 4), ((1, 9, 1, 3), 5, 2),
            ((1, 30, 41, 1), 30, 20)]
# float bounds (max-abs against the JAX package). Measured: 0.0 for every
# method on both ranges against the jitted resize; 4.6e-5 (Lanczos) for
# resize_plane_f32, which the JAX package runs op by op (not jitted), so
# there XLA contracts no multiply-add and the port's fused ones differ by
# an ulp or three of 255
F255_TOL, F01_TOL = 1e-4, 1e-6


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _float(shape, seed, scale):
    return (np.random.default_rng(seed).random(shape, np.float32)
            * np.float32(scale)).astype(np.float32)


def _jax_resize(x, rows, cols, method):
    return np.asarray(jax_interp.resize(jnp.asarray(x), rows, cols,
                                        JaxInterp(int(method))))


@pytest.mark.parametrize("case", U8_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-{c[1]}x{c[2]}")
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_resize_u8_matches_jax(method, case):
    shape, rows, cols = case
    x = _u8(shape, 1)
    got = resize(torch.from_numpy(x), rows, cols, method).numpy()
    want = _jax_resize(x, rows, cols, method)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scale,tol", [(255.0, F255_TOL), (1.0, F01_TOL)],
                         ids=["0-255", "0-1"])
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_resize_float_within_bound_of_jax(method, scale, tol):
    for shape, rows, cols in (((1, 23, 31, 3), 11, 40),
                              ((2, 1, 9, 1), 3, 4)):
        x = _float(shape, 2, scale)
        got = resize(torch.from_numpy(x), rows, cols, method).numpy()
        want = _jax_resize(x, rows, cols, method)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("method", [Interpolation.BILINEAR,
                                    Interpolation.LANCZOS],
                         ids=lambda m: m.name)
def test_resize_plane_f32_within_bound_of_jax(method):
    x = _float((2, 19, 26), 3, 255.0)
    got = resize_plane_f32(torch.from_numpy(x), 30, 13, method).numpy()
    want = np.asarray(jax_interp.resize_plane_f32(jnp.asarray(x), 30, 13,
                                                  JaxInterp(int(method))))
    assert got.shape == (2, 30, 13)
    assert float(np.abs(got - want).max()) <= F255_TOL


def test_lanczos_u8_needs_the_contracted_multiply_add(monkeypatch):
    """The JAX package's compiled Lanczos accumulates ``total + px * w``
    as one fused multiply-add a tap (XLA contracts it on the CPU); the
    port's ``fma`` does the same. Rounding each product first moves one
    u8 output of this case by one."""
    x = torch.from_numpy(_u8((50, 50, 3), 0))
    want = _jax_resize(x.numpy(), 128, 128, Interpolation.LANCZOS)
    got = resize(x, 128, 128, Interpolation.LANCZOS).numpy()
    assert np.array_equal(got, want)
    monkeypatch.setattr(fma, "fma", lambda a, b, c: a * b + c)
    unfused = resize(x, 128, 128, Interpolation.LANCZOS).numpy()
    assert int((unfused != want).sum()) == 1


@pytest.mark.parametrize("channels", [2, 5])
def test_u8_bilinear_resize_of_any_channel_count_matches_jax(channels):
    """F2: u8 bilinear resize takes any channel count (the kernel runs
    groups of at most 4 on the card)."""
    x = _u8((2, 17, 19, channels), 40 + channels)
    got = resize(torch.from_numpy(x), 9, 11)
    want = _jax_resize(x, 9, 11, Interpolation.BILINEAR)
    assert got.shape == (2, 9, 11, channels)
    assert np.array_equal(got.numpy(), want)


def test_resize_same_size_returns_the_input():
    x = torch.from_numpy(_u8((1, 7, 9, 3), 6))
    for method in METHODS:
        assert resize(x, 7, 9, method) is x


def test_resize_of_integer_tensors_other_than_u8_is_not_ported():
    """They take the JAX package's float route now (below); complex
    tensors are what stays unported."""
    assert resize(torch.zeros((4, 4, 1), dtype=torch.int32), 2, 2).dtype \
        == torch.float32
    with pytest.raises(NotImplementedError, match="complex64 is not ported"):
        resize(torch.zeros((4, 4, 1), dtype=torch.complex64), 2, 2)


# integer inputs other than u8 over their whole range (int32: +-2^30,
# which f32 rounds; the JAX package rounds them the same way)
INT_DTYPES = [(np.int16, -32768, 32768), (np.uint16, 0, 65536),
              (np.int32, -2 ** 30, 2 ** 30)]


@pytest.mark.parametrize("dtype,lo,hi", INT_DTYPES,
                         ids=lambda d: getattr(d, "__name__", str(d)))
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_integer_resize_matches_jax(dtype, lo, hi, method):
    """Nearest keeps the dtype; every other method weighs the values in
    f32 and returns f32, as the JAX package's float route does. Bound:
    0.0, the two sum the same f32 products in the same contracted order."""
    x = np.random.default_rng(25).integers(lo, hi, (1, 8, 9, 2)) \
        .astype(dtype)
    for rows, cols in ((5, 13), (16, 4)):
        got = resize(torch.from_numpy(x), rows, cols, method).numpy()
        want = np.asarray(jax_interp.resize(jnp.asarray(x), rows, cols,
                                            JaxInterp(int(method))))
        assert got.dtype == want.dtype
        assert got.dtype == (dtype if method == Interpolation.NEAREST
                             else np.float32)
        assert float(np.abs(got.astype(np.float64) - want).max()) <= 0.0


@pytest.mark.parametrize("src,dst", [(23, 11), (12, 37), (1, 3), (9, 1),
                                     (30, 30), (1024, 512)])
def test_resampling_tables_equal_jax(src, dst):
    for kind, kern in ((2, jax_interp._cubic_kernel_i32),
                       (3, jax_interp._catmull_kernel_i32),
                       (4, jax_interp._mitchell_kernel_i32)):
        gi, gw = tables.cubic_axis_table(src, dst, tables.CUBIC_KERNELS[Interpolation(kind)])
        wi, ww = jax_interp._cubic_axis_table(src, dst, kern)
        assert np.array_equal(gi, wi) and np.array_equal(gw, ww)
    gi, gw = tables.lanczos_axis_table(src, dst)
    wi, ww = jax_interp._lanczos_axis_table(src, dst)
    assert np.array_equal(gi, wi) and np.array_equal(gw, ww)
    src_f, _, _ = jax_interp._axis_coords(src, dst)
    want = np.clip(np.floor(src_f + np.float32(0.5)), 0, src - 1)
    assert np.array_equal(tables.nearest_indices(src, dst), want)


def test_mitchell_support_is_open_where_the_others_are_closed():
    """At |t| = SCALE Mitchell takes its far branch (``at < s``), the
    cubic and Catmull-Rom kernels their near one (``at <= SCALE``)."""
    t = np.array([256, 512])
    assert np.array_equal(tables.CUBIC_KERNELS[4](t),
                          jax_interp._mitchell_kernel_i32(t))
    assert np.array_equal(tables.CUBIC_KERNELS[2](t),
                          jax_interp._cubic_kernel_i32(t))
    assert np.array_equal(tables.CUBIC_KERNELS[3](t),
                          jax_interp._catmull_kernel_i32(t))


def test_fma_rounds_once():
    rng = np.random.default_rng(7)
    a, b, c = (rng.random(1000, np.float32) * 300 for _ in range(3))
    want = (a.astype(np.float64) * b + c).astype(np.float32)
    got = fma.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    terms = [(torch.from_numpy(a), torch.from_numpy(b)),
             (torch.from_numpy(c), torch.from_numpy(a)),
             (torch.from_numpy(b), torch.from_numpy(c))]
    first = fma.fma(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
    assert torch.equal(fma.fma_sum(terms),
                       fma.fma(terms[2][0], terms[2][1], first))


@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_image_batch_resize_matches_jax(method):
    x = _u8((2, 20, 26, 3), 8)
    for size in ((13, 9), 1.5):
        got = zp.ImageBatch(x, device="cpu").resize(size, method)
        want = jz.ImageBatch(x).resize(size, JaxInterp(int(method)))
        assert np.array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("size,method", [
    ((16, 16), Interpolation.BILINEAR), ((24, 20), Interpolation.BICUBIC),
    (12, Interpolation.NEAREST), ((10, 15), Interpolation.LANCZOS),
    ((40, 60), Interpolation.MITCHELL)])
def test_image_batch_letterbox_matches_jax(size, method):
    x = _u8((2, 20, 30, 4), 9)
    got = zp.ImageBatch(x, device="cpu").letterbox(size, method)
    want = jz.ImageBatch(x).letterbox(size, JaxInterp(int(method)))
    assert got.to_numpy().shape == want.to_numpy().shape
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_resize_validation_matches_jax():
    x = _u8((1, 8, 8, 3), 0)
    for bad, err in ((0, ValueError), ((0, 4), ValueError),
                     ("x", TypeError), (float("nan"), ValueError)):
        with pytest.raises(err):
            jz.ImageBatch(x).resize(bad)
        with pytest.raises(err):
            zp.ImageBatch(x, device="cpu").resize(bad)
    for bad in (0, (4, -1)):
        with pytest.raises(ValueError, match="positive"):
            jz.ImageBatch(x).letterbox(bad)
        with pytest.raises(ValueError, match="positive"):
            zp.ImageBatch(x, device="cpu").letterbox(bad)


@pytest.mark.parametrize("shape,n_levels,scale,sigma", [
    ((61, 83), 5, 1.2, 1.6), ((40, 40), 3, 2.0, 1.0), ((9, 30), 6, 1.5, 1.6)])
def test_image_pyramid_levels_equal_jax(shape, n_levels, scale, sigma):
    x = _u8(shape, 10)
    got = ImagePyramid.build(torch.from_numpy(x), n_levels, scale, sigma)
    want = JaxPyramid.build(jnp.asarray(x), n_levels, scale, sigma)
    assert got.n_levels == want.n_levels == n_levels
    for g, w in zip(got.levels, want.levels):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got.to_original(2, 3.0, 4.0) == want.to_original(2, 3.0, 4.0)
    assert got.to_level(2, 3.0, 4.0) == want.to_level(2, 3.0, 4.0)


def test_image_pyramid_rejects_what_jax_rejects():
    x = torch.zeros((8, 8), dtype=torch.uint8)
    for n, s in ((0, 1.2), (3, 1.0)):
        with pytest.raises(ValueError, match="n_levels"):
            ImagePyramid.build(x, n, s)
        with pytest.raises(ValueError, match="n_levels"):
            JaxPyramid.build(jnp.asarray(x.numpy()), n, s)
