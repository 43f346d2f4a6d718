"""The port's host-side tables and constants equal the JAX package's own
table functions (zignal_tpu_torch/ops/tables.py, color/_constants.py,
color/_array.py)."""

import numpy as np
import pytest

from zignal_tpu.color import _array as jax_color, _scalar
from zignal_tpu.enums import BorderMode
from zignal_tpu.ops import convolution as jax_conv
from zignal_tpu.ops import interpolation as jax_interp
from zignal_tpu.ops import mxu_resample, pallas_pipeline

from zignal_tpu_torch.color import _array as port_color, _constants
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.fused_pipeline import _tile_plan

SIGMAS = [0.5, 1.0, 1.5, 2.0, 3.5, 7.0]
AXES = [(256, 128), (500, 128), (37, 100), (53, 9), (1, 3), (64, 1),
        (1, 1), (256, 320), (1024, 512)]


@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_taps_equal(sigma):
    k = tables.gaussian_kernel(sigma)
    assert k == jax_conv.gaussian_kernel(sigma)
    assert np.array_equal(tables._kernel_to_int(k),
                          jax_conv._kernel_to_int(k))
    assert tables.blur_radius(sigma) == len(k) // 2
    assert tables.blur_radius(0.0) == 0


@pytest.mark.parametrize("mode", list(BorderMode))
@pytest.mark.parametrize("length", [1, 2, 3, 9, 100])
def test_resolve_index_equal(mode, length):
    idx = np.arange(-3 * length - 7, 4 * length + 7)
    assert np.array_equal(tables.resolve_index_np(idx, length, mode),
                          jax_interp.resolve_index_np(idx, length, mode))


@pytest.mark.parametrize("src,dst", AXES)
def test_axis_coords_equal(src, dst):
    for got, want in zip(tables._axis_coords(src, dst),
                         jax_interp._axis_coords(src, dst)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_build_tap_matrix_equal():
    rng = np.random.default_rng(3)
    idx = rng.integers(-1, 20, (30, 4))
    w = rng.integers(0, 300, (30, 4))
    assert np.array_equal(tables.build_tap_matrix(idx, w, 20, 30),
                          mxu_resample.build_tap_matrix(idx, w, 20, 30))
    assert np.array_equal(tables.build_tap_matrix(idx, w[0], 20, 30),
                          mxu_resample.build_tap_matrix(idx, w[0], 20, 30))


@pytest.mark.parametrize("src,dst", AXES)
def test_bilinear_axis_table_is_the_pallas_band(src, dst):
    a, b, f = tables.bilinear_axis_table(src, dst)
    got = tables.build_tap_matrix(np.stack([a, b], 1),
                                  np.stack([256 - f, f], 1), src, dst)
    assert np.array_equal(got, pallas_pipeline._bilinear_matrix(src, dst))


@pytest.mark.parametrize("n", [1, 2, 9, 100, 128])
@pytest.mark.parametrize("sigma", [0.5, 2.0, 3.5])
def test_blur_tap_table_is_the_pallas_band(n, sigma):
    kint = tables._kernel_to_int(tables.gaussian_kernel(sigma))
    taps = tables.blur_tap_table(n, len(kint))
    got = tables.build_tap_matrix(taps, kint, n, n)
    assert np.array_equal(got, pallas_pipeline._blur_matrix(n, sigma))


@pytest.mark.parametrize("src,dst", AXES)
@pytest.mark.parametrize("radius", [0, 2, 11])
def test_halo_axis_table_follows_the_blur_taps(src, dst, radius):
    """Halo column i + k holds the resized position that blur tap k of
    output i reads, so a tile needs no border logic of its own."""
    halo = tables.halo_axis_table(src, dst, radius)
    plain = tables.bilinear_axis_table(src, dst)
    taps = tables.blur_tap_table(dst, 2 * radius + 1)
    cols = np.arange(dst)[:, None] + np.arange(2 * radius + 1)[None, :]
    assert halo.dtype == np.int32 and halo.shape == (3, dst + 2 * radius)
    assert np.array_equal(halo[:, cols], plain[:, taps])


def test_color_constants_equal():
    for name in ("SRGB_LINEAR_THRESHOLD", "SRGB_GAMMA_THRESHOLD",
                 "SRGB_GAMMA_OFFSET", "SRGB_GAMMA_SCALE",
                 "SRGB_LINEAR_SLOPE", "SRGB_GAMMA_EXPONENT"):
        assert getattr(_constants, name) == getattr(_scalar, name)
    assert port_color._RGB2OKLMS == jax_color._RGB2OKLMS
    assert port_color._OKLMS2LAB == jax_color._OKLMS2LAB
    assert min(min(row) for row in port_color._RGB2OKLMS) > 0  # cbrt domain


@pytest.mark.parametrize("c,r,tile", [(3, 0, 32), (3, 6, 32), (4, 11, 32),
                                      (4, 40, 32), (4, 80, 16), (4, 100, 8)])
def test_tile_plan_fits_shared_memory(c, r, tile):
    got_tile, smem = _tile_plan(c, r)
    assert got_tile == tile
    assert smem <= 232448 and (smem == 0) == (r == 0)


def test_tile_plan_rejects_radius_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        _tile_plan(4, 200)
