"""The port's host-side tables and constants equal the JAX package's own
table functions (zignal_tpu_torch/ops/tables.py, color/_scalar.py,
color/_array.py); the compact tap tables of the separable kernel rebuild
the bands they come from."""

import numpy as np
import pytest

from zignal_tpu.color import _array as jax_color, _scalar
from zignal_tpu.enums import BorderMode
from zignal_tpu.ops import convolution as jax_conv
from zignal_tpu.ops import interpolation as jax_interp
from zignal_tpu.ops import integral as jax_integral
from zignal_tpu.ops import mxu_resample, pallas_filter, pallas_pipeline

from zignal_tpu_torch.color import _array as port_color
from zignal_tpu_torch.color import _scalar as port_scalar
from zignal_tpu_torch.ops import tables
from zignal_tpu_torch.ops.fused_pipeline import tile_plan

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
    taps = tables.border_tap_table(n, len(kint), BorderMode.MIRROR)
    got = tables.build_tap_matrix(taps, kint, n, n)
    assert np.array_equal(got, pallas_pipeline._blur_matrix(n, sigma))


@pytest.mark.parametrize("src,dst", AXES)
@pytest.mark.parametrize("radius", [0, 2, 11])
def test_halo_axis_table_follows_the_blur_taps(src, dst, radius):
    """Halo column i + k holds the resized position that blur tap k of
    output i reads, so a tile needs no border logic of its own."""
    halo = tables.halo_axis_table(src, dst, radius)
    plain = tables.bilinear_axis_table(src, dst)
    taps = tables.border_tap_table(dst, 2 * radius + 1, BorderMode.MIRROR)
    cols = np.arange(dst)[:, None] + np.arange(2 * radius + 1)[None, :]
    assert halo.dtype == np.int32 and halo.shape == (3, dst + 2 * radius)
    assert np.array_equal(halo[:, cols], plain[:, taps])


@pytest.mark.parametrize("mode", list(BorderMode))
@pytest.mark.parametrize("n,ksize", [(1, 5), (2, 13), (9, 5), (40, 13),
                                     (7, 1)])
def test_border_tap_table_is_axis_taps(mode, n, ksize):
    """_axis_taps returns (idx with -1 replaced by 0, mask); the port keeps
    -1 in place of the mask."""
    taps = tables.border_tap_table(n, ksize, mode)
    idx, mask = jax_conv._axis_taps(n, ksize, mode)
    assert np.array_equal(taps >= 0, mask)
    assert np.array_equal(np.where(mask, taps, 0), idx)


@pytest.mark.parametrize("n", [1, 2, 5, 64, 130])
@pytest.mark.parametrize("radius", [0, 1, 2, 3, 128])
def test_window_tables_equal(n, radius):
    for got, want in zip(tables.window_bounds(n, radius),
                         jax_integral._window_bounds(n, radius)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = tables.extents(n, radius)
    assert got.dtype == np.float32
    assert np.array_equal(got, pallas_filter._extents(n, radius))
    assert np.array_equal(tables.clamped_band(n, radius),
                          jax_integral._clamped_band(n, radius))
    assert np.array_equal(tables.clamped_band(n, radius),
                          pallas_filter._clamped_ones_band(n, radius))


@pytest.mark.parametrize("n", [1, 5, 100])
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.5])
def test_gauss_band_from_the_tap_tables(n, sigma):
    kint = tables._kernel_to_int(tables.gaussian_kernel(sigma))
    band = tables.build_tap_matrix(
        tables.border_tap_table(n, len(kint), BorderMode.MIRROR), kint, n, n)
    assert np.array_equal(band, pallas_filter._gauss_band(n, sigma))


def _bands():
    rng = np.random.default_rng(4)
    sparse = rng.integers(-3, 4, (20, 31)) * (rng.random((20, 31)) < 0.2)
    sparse[7] = 0   # an empty row
    kint = tables._kernel_to_int((-0.25, 0.5, 1.5, 0.5, -0.25))
    wrap = tables.build_tap_matrix(
        tables.border_tap_table(50, 5, BorderMode.WRAP), kint, 50, 50)
    return [sparse, wrap, pallas_pipeline._bilinear_matrix(1024, 512),
            pallas_pipeline._bilinear_matrix(3, 70), np.zeros((4, 6), int)]


@pytest.mark.parametrize("band", _bands(), ids=["sparse", "wrap",
                                                "bilinear_down", "bilinear_up",
                                                "empty"])
def test_band_to_taps_rebuilds_the_band(band):
    idx, w = tables.band_to_taps(band)
    assert idx.dtype == w.dtype == np.int32
    k = max(1, int((band != 0).sum(axis=1).max()))
    assert idx.shape == w.shape == (band.shape[0], k)
    assert np.array_equal(
        tables.build_tap_matrix(idx, w, band.shape[1], band.shape[0]), band)
    assert idx.min() >= 0 and idx.max() < band.shape[1]


@pytest.mark.parametrize("band", _bands(), ids=["sparse", "wrap",
                                                "bilinear_down", "bilinear_up",
                                                "empty"])
@pytest.mark.parametrize("tile", [32, 8, 3])
def test_tile_sources_cover_every_tap(band, tile):
    idx, w = tables.band_to_taps(band)
    src, local = tables.tile_sources(idx, w, tile)
    assert src.shape[0] == -(-band.shape[0] // tile)
    for t in range(src.shape[0]):
        rows = slice(t * tile, (t + 1) * tile)
        assert np.all(np.diff(src[t]) >= 0)          # sorted, padded
        live = w[rows] != 0
        assert np.array_equal(src[t][local[rows]][live], idx[rows][live])
        assert np.all(local[rows][~live] == 0)
    assert local.min() >= 0 and local.max() < src.shape[1]


def test_wrap_edge_tile_lists_both_ends_not_the_whole_axis():
    kint = tables._kernel_to_int(tables.gaussian_kernel(2.0))
    band = tables.build_tap_matrix(
        tables.border_tap_table(1024, len(kint), BorderMode.WRAP), kint,
        1024, 1024)
    src, _ = tables.tile_sources(*tables.band_to_taps(band), 32)
    assert src.shape[1] == 32 + 2 * 6
    assert set(src[0]) == set(range(0, 38)) | set(range(1018, 1024))


def test_color_constants_equal():
    for name in ("LUMA_R", "LUMA_G", "LUMA_B",
                 "SRGB_LINEAR_THRESHOLD", "SRGB_GAMMA_THRESHOLD",
                 "SRGB_GAMMA_OFFSET", "SRGB_GAMMA_SCALE",
                 "SRGB_LINEAR_SLOPE", "SRGB_GAMMA_EXPONENT"):
        assert getattr(port_scalar, name) == getattr(_scalar, name)
    assert port_color._RGB2OKLMS == jax_color._RGB2OKLMS
    assert port_color._OKLMS2LAB == jax_color._OKLMS2LAB
    assert min(min(row) for row in port_color._RGB2OKLMS) > 0  # cbrt domain


def _k1_plan(c, r, b=16, n=1024, o=512):
    t = tables.halo_axis_table(n, o, r)
    return tile_plan(b, o, o, r, c, False, t, t, 132)[0]


# past r ~ 30 a 2:1 tile's source span no longer fits beside its halo, and
# the plan gathers from global memory instead
@pytest.mark.parametrize("c,r,tile,staged", [
    (3, 0, (32, 32), False), (3, 6, (64, 32), True), (4, 11, (64, 32), True),
    (4, 40, (64, 32), False), (4, 80, (16, 16), False),
    (4, 100, (8, 8), False)])
def test_tile_plan_fits_shared_memory(c, r, tile, staged):
    plan = _k1_plan(c, r)
    assert (plan.tw, plan.th) == tile and plan.staged == staged
    assert plan.smem <= 232448


def test_tile_plan_rejects_radius_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        _k1_plan(4, 200)


def test_more_color_constants_equal():
    for name in ("XYB_BIAS", "XYB_CBRT_BIAS_ENCODE", "XYB_CBRT_BIAS_DECODE",
                 "D65_X", "D65_Y", "D65_Z", "LAB_EPSILON",
                 "LAB_KAPPA_DIV_116", "LAB_DELTA"):
        assert getattr(port_scalar, name) == getattr(_scalar, name)
    assert port_color._OKLMS2RGB == jax_color._OKLMS2RGB


def _cu_enum(name):
    """The enumerators of ``enum <name>`` in the colour-chain kernel's
    source, without the trailing count (kMatrices, kScalars)."""
    import re
    from pathlib import Path

    import zignal_tpu_torch

    src = (Path(zignal_tpu_torch.__file__).parent / "csrc"
           / "fused_color_chain_u8.cu").read_text()
    body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S).group(1)
    names = [re.sub(r"\s*=.*", "", item.strip()) for item in body.split(",")]
    return [n for n in names if n and not n.startswith("k")], src


def test_chain_kernel_tables_follow_the_wrapper():
    from zignal_tpu_torch.ops import color_chain as cc

    assert tuple(_cu_enum("Step")[0]) == cc.STEPS
    assert tuple(_cu_enum("Matrix")[0]) == cc.MATRICES
    scalars, src = _cu_enum("Scalar")
    assert tuple(scalars) == cc.SCALARS
    assert f"constexpr int kMaxSteps = {cc.MAX_STEPS};" in src
    raw = cc.params_bytes(cc.compile_chain(("rgb", "lab", "rgb")))
    assert len(raw) == 4 * (1 + cc.MAX_STEPS + 9 * len(cc.MATRICES)
                            + len(cc.SCALARS))
    ints = np.frombuffer(raw[:4 * (1 + cc.MAX_STEPS)], np.int32)
    assert ints[0] == 4 and list(ints[1:5]) == [
        cc.STEPS.index(s) for s in ("GAMMA_TO_LINEAR", "LIN_TO_LAB",
                                    "LAB_TO_LIN", "LINEAR_TO_GAMMA")]
    assert not ints[5:].any()
    assert np.array_equal(np.frombuffer(raw[4 * (1 + cc.MAX_STEPS):],
                                        np.float32), cc.constants())


def test_chain_kernel_constants_are_the_plain_versions_f32():
    from zignal_tpu_torch.ops import color_chain as cc

    table = cc.constants()
    assert table.dtype == np.float32
    for i, name in enumerate(cc.MATRICES):
        want = np.asarray(getattr(jax_color, "_" + name), np.float32).ravel()
        assert np.array_equal(table[9 * i:9 * i + 9], want), name
    k = dict(zip(cc.SCALARS, table[9 * len(cc.MATRICES):]))
    f32 = np.float32
    for name in ("SRGB_GAMMA_THRESHOLD", "SRGB_GAMMA_OFFSET",
                 "SRGB_GAMMA_SCALE", "SRGB_LINEAR_SLOPE", "D65_Y",
                 "SRGB_GAMMA_EXPONENT", "LAB_DELTA", "XYB_BIAS"):
        assert k[name] == f32(getattr(_scalar, name))
    assert k["SRGB_INV_GAMMA_EXPONENT"] == f32(1 / 2.4)
    assert k["ONE_THIRD"] == f32(1 / 3)
    # the reciprocal in f64, rounded once, as PyTorch's CUDA division by a
    # Python scalar takes it: for 1.055 and D65_X it is an ulp away from
    # f32(1) / f32(c)
    assert k["INV_255"] == f32(1 / 255)
    assert k["INV_D65_X"] == f32(1 / _scalar.D65_X)
    assert k["INV_D65_X"] != f32(1) / f32(_scalar.D65_X)
    assert k["INV_SRGB_GAMMA_SCALE"] == f32(1 / _scalar.SRGB_GAMMA_SCALE)
    assert k["INV_LAB_KAPPA_DIV_116"] == f32(1 / _scalar.LAB_KAPPA_DIV_116)


def test_build_compiles_every_kernel_source():
    from pathlib import Path

    from zignal_tpu_torch.ops import _build

    csrc = Path(_build.__file__).parent.parent / "csrc"
    assert sorted(_build._SOURCES) == sorted(csrc.glob("*.cu"))
