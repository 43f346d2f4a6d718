"""The port's histograms, LUTs, Otsu, equalize and autocontrast, and the
ImageBatch methods on them, against zignal_tpu on JAX-CPU
(zignal_tpu_torch/ops/binary.py, ops/enhancement.py, batch.py). Every
output is an integer: all comparisons are array_equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zignal_tpu as jz
from zignal_tpu.ops import binary as jax_binary
from zignal_tpu.ops import enhancement as jax_enh

import zignal_tpu_torch as zp
from zignal_tpu_torch import pipeline
from zignal_tpu_torch.ops import binary, enhancement

BENCH_CHAIN = ("rgb", "lab", "rgb", "oklch", "rgb", "xyb", "rgb")


def _u8(shape, seed, hi=256):
    return np.random.default_rng(seed).integers(0, hi, shape, np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- histograms and LUTs ------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 53), (2, 64, 128), (1,), (300,)])
def test_histogram256_matches_jax(shape):
    x = _u8(shape, 0)
    got = binary.histogram256(_t(x))
    assert got.dtype == torch.int32 and got.shape == (256,)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax_binary.histogram256(jnp.asarray(x))))


def test_weighted_histogram256_matches_jax():
    x = _u8((40, 60), 1)
    w = _u8((40, 60), 2, hi=2)
    got = binary.histogram256(_t(x), _t(w))
    want = jax_binary.histogram256(jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_histogram256_skips_values_outside_the_bins():
    x = torch.tensor([-1, 0, 255, 256, 7, 7], dtype=torch.int32)
    got = binary.histogram256(x)
    want = jax_binary.histogram256(jnp.asarray(x.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 4


@pytest.mark.parametrize("c", [1, 3, 4])
def test_histogram256_multi_matches_jax(c):
    x = _u8((33, 70, c), 3)
    got = binary.histogram256_multi(_t(x))
    assert got.shape == (c, 256) and got.dtype == torch.int32
    assert np.array_equal(
        got.numpy(), np.asarray(jax_binary.histogram256_multi(jnp.asarray(x))))
    batch = binary.histogram256_batch(_t(np.stack([x, x[::-1] // 2])))
    assert batch.shape == (2, c, 256)
    assert np.array_equal(batch[0].numpy(), got.numpy())
    assert np.array_equal(batch[1].numpy(), np.asarray(
        jax_binary.histogram256_multi(jnp.asarray(x[::-1] // 2))))


@pytest.mark.parametrize("lut_shape", [(256,), (256, 3), (256, 1)])
def test_lut_apply_u8_matches_jax(lut_shape):
    x = _u8((19, 31), 4)
    lut = _u8(lut_shape, 5)
    got = binary.lut_apply_u8(_t(x), _t(lut))
    want = np.asarray(jax_binary.lut_apply_u8(jnp.asarray(x),
                                              jnp.asarray(lut)))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_lut_apply_u8_per_channel_matches_jax(c):
    x = _u8((2, 23, 29, c), 6)
    luts = _u8((2, c, 256), 7)
    got = binary.lut_apply_u8_per_channel(_t(x), _t(luts))
    for i in range(2):
        want = jax_binary.lut_apply_u8_per_channel(jnp.asarray(x[i]),
                                                   jnp.asarray(luts[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(want))
        assert np.array_equal(binary.lut_apply_u8_per_channel(
            _t(x[i]), _t(luts[i])).numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,shape", [(8, (64, 96)), (9, (1, 300)),
                                        (10, (128, 128))])
def test_otsu_threshold_matches_jax(seed, shape):
    x = _u8(shape, seed)
    x[: shape[0] // 2] //= 3                       # a bimodal plane
    got = binary.otsu_threshold(_t(x))
    assert isinstance(got, int)
    assert got == jax_binary.otsu_threshold(jnp.asarray(x))


def test_otsu_threshold_of_a_flat_plane_matches_jax():
    x = np.full((8, 8), 77, np.uint8)
    assert binary.otsu_threshold(_t(x)) == \
        jax_binary.otsu_threshold(jnp.asarray(x))


# -- equalize and autocontrast --------------------------------------------------


def _images(c, seed):
    """Two images with different ranges: one full, one squeezed low."""
    x = _u8((2, 48, 64, c), seed)
    x[1] = 40 + x[1] // 4
    return x


@pytest.mark.parametrize("skip_alpha", [True, False])
@pytest.mark.parametrize("cutoff", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_autocontrast_matches_jax(c, cutoff, skip_alpha):
    x = _images(c, 11)
    got = enhancement.autocontrast(_t(x), cutoff, skip_alpha)
    for i in range(2):
        want = jax_enh.autocontrast(jnp.asarray(x[i]), cutoff, skip_alpha)
        assert np.array_equal(got[i].numpy(), np.asarray(want))
    one = enhancement.autocontrast(_t(x[1]), cutoff, skip_alpha)
    assert np.array_equal(one.numpy(), got[1].numpy())


@pytest.mark.parametrize("skip_alpha", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_equalize_matches_jax(c, skip_alpha):
    x = _images(c, 12)
    got = enhancement.equalize(_t(x), skip_alpha)
    for i in range(2):
        want = jax_enh.equalize(jnp.asarray(x[i]), skip_alpha)
        assert np.array_equal(got[i].numpy(), np.asarray(want))
    assert np.array_equal(enhancement.equalize(_t(x[0]), skip_alpha).numpy(),
                          got[0].numpy())


def test_equalize_and_autocontrast_of_flat_images_match_jax():
    x = np.full((16, 16, 3), 9, np.uint8)
    x[..., 1] = 0
    for fn, jfn in ((enhancement.equalize, jax_enh.equalize),
                    (enhancement.autocontrast, jax_enh.autocontrast)):
        assert np.array_equal(fn(_t(x)).numpy(),
                              np.asarray(jfn(jnp.asarray(x))))


def test_cutoff_pixels_is_the_f32_product():
    assert enhancement.cutoff_pixels(128 * 128, 0.01) == 163
    for total in (1, 3000, 1 << 20, 3 * 1021 * 997):
        for cutoff in (0.0, 0.01, 0.1, 0.3, 0.49):
            want = int(jnp.trunc(jnp.float32(total) * jnp.float32(cutoff)))
            assert enhancement.cutoff_pixels(total, cutoff) == want


@pytest.mark.parametrize("skip_alpha", [True, False])
def test_equalize_from_hists_wraps_as_the_reference_u32(skip_alpha):
    """A histogram of 2^25 pixels: (cdf - cdf_min) * 255 passes 2^32, and
    the reference's u32 product wraps; the port gives the same LUT."""
    rng = np.random.default_rng(13)
    hists = np.zeros((4, 256), np.int64)
    for c in range(4):
        w = rng.random(256) * (rng.random(256) < 0.6)
        w[rng.integers(0, 256)] += 1.0
        counts = np.floor(w / w.sum() * (1 << 25)).astype(np.int64)
        counts[np.argmax(counts)] += (1 << 25) - counts.sum()
        hists[c] = counts
    assert (hists.sum(axis=1) == 1 << 25).all()
    x = np.tile(np.arange(256, dtype=np.uint8)[:, None, None], (1, 3, 4))
    got = enhancement.equalize_from_hists(_t(x), _t(hists.astype(np.int32)),
                                          1 << 25, skip_alpha)
    want = jax_enh.equalize_from_hists(jnp.asarray(x),
                                       jnp.asarray(hists.astype(np.int32)),
                                       1 << 25, skip_alpha)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the wrap changed the LUT: the int64 product without it differs
    cdf = np.cumsum(hists, axis=1)
    cdf_min = np.array([row[row > 0][0] for row in cdf])
    exact = (cdf - cdf_min[:, None]) * 255 // ((1 << 25) - cdf_min[:, None])
    assert not np.array_equal(np.where(cdf >= cdf_min[:, None], exact, 0),
                              (got.numpy()[:, 0, :].T))


# -- ImageBatch ---------------------------------------------------------------


def _example_batch():
    """examples/image_batch.py's batch (rolled copies), at [2,128,128,3]."""
    base = _u8((128, 128, 3), 14)
    base[32:96, 32:96] //= 4
    return np.stack([np.roll(base, i * 11, axis=1) for i in range(2)])


def test_image_batch_example_chain_matches_jax():
    """examples/image_batch.py:38-42 without the mesh."""
    x = _example_batch()
    got = (zp.ImageBatch(x, device="cpu").resize((64, 64))
           .gaussian_blur(1.5).autocontrast(0.01).convert(zp.Gray).equalize())
    want = (jz.ImageBatch(x).resize((64, 64)).gaussian_blur(1.5)
            .autocontrast(0.01).convert(jz.Gray).equalize())
    assert got.channels == 1
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_otsu_matches_jax():
    """examples/image_batch.py:63 without the mesh."""
    x = _example_batch()
    got, t = zp.ImageBatch(x, device="cpu").convert(zp.Gray).threshold_otsu()
    want, wt = jz.ImageBatch(x).convert(jz.Gray).threshold_otsu()
    assert t.dtype == np.int32 and t.shape == (2,)
    assert np.array_equal(t, wt)
    assert np.array_equal(got.to_numpy(), want.to_numpy())
    rgb, t_rgb = zp.ImageBatch(x, device="cpu").threshold_otsu()
    assert np.array_equal(t_rgb, t)
    assert np.array_equal(rgb.to_numpy(), got.to_numpy())


@pytest.mark.parametrize("c", [1, 3, 4])
def test_image_batch_histogram_equalize_autocontrast_match_jax(c):
    x = _images(c, 15)
    ib, jb = zp.ImageBatch(x, device="cpu"), jz.ImageBatch(x)
    assert np.array_equal(ib.histogram().numpy(),
                          np.asarray(jb.histogram()))
    assert np.array_equal(ib.equalize().to_numpy(), jb.equalize().to_numpy())
    assert np.array_equal(ib.autocontrast(0.05).to_numpy(),
                          jb.autocontrast(0.05).to_numpy())


CONVERSIONS = [(a, b) for a in (1, 3, 4) for b in ("gray", "rgb", "rgba")]
_DTYPES = {"gray": "Gray", "rgb": "Rgb", "rgba": "Rgba"}


@pytest.mark.parametrize("c,space", CONVERSIONS,
                         ids=[f"{c}-{s}" for c, s in CONVERSIONS])
def test_image_batch_convert_matches_jax(c, space):
    x = _u8((2, 9, 11, c), 16)
    jspace = getattr(jz, _DTYPES[space])
    got = zp.ImageBatch(x, device="cpu").convert(getattr(zp, _DTYPES[space]))
    assert got.dtype is getattr(zp, _DTYPES[space])
    # ops keep the tag; a gray result of an op on a colour batch is Gray
    assert got.box_blur(1).dtype is got.dtype
    assert got.sobel().dtype is zp.Gray
    assert np.array_equal(got.to_numpy(),
                          jz.ImageBatch(x).convert(jspace).to_numpy())


def test_image_batch_validation_matches_jax():
    x = _u8((1, 8, 8, 3), 17)
    ib, jb = zp.ImageBatch(x, device="cpu"), jz.ImageBatch(x)
    for cutoff in (-0.1, 0.5, 0.7):
        with pytest.raises(ValueError, match="cutoff"):
            ib.autocontrast(cutoff)
        with pytest.raises(ValueError, match="cutoff"):
            jb.autocontrast(cutoff)
    with pytest.raises(TypeError):
        ib.convert(zp.Lab)
    with pytest.raises(TypeError):
        jb.convert(jz.Lab)


def test_config2_step_matches_jax():
    """bench.py's config-2 step: color_chain_u8 -> equalize(u8[0]) ->
    autocontrast(u8[1])."""
    from zignal_tpu.pipeline import color_chain_u8 as jax_chain_u8

    x = _u8((2, 32, 64, 3), 18)
    u8 = pipeline.color_chain_u8(_t(x), BENCH_CHAIN)
    ju8 = jax_chain_u8(jnp.asarray(x), BENCH_CHAIN)
    assert np.array_equal(u8.numpy(), np.asarray(ju8))
    assert np.array_equal(enhancement.equalize(u8[0]).numpy(),
                          np.asarray(jax_enh.equalize(ju8[0])))
    assert np.array_equal(enhancement.autocontrast(u8[1]).numpy(),
                          np.asarray(jax_enh.autocontrast(ju8[1])))
