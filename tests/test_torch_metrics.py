"""The port's image-quality metrics and diff (ops/metrics.py, ops/diff.py)
on both containers against zignal_tpu on JAX-CPU, ``device="cpu"`` on the
port's side.

Bounds: ``Image.psnr`` and ``Image.mean_pixel_error`` are host f64 and
``Image.diff`` host numpy in both packages: equal. ``ImageBatch.diff``'s
visualisation and counts are equal. The f32 reductions, ``Image.ssim``
and ``ImageBatch``'s ``psnr``, ``mean_pixel_error`` and ``ssim``, sum in
another order than XLA: within 1e-5 relative (PSNR, MPE) and 1e-5
absolute (SSIM, in [-1, 1]).
"""

import numpy as np
import pytest

import zignal_tpu as jz

import zignal_tpu_torch as zp

CPU = "cpu"
REL = 1e-5
SSIM_ABS = 1e-5


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _near(shape, seed, spread=12):
    """A second image close to ``_u8(shape, seed)``, as a blur or a codec
    would leave it."""
    rng = np.random.default_rng(seed + 100)
    a = _u8(shape, seed).astype(np.int64)
    return np.clip(a + rng.integers(-spread, spread + 1, shape), 0, 255) \
        .astype(np.uint8)


def _images(arr):
    return (zp.Image.from_numpy(arr.copy(), device=CPU),
            jz.Image.from_numpy(arr.copy()))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_image_metrics_match_jax(channels):
    shape = (23, 31, channels)
    pa, ja = _images(_u8(shape, channels))
    pb, jb = _images(_near(shape, channels))
    assert pa.psnr(pb) == ja.psnr(jb)
    assert pa.mean_pixel_error(pb) == ja.mean_pixel_error(jb)
    assert abs(pa.ssim(pb) - ja.ssim(jb)) <= SSIM_ABS
    assert isinstance(pa.ssim(pb), float)


def test_identical_images_score_inf_and_one():
    a = _u8((16, 18, 3), 1)
    pa, ja = _images(a)
    pb, _ = _images(a)
    assert pa.psnr(pb) == float("inf") == ja.psnr(ja)
    assert pa.ssim(pb) == 1.0 == ja.ssim(ja)
    assert pa.mean_pixel_error(pb) == 0.0
    batch = zp.ImageBatch(np.stack([a, a]), device=CPU)
    assert bool((batch.psnr(batch) == float("inf")).all())
    assert batch.ssim(batch).tolist() == [1.0, 1.0]


@pytest.mark.parametrize("opts", [dict(), dict(threshold=4.5),
                                  dict(threshold=3, scale=2.5),
                                  dict(binary=True, threshold=7),
                                  dict(force_opaque=True, scale=0.3)])
def test_image_diff_matches_jax(opts):
    shape = (14, 17, 4)
    pa, ja = _images(_u8(shape, 2))
    pb, jb = _images(_near(shape, 2))
    pv, pr = pa.diff(pb, **opts)
    jv, jr = ja.diff(jb, **opts)
    assert pv.dtype is zp.Rgba and pv.device.type == "cpu"
    assert np.array_equal(pv.to_numpy(), jv.to_numpy())
    assert pr.diff_count == jr.diff_count
    for name in ("count", "mean", "variance", "min", "max"):
        assert getattr(pr.stats, name) == getattr(jr.stats, name)


@pytest.mark.parametrize("opts", [dict(), dict(threshold=4.5),
                                  dict(threshold=3, scale=1.7),
                                  dict(binary=True, threshold=7),
                                  dict(force_opaque=True, scale=0.3)])
@pytest.mark.parametrize("channels", [3, 4])
def test_batch_diff_matches_jax(channels, opts):
    shape = (3, 15, 19, channels)
    a, b = _u8(shape, 3), _near(shape, 3)
    pv, pc = zp.ImageBatch(a, device=CPU).diff(
        zp.ImageBatch(b, device=CPU), **opts)
    jv, jc = jz.ImageBatch(a).diff(jz.ImageBatch(b), **opts)
    assert np.array_equal(pv.to_numpy(), jv.to_numpy())
    assert pc.tolist() == np.asarray(jc).tolist()
    # and the per-image counts are Image.diff's
    for i in range(3):
        _, res = zp.Image.from_numpy(a[i].copy(), device=CPU).diff(
            zp.Image.from_numpy(b[i].copy(), device=CPU),
            **{k: v for k, v in opts.items() if k != "scale"})
        assert res.diff_count == int(pc[i])


@pytest.mark.parametrize("channels", [1, 3])
def test_batch_metrics_match_jax(channels):
    shape = (4, 26, 30, channels)
    a, b = _u8(shape, 4), _near(shape, 4, spread=40)
    pa, pb = zp.ImageBatch(a, device=CPU), zp.ImageBatch(b, device=CPU)
    ja, jb = jz.ImageBatch(a), jz.ImageBatch(b)
    for name, tol in (("psnr", REL), ("mean_pixel_error", REL)):
        got = getattr(pa, name)(pb).numpy()
        want = np.asarray(getattr(ja, name)(jb))
        assert got.shape == (4,)
        np.testing.assert_allclose(got, want, rtol=tol)
    got = pa.ssim(pb).numpy()
    assert np.abs(got - np.asarray(ja.ssim(jb))).max() <= SSIM_ABS
    # the batch's f32 PSNR against the host f64 Image.psnr
    for i in range(4):
        host = zp.Image.from_numpy(a[i].copy(), device=CPU).psnr(
            zp.Image.from_numpy(b[i].copy(), device=CPU))
        assert abs(float(pa.psnr(pb)[i]) - host) <= REL * host


def test_metric_inputs_are_checked():
    a = zp.ImageBatch(_u8((2, 12, 12, 3), 5), device=CPU)
    with pytest.raises(ValueError):
        a.psnr(zp.ImageBatch(_u8((2, 12, 13, 3), 5), device=CPU))
    with pytest.raises(ValueError):
        a.ssim(a.convert(zp.Rgba))
    with pytest.raises(TypeError):
        a.mean_pixel_error(a[0])
    small = zp.ImageBatch(_u8((1, 10, 12, 1), 6), device=CPU)
    with pytest.raises(ValueError):
        small.ssim(small)
    img = zp.Image.from_numpy(_u8((10, 12, 1), 6), device=CPU)
    with pytest.raises(ValueError):
        img.ssim(img)
    with pytest.raises(ValueError):
        img.psnr(zp.Image.from_numpy(_u8((10, 11, 1), 6), device=CPU))
