"""The port's edge detectors (ops/edges.py: Canny, the ISEF filter,
Shen-Castan) and ``ImageBatch.sobel`` / ``.canny`` / ``.shen_castan``
against the JAX package on JAX-CPU. The masks are array_equal on every
test image; the ISEF's f32 values are held to the bound stated below.
Inputs come from numpy with a seed and go to both packages as the same
arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.ops import edges as jax_edges

import zignal_tpu_torch as zp
from zignal_tpu_torch.ops import edges

H, W = 24, 32
# ISEF bound (max-abs against the jitted JAX filter, which is how
# shen_castan runs it): measured 0.0 on every shape but the one-column
# plane, where XLA contracts the column pass's multiply-adds differently:
# 1.5e-5 on 0-255 data, 1.2e-7 on 0-1 data
ISEF_F255_TOL, ISEF_F01_TOL = 1e-4, 1e-6

_jax_isef = jax.jit(jax_edges.isef_filter, static_argnums=1)


def _images(h=H, w=W, seed=0):
    """The test planes (0-255 integers in f32): a step edge, a gradient
    with noise, a flat plane and a noisy disc."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    step = np.where(xx >= w // 2, 220.0, 20.0)
    grad = xx * (0.7 * 255 / w) + yy * (0.3 * 255 / h) \
        + rng.normal(0, 20, (h, w))
    flat = np.full((h, w), 100.0)
    disc = np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2
                    < (min(h, w) / 3) ** 2, 210.0, 30.0) \
        + rng.normal(0, 5, (h, w))
    return {name: np.clip(np.round(p), 0, 255).astype(np.float32)
            for name, p in (("step", step), ("grad", grad), ("flat", flat),
                            ("disc", disc))}


IMAGES = _images()


@pytest.mark.parametrize("sigma", [1.4, 0.0, 0.8])
@pytest.mark.parametrize("name", list(IMAGES))
def test_canny_matches_jax(name, sigma):
    x = IMAGES[name]
    got = edges.canny(torch.from_numpy(x), sigma).numpy()
    want = np.asarray(jax_edges.canny(jnp.asarray(x), sigma))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    if name == "flat":
        assert not got.any()


def test_canny_thresholds_match_jax():
    x = IMAGES["grad"]
    for low, high in ((5.0, 20.0), (0.0, 1.0)):
        got = edges.canny(torch.from_numpy(x), 1.0, low, high).numpy()
        want = np.asarray(jax_edges.canny(jnp.asarray(x), 1.0, low, high))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("use_nms", [False, True], ids=["thin", "nms"])
@pytest.mark.parametrize("hysteresis", [True, False], ids=["hyst", "thr"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_shen_castan_matches_jax(name, hysteresis, use_nms):
    x = IMAGES[name]
    got = edges.shen_castan(torch.from_numpy(x), hysteresis=hysteresis,
                            use_nms=use_nms).numpy()
    want = np.asarray(jax_edges.shen_castan(
        jnp.asarray(x), hysteresis=hysteresis, use_nms=use_nms))
    assert np.array_equal(got, want)


def test_shen_castan_options_match_jax():
    x = IMAGES["disc"]
    kw = dict(smooth=0.6, window_size=5, high_ratio=0.8, low_rel=0.3)
    got = edges.shen_castan(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jax_edges.shen_castan(jnp.asarray(x), **kw))
    assert np.array_equal(got, want)


def test_edges_on_a_batch_equal_each_plane():
    """The port takes ``[B, H, W]`` directly (the JAX package maps one
    plane at a time): each plane's thresholds stay its own."""
    x = np.stack([IMAGES["grad"], IMAGES["flat"], IMAGES["disc"]])
    xt = torch.from_numpy(x)
    canny, shen = edges.canny(xt).numpy(), edges.shen_castan(xt).numpy()
    for i in range(len(x)):
        assert np.array_equal(canny[i], edges.canny(xt[i]).numpy())
        assert np.array_equal(shen[i], edges.shen_castan(xt[i]).numpy())


def test_hysteresis_fixpoint_does_not_depend_on_steps_per_test(monkeypatch):
    x = torch.from_numpy(IMAGES["grad"])
    want = edges.canny(x, 1.0, 5.0, 40.0)
    monkeypatch.setattr(edges, "_GROWTH_STEPS", 1)
    assert torch.equal(edges.canny(x, 1.0, 5.0, 40.0), want)


@pytest.mark.parametrize("shape", [(H, W), (1, 40), (40, 1), (5, 130)],
                         ids=lambda s: "x".join(map(str, s)))
def test_isef_filter_within_bound_of_jax(shape):
    rng = np.random.default_rng(3)
    for b in (0.9, 0.3):
        for scale, tol in ((255.0, ISEF_F255_TOL), (1.0, ISEF_F01_TOL)):
            x = (rng.random(shape, np.float32) * np.float32(scale)) \
                .astype(np.float32)
            got = edges.isef_filter(torch.from_numpy(x), b).numpy()
            want = np.asarray(_jax_isef(jnp.asarray(x), b))
            assert got.dtype == np.float32
            assert float(np.abs(got - want).max()) <= tol


def test_isef_filter_is_the_serial_recursion():
    """The scan computes the reference's forward and backward IIR."""
    x = np.random.default_rng(4).random((3, 11)).astype(np.float64) * 255
    b = 0.7
    got = edges.isef_filter(torch.from_numpy(x.astype(np.float32)), b)

    def iir(v):
        t = np.empty_like(v)
        t[0] = b * v[0]
        for i in range(1, len(v)):
            t[i] = (1 - b) * t[i - 1] + b * v[i]
        out = np.empty_like(v)
        out[-1] = t[-1]
        for i in range(len(v) - 2, -1, -1):
            out[i] = (1 - b) * out[i + 1] + b * t[i]
        return out

    rows = np.apply_along_axis(iir, 1, x)
    want = np.apply_along_axis(iir, 0, rows)
    assert np.abs(got.numpy() - want).max() <= 1e-4


def _rgb(seed=5):
    img = np.stack([IMAGES["disc"], IMAGES["grad"], IMAGES["step"]], -1)
    noise = np.random.default_rng(seed).integers(0, 30, (2, H, W, 3))
    return np.clip(img[None] + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("method,kw", [
    ("sobel", {}), ("canny", {}), ("canny", dict(sigma=0.0, low=10,
                                                 high=60)),
    ("shen_castan", {}), ("shen_castan", dict(use_nms=True,
                                              hysteresis=False))])
def test_image_batch_edges_match_jax(method, kw):
    x = _rgb()
    got = getattr(zp.ImageBatch(x, device="cpu"), method)(**kw)
    want = getattr(jz.ImageBatch(x), method)(**kw)
    assert got.channels == 1
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_canny_validation_matches_jax():
    x = _rgb()
    for kw in (dict(sigma=-1.0), dict(low=-1.0), dict(low=60, high=50)):
        with pytest.raises(ValueError, match="sigma >= 0"):
            jz.ImageBatch(x).canny(**kw)
        with pytest.raises(ValueError, match="sigma >= 0"):
            zp.ImageBatch(x, device="cpu").canny(**kw)
