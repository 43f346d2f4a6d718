"""The port's motion blur (ops/motion_blur_ops.py, Image.motion_blur,
ImageBatch.motion_blur) against zignal_tpu on JAX-CPU, with
``device="cpu"`` on the port's side.

u8 outputs are held equal to JAX's ``Image.motion_blur``: both linear
routes (the axis-aligned box filter and the oblique bilinear taps), zoom
and spin, for both containers. A float input's oblique linear blur is
within 4e-5 of JAX (its weights are constants of JAX's program, and XLA
picks which product of each tap it fuses; an f32 ulp at 255 is 1.5e-5);
its radial blurs are equal.
"""

import math

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.ops import motion_blur_ops as jm

import zignal_tpu_torch as zp
from zignal_tpu_torch.ops import motion_blur_ops as pm

CPU = "cpu"

LINEAR = [(0.0, 9), (math.pi / 2, 10), (math.pi, 4), (3 * math.pi / 2, 1),
          (0.7, 9), (2.0, 6), (-0.4, 3), (4.0, 5)]
RADIAL = [("zoom", (0.5, 0.5), 0.5), ("zoom", (0.4, 0.6), 0.7),
          ("spin", (0.5, 0.5), 0.5), ("spin", (0.3, 0.7), 0.8),
          ("zoom", (0.0, 1.0), 0.25), ("spin", (1.0, 0.0), 0.1)]
SHAPE = (36, 44, 3)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _configs(ns, kind, *args):
    if kind == "linear":
        return ns.MotionBlur.linear(*args)
    return getattr(ns.MotionBlur, f"radial_{kind}")(*args)


def _equal(p, j):
    p, j = np.asarray(p), np.asarray(j)
    assert p.shape == j.shape and p.dtype == j.dtype
    assert np.array_equal(p, j), f"{int((p != j).sum())} values differ"


@pytest.mark.parametrize("angle,distance", LINEAR)
def test_linear_blur_matches_jax(angle, distance):
    x = _u8((40, 52, 3), 1)
    got = zp.Image.from_numpy(x.copy(), device=CPU).motion_blur(
        zp.MotionBlur.linear(angle, distance))
    want = jz.Image.from_numpy(x.copy()).motion_blur(
        jz.MotionBlur.linear(angle, distance))
    _equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("kind,center,strength", RADIAL)
def test_radial_blur_matches_jax(kind, center, strength):
    x = _u8(SHAPE, 2)
    got = zp.Image.from_numpy(x.copy(), device=CPU).motion_blur(
        _configs(zp, kind, center, strength))
    want = jz.Image.from_numpy(x.copy()).motion_blur(
        _configs(jz, kind, center, strength))
    _equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("channels", [1, 4])
def test_blurs_of_gray_and_rgba_match_jax(channels):
    x = _u8((30, 34, channels), 3)
    for cfg in (("linear", 0.0, 5), ("linear", 1.1, 4),
                ("spin", (0.5, 0.5), 0.1)):
        got = zp.Image.from_numpy(x.copy(), device=CPU).motion_blur(
            _configs(zp, *cfg))
        want = jz.Image.from_numpy(x.copy()).motion_blur(_configs(jz, *cfg))
        _equal(got.to_numpy(), want.to_numpy())


def test_float_inputs_are_within_bounds_of_jax():
    rng = np.random.default_rng(4)
    x = (rng.integers(0, 256, (32, 40, 3)) + rng.random((32, 40, 3))) \
        .astype(np.float32)
    for angle, distance in ((0.0, 7), (0.7, 9), (2.0, 6)):
        got = pm.linear_motion_blur(torch.from_numpy(x), angle, distance)
        want = np.asarray(jm.linear_motion_blur(x, angle, distance))
        assert got.dtype == torch.float32
        assert float(np.abs(got.numpy() - want).max()) <= 4e-5
    for zoom in (True, False):
        got = pm.radial_blur(torch.from_numpy(x), 0.4, 0.6, 0.7, zoom)
        _equal(got.numpy(), jm.radial_blur(x, 0.4, 0.6, 0.7, zoom))


@pytest.mark.parametrize("cfg", [("linear", 0.0, 9), ("linear", 0.7, 9),
                                 ("zoom", (0.4, 0.6), 0.7),
                                 ("spin", (0.3, 0.7), 0.8)])
def test_image_batch_blur_equals_jax_image_blur_on_every_image(cfg):
    x = _u8((2, *SHAPE), 2)
    got = zp.ImageBatch(x, device=CPU).motion_blur(_configs(zp, *cfg))
    assert got.dtype is zp.Rgb
    for i in range(2):
        want = jz.Image.from_numpy(x[i].copy()).motion_blur(
            _configs(jz, *cfg))
        _equal(got.device_array()[i].numpy(), want.to_numpy())


def test_batch_spin_pins_the_jax_image_path_not_its_batch_path():
    """The JAX package's ImageBatch.motion_blur vmaps radial_blur, whose
    traced input takes the device-coordinate fallback (_radial_device):
    its spin departs from its own Image.motion_blur (a JAX-side fault,
    ROADMAP §3). The port's batch takes the host-coordinate route and
    equals JAX's Image path on every image."""
    x = _u8((2, *SHAPE), 2)
    cfg = ("spin", (0.3, 0.7), 0.8)
    ours = zp.ImageBatch(x, device=CPU).motion_blur(_configs(zp, *cfg))
    images = np.stack([jz.Image.from_numpy(x[i].copy()).motion_blur(
        _configs(jz, *cfg)).to_numpy() for i in range(2)])
    jax_batch = jz.ImageBatch(x).motion_blur(_configs(jz, *cfg)).to_numpy()
    _equal(ours.to_numpy(), images)
    d = np.abs(jax_batch.astype(int) - images.astype(int))
    assert d.max() > 1, "JAX's batch spin now equals its Image path"


def test_axis_aligned_linear_blur_is_the_separable_convolution():
    from zignal_tpu_torch.ops.convolution import convolve_separable

    x = torch.from_numpy(_u8((2, 20, 24, 3), 7))
    for angle, kx, ky in ((0.0, (0.25,) * 4, (1.0,)),
                          (math.pi / 2, (1.0,), (0.25,) * 4)):
        want = convolve_separable(x, kx, ky, zp.BorderMode.REPLICATE)
        assert torch.equal(pm.linear_motion_blur(x, angle, 4), want)


def test_radial_coordinates_are_cached_a_configuration():
    pm._COORDS.clear()
    x = torch.from_numpy(_u8((1, 12, 16, 1), 8))
    first = pm.radial_coords(12, 16, 0.5, 0.5, 0.5, True, x.device)
    assert first[0].shape == (20, 12, 16)
    assert pm.radial_coords(12, 16, 0.5, 0.5, 0.5, True, x.device) is first
    for k in range(pm._COORDS_MAX + 1):
        pm.radial_coords(12, 16, 0.5, 0.5, 0.1 + 0.01 * k, False, x.device)
    assert len(pm._COORDS) == pm._COORDS_MAX


def test_zero_strength_and_distance_return_the_input():
    x = _u8((1, 10, 12, 3), 9)
    b = zp.ImageBatch(x, device=CPU)
    for cfg in (zp.MotionBlur.linear(0.3, 0),
                zp.MotionBlur.radial_zoom((0.5, 0.5), 0.0)):
        assert np.array_equal(b.motion_blur(cfg).to_numpy(), x)


def test_motion_blur_config_matches_jax_and_validates():
    for p, j in ((zp.MotionBlur.linear(0.5, 7), jz.MotionBlur.linear(0.5, 7)),
                 (zp.MotionBlur.radial_spin((0.2, 0.9), 0.3),
                  jz.MotionBlur.radial_spin((0.2, 0.9), 0.3))):
        assert repr(p) == repr(j)
    with pytest.raises(ValueError):
        zp.MotionBlur.linear(0.0, -1)
    with pytest.raises(ValueError):
        zp.MotionBlur.radial_zoom((1.5, 0.5))
    with pytest.raises(ValueError):
        zp.MotionBlur.radial_spin((0.5, 0.5), 2.0)
    with pytest.raises(TypeError):
        zp.ImageBatch(_u8((1, 8, 8, 3), 0), device=CPU).motion_blur("zoom")
