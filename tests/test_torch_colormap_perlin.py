"""The port's colormaps and Perlin noise against zignal_tpu on JAX-CPU,
``device="cpu"`` on the port's side.

Bounds: the LUTs are host copies: equal. ``Image.apply_colormap`` and
``ImageBatch.apply_colormap`` are u8: equal to the JAX package's Image
(eager: a true division by the range) and ImageBatch (compiled: a fixed
range becomes a multiplication by its f32 reciprocal, which differs from
the division at (0, 50) and (0, 100), for instance) on gray, RGB and RGBA
images, at the auto range (each image's own min and max, one image of the
batch spanning 0..50) and at fixed ranges. ``perlin`` is a host copy:
equal. ``perlin_array`` rounds each op in f32 as the JAX package's eager
version does: within 1e-6 absolute at amplitude 1 (0.0 measured here) and
the same bound scaled by the amplitude.
"""

import importlib

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.colormaps import Colormap as JColormap

import zignal_tpu_torch as zp
from zignal_tpu_torch.colormaps import Colormap

jperlin = importlib.import_module("zignal_tpu.perlin")
pperlin = importlib.import_module("zignal_tpu_torch.perlin")

CPU = "cpu"
MAPS = ("jet", "heat", "turbo", "viridis", "inferno")
RANGES = [(None, None), (13, 200), (0, 50), (0, 100), (1.5, 250.3),
          (200, 13), (-20.0, None), (None, 90)]
PERLIN_TOL = 1e-6  # absolute, at amplitude 1


def _plane_image(seed, c=3):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (24, 31, c), np.uint8)
    arr[0, 0] = 0
    return arr


def _batch():
    """Three RGB images with different ranges: one within 0..50 (where a
    reciprocal would round differently), a flat one, a full one."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 51, (20, 18, 3), np.uint8)
    a[0, 0] = (0, 0, 0)
    a[1, 1] = (50, 50, 50)
    b = np.full((20, 18, 3), 99, np.uint8)
    c = rng.integers(0, 256, (20, 18, 3), np.uint8)
    return np.stack([a, b, c])


@pytest.mark.parametrize("name", MAPS)
def test_every_lut_equals_jax(name):
    lut = Colormap(name).lut()
    assert lut.shape == (256, 3) and lut.dtype == np.uint8
    np.testing.assert_array_equal(lut, JColormap(name).lut())
    assert repr(getattr(Colormap, name)(1, 2)) == \
        repr(getattr(JColormap, name)(1, 2))


def test_colormap_factories_and_errors_match_jax():
    for name in MAPS:
        c = getattr(Colormap, name)()
        assert (c.type, c.min, c.max) == (name, None, None)
    c = Colormap.heat(min=-1.0)
    assert (c.min, c.max) == (-1.0, None)
    with pytest.raises(ValueError):
        Colormap("nope")
    with pytest.raises(TypeError):
        zp.Image(2, 2, device=CPU).apply_colormap("jet")
    with pytest.raises(TypeError):
        zp.ImageBatch(np.zeros((1, 2, 2, 3), np.uint8),
                      device=CPU).apply_colormap("jet")
    assert zp.Colormap is Colormap


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("rng", RANGES, ids=str)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_image_apply_colormap_equals_jax(name, rng, c):
    arr = _plane_image(c, c)
    got = zp.Image.from_numpy(arr.copy(), device=CPU).apply_colormap(
        Colormap(name, *rng))
    want = jz.Image.from_numpy(arr.copy()).apply_colormap(
        JColormap(name, *rng))
    assert got.dtype is zp.Rgb and got.device == torch.device(CPU)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("rng", RANGES, ids=str)
def test_batch_apply_colormap_equals_jax(name, rng):
    arr = _batch()
    got = zp.ImageBatch(arr, device=CPU).apply_colormap(Colormap(name, *rng))
    want = jz.ImageBatch(arr).apply_colormap(JColormap(name, *rng))
    assert got.dtype is zp.Rgb
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("rng", [(0, 50), (0, 100)], ids=str)
def test_the_two_roundings_differ_where_jax_differs(rng):
    """The Image (eager) and ImageBatch (compiled) forms part at these
    fixed ranges, in the port as in the JAX package."""
    plane = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    cm = Colormap("jet", *rng)
    eager = cm.apply_plane(plane)
    compiled = cm.apply_plane(plane, compiled=True)
    assert not torch.equal(eager, compiled)
    img = np.repeat(plane.numpy()[..., None], 3, -1)
    np.testing.assert_array_equal(
        eager.numpy(),
        jz.Image.from_numpy(img.copy()).apply_colormap(
            JColormap("jet", *rng)).to_numpy())
    np.testing.assert_array_equal(
        compiled.numpy(),
        jz.ImageBatch(img[None]).apply_colormap(
            JColormap("jet", *rng)).to_numpy()[0])


def test_gray_batch_and_per_image_auto_range():
    arr = _batch()[..., :1].copy()
    got = zp.ImageBatch(arr, device=CPU).apply_colormap(Colormap.turbo())
    want = jz.ImageBatch(arr).apply_colormap(JColormap.turbo())
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    # image 1 is flat: its own range is empty, so it maps to index 0
    np.testing.assert_array_equal(
        got.to_numpy()[1], np.broadcast_to(Colormap.turbo().lut()[0],
                                           (20, 18, 3)))


# -- Perlin -------------------------------------------------------------------

PERLIN_ARGS = [dict(), dict(z=0.37, octaves=4, frequency=0.05),
               dict(z=-3.2, octaves=8, persistence=0.7, lacunarity=2.3,
                    amplitude=2.5, frequency=0.013),
               dict(z=12.0, octaves=32, persistence=1.0, lacunarity=1.0),
               dict(octaves=3, persistence=0.25, frequency=7.5)]


@pytest.mark.parametrize("kw", PERLIN_ARGS, ids=str)
def test_perlin_scalar_equals_jax(kw):
    for x, y in [(0.0, 0.0), (1.3, 2.7), (-4.1, 9.9), (255.5, -256.25)]:
        assert pperlin.perlin(x, y, **kw) == jperlin.perlin(x, y, **kw)
    assert zp.perlin is pperlin.perlin


@pytest.mark.parametrize("kw", PERLIN_ARGS, ids=str)
def test_perlin_array_within_bound_of_jax(kw):
    rng = np.random.default_rng(0)
    xs = rng.uniform(-300, 300, (48, 40)).astype(np.float32)
    ys = rng.uniform(-300, 300, (48, 40)).astype(np.float32)
    want = np.asarray(jperlin.perlin_array(xs, ys, **kw))
    got = pperlin.perlin_array(xs, ys, device=CPU, **kw)
    assert got.dtype == torch.float32 and got.device == torch.device(CPU)
    tol = PERLIN_TOL * kw.get("amplitude", 1.0)
    assert float(np.abs(got.numpy() - want).max()) <= tol
    from_tensors = pperlin.perlin_array(torch.from_numpy(xs),
                                        torch.from_numpy(ys), **kw)
    assert torch.equal(from_tensors, got)


def test_perlin_array_on_a_grid_and_its_errors():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) * 0.1
    want = np.asarray(jperlin.perlin_array(xx, yy, octaves=4))
    got = zp.perlin_array(xx.tolist(), yy.tolist(), octaves=4, device=CPU)
    assert float(np.abs(got.numpy() - want).max()) <= PERLIN_TOL
    with pytest.raises(ValueError, match="device="):
        zp.perlin_array(xx, yy)
    for bad in (dict(amplitude=0), dict(frequency=-1), dict(octaves=0),
                dict(persistence=1.5), dict(lacunarity=0.5)):
        with pytest.raises(ValueError):
            zp.perlin_array(xx, yy, device=CPU, **bad)
        with pytest.raises(ValueError):
            zp.perlin(0.5, 0.5, **bad)
