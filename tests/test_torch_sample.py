"""The port's point sampling, ``ops.warp.sample``, against zignal_tpu's
``ops.warp.sample`` on JAX-CPU: every method, every border, u8 and f32,
1-px MIRROR axes and a batch sharing one set of host coordinates. Every
output is held equal (the kernel methods' weights place their fused
multiply-adds where XLA's CPU backend does, ops/fma.py).
"""

import numpy as np
import pytest
import torch

from zignal_tpu.enums import BorderMode as JB
from zignal_tpu.enums import Interpolation as JI
from zignal_tpu.ops import warp as jw

from zignal_tpu_torch import BorderMode, Interpolation
from zignal_tpu_torch.ops import warp as pw

METHODS = [m.name for m in Interpolation]
BORDERS = [b.name for b in BorderMode]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _f32(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape) + rng.random(shape)).astype(
        np.float32)


def _coords(shape_out, h, w, seed, margin=6.0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-margin, w - 1 + margin, shape_out).astype(np.float32)
    ys = rng.uniform(-margin, h - 1 + margin, shape_out).astype(np.float32)
    return xs, ys


def _equal(p, j):
    p, j = p.numpy(), np.asarray(j)
    assert p.shape == j.shape and p.dtype == j.dtype
    assert np.array_equal(p, j), f"{int((p != j).sum())} values differ"


# -- sample -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("method", METHODS)
def test_sample_matches_jax(method, border, dtype):
    make = _u8 if dtype == "u8" else _f32
    arr = make((20, 28, 3), METHODS.index(method))
    xs, ys = _coords((12, 16), 20, 28, BORDERS.index(border))
    want = jw.sample(arr, xs, ys, JI[method], JB[border])
    got = pw.sample(torch.from_numpy(arr), xs, ys, Interpolation[method],
                    BorderMode[border])
    _equal(got, want)


@pytest.mark.parametrize("method", ["NEAREST", "BILINEAR", "CATMULL_ROM"])
@pytest.mark.parametrize("shape", [(1, 9, 2), (9, 1, 2), (1, 1, 3)])
def test_sample_of_one_pixel_mirror_axes_matches_jax(shape, method):
    """A 1-px MIRROR axis resolves every index to 0. The JAX package's
    packed-patch path would return garbage there (ROADMAP §3); its
    sample() gate sends such images to the four-tap path, which is right,
    and the port handles the axis itself."""
    arr = _u8(shape, 3)
    xs, ys = _coords((40, 9), shape[0], shape[1], 4)
    want = jw.sample(arr, xs, ys, JI[method], JB.MIRROR)
    got = pw.sample(torch.from_numpy(arr), xs, ys, Interpolation[method],
                    BorderMode.MIRROR)
    _equal(got, want)


def test_sample_takes_a_batch_and_tensor_coordinates():
    arr = _u8((3, 16, 20, 4), 5)
    xs, ys = _coords((7, 11), 16, 20, 6)
    got = pw.sample(torch.from_numpy(arr), torch.from_numpy(xs),
                    torch.from_numpy(ys), Interpolation.BILINEAR,
                    BorderMode.WRAP)
    assert got.shape == (3, 7, 11, 4)
    for i in range(3):
        _equal(got[i], jw.sample(arr[i], xs, ys, JI.BILINEAR, JB.WRAP))
