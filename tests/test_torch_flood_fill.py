"""The port's flood fill against zignal_tpu on JAX-CPU, ``device="cpu"``
on the port's side.

Bounds: masks and filled pixels are exact (integer squared distances
against ``threshold_sq_int``): equal to JAX's ``flood_region`` and to its
``Image.flood_fill`` on both sides of 4096 pixels (its host loop below,
its device loop above; the port grows the region on the device at every
size) and to its ``ImageBatch.flood_fill``, in SEED and NEIGHBOR mode at
connectivity 4 and 8, on a blobby field and on a spiral with many turns.
The runs (one count along the axis against bounds found once) are also
held to the two scans they replace, element by element.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zignal_tpu as jz
from zignal_tpu.ops.flood_fill import flood_region as jax_region
from zignal_tpu.ops.flood_fill import threshold_sq_int as jax_thr

import zignal_tpu_torch as zp
from chip_smoke import spiral  # a corridor from (0, 0) inwards, n / w turns
from zignal_tpu_torch.ops import flood_fill as ff

CPU = "cpu"
COMBOS = [(False, 4), (False, 8), (True, 4), (True, 8)]


def _blobby():
    """tests/test_flood_fill.py's field: quantized smooth values + noise
    (96 x 80 = 7680 pixels, above JAX's 4096-pixel host loop)."""
    rng = np.random.default_rng(23)
    base = np.cumsum(rng.integers(-3, 4, (96, 80)), axis=0)
    base = np.cumsum(base, axis=1) % 97
    arr = np.stack([base, base // 2, base // 3], axis=-1).astype(np.uint8)
    arr += rng.integers(0, 3, arr.shape, dtype=np.uint8)
    return arr


def _spiral_image(n=64):
    rng = np.random.default_rng(n)
    arr = np.where(spiral(n, 2)[..., None], 200, 20).astype(np.int32)
    arr = arr + rng.integers(0, 3, (n, n, 3))  # NEIGHBOR needs threshold
    return arr.astype(np.uint8)


def _recurrence(a, b, reverse):
    """s[j] = a[j] | (b[j] & s[j-1]) along the last axis, by a loop."""
    a, b = a.copy(), b.copy()
    if reverse:
        a, b = a[..., ::-1], b[..., ::-1]
    s = np.zeros_like(a)
    prev = np.zeros(a.shape[:-1], bool)
    for j in range(a.shape[-1]):
        prev = a[..., j] | (b[..., j] & prev)
        s[..., j] = prev
    return s[..., ::-1] if reverse else s


@pytest.mark.parametrize("threshold", [-1.0, 0.0, 0.5, 1.0, 2 ** 0.5,
                                       1.4142135, 2.9999999, 3.0, 9.5,
                                       100.0, 441.6729559300637, 1e4])
def test_threshold_sq_int_equals_jax(threshold):
    assert ff.threshold_sq_int(threshold) == jax_thr(threshold)


@pytest.mark.parametrize("seed", range(6))
def test_runs_are_jax_forward_then_backward_scans(seed):
    """One count along the axis gives what JAX's two scans give, forward
    on the region and backward on the region with the forward run."""
    rng = np.random.default_rng(seed)
    a = rng.random((5, 37)) < 0.1
    bf = rng.random((5, 37)) < 0.8
    br = rng.random((5, 37)) < 0.8
    fwd = a | _recurrence(a, bf, False)
    want = fwd | _recurrence(fwd, br, True)
    got = ff._runs(torch.from_numpy(a),
                   *ff._run_bounds(torch.from_numpy(bf), torch.from_numpy(br)))
    np.testing.assert_array_equal((torch.from_numpy(a) | got).numpy(), want)
    cols = ff._run_bounds(torch.from_numpy(bf), torch.from_numpy(br))
    got_t = ff._runs(torch.from_numpy(a.T.copy()).transpose(-1, -2), *cols)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.mark.parametrize("neighbor,connectivity", COMBOS)
def test_region_equals_jax_on_the_blobby_field(neighbor, connectivity):
    arr = _blobby()
    for thr, (r, c) in [(0.0, (48, 40)), (4.0, (48, 40)), (9.5, (3, 70)),
                        (30.0, (95, 0))]:
        t = ff.threshold_sq_int(thr)
        got = ff.flood_region(torch.from_numpy(arr), r, c, t, connectivity,
                              neighbor)
        want = np.asarray(jax_region(jnp.asarray(arr), r, c, t,
                                     connectivity=connectivity,
                                     neighbor_mode=neighbor))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("neighbor,connectivity", COMBOS)
def test_region_equals_jax_on_a_spiral(neighbor, connectivity):
    arr = _spiral_image()
    t = ff.threshold_sq_int(4.0)
    before = ff.ITERATIONS
    got = ff.flood_region(torch.from_numpy(arr), 0, 0, t, connectivity,
                          neighbor)
    iterations = ff.ITERATIONS - before
    want = np.asarray(jax_region(jnp.asarray(arr), 0, 0, t,
                                 connectivity=connectivity,
                                 neighbor_mode=neighbor))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == spiral(64, 2).sum()  # the corridor, nothing else
    # a run step crosses a straight arm whole: far fewer iterations than
    # the corridor's length (a one-hop dilation would need ~1000)
    assert 2 <= iterations <= 40


@pytest.mark.parametrize("neighbor,connectivity", COMBOS)
@pytest.mark.parametrize("c,fill", [(3, (255, 0, 128)), (1, 77),
                                    (4, (1, 2, 3, 4))])
def test_image_flood_fill_below_4096_pixels_equals_jax(neighbor,
                                                       connectivity, c,
                                                       fill):
    arr = np.ascontiguousarray(_blobby()[:40, :50, :c])  # 2000 pixels
    mode = zp.ThresholdMode.NEIGHBOR if neighbor else zp.ThresholdMode.SEED
    got = zp.Image.from_numpy(arr.copy(), device=CPU)
    want = jz.Image.from_numpy(arr.copy())
    got.flood_fill(20, 25, fill, threshold=6.0, connectivity=connectivity,
                   mode=mode)
    want.flood_fill(20, 25, fill, threshold=6.0, connectivity=connectivity,
                    mode=jz.ThresholdMode(int(mode)))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    assert not np.array_equal(got.to_numpy(), arr)


@pytest.mark.parametrize("neighbor,connectivity", COMBOS)
def test_image_flood_fill_above_4096_pixels_equals_jax(neighbor,
                                                       connectivity):
    arr = _blobby()
    got = zp.Image.from_numpy(arr.copy(), device=CPU)
    want = jz.Image.from_numpy(arr.copy())
    mode = int(neighbor)
    got.flood_fill(48, 40, zp.Rgb(9, 8, 7), 9.5, connectivity, mode)
    want.flood_fill(48, 40, jz.Rgb(9, 8, 7), 9.5, connectivity, mode)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_image_flood_fill_writes_through_views_and_checks_arguments():
    arr = _blobby()
    img = zp.Image.from_numpy(arr, device=CPU)
    img.flood_fill(0, 0, (1, 2, 3), threshold=3.0)
    assert (arr[0, 0] == (1, 2, 3)).all()  # in place, on the borrowed array
    with pytest.raises(ValueError, match="out of bounds"):
        img.flood_fill(96, 0, (0, 0, 0))
    with pytest.raises(ValueError, match="connectivity"):
        img.flood_fill(0, 0, (0, 0, 0), connectivity=6)
    with pytest.raises(ValueError):
        img.flood_fill(0, 0, (0, 0, 0), mode=5)


@pytest.mark.parametrize("neighbor,connectivity", [(False, 4), (True, 8)])
def test_batch_flood_fill_equals_jax(neighbor, connectivity):
    arr = np.stack([_blobby()[:32, :40], _blobby()[60:92, 40:80],
                    _spiral_image(64)[:32, :40]])
    mode = int(neighbor)
    got = zp.ImageBatch(arr, device=CPU).flood_fill(
        0, 0, (250, 0, 0), 8.0, connectivity, mode)
    want = jz.ImageBatch(arr).flood_fill(0, 0, (250, 0, 0), 8.0,
                                         connectivity, mode)
    assert got.dtype is zp.Rgb
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    with pytest.raises(ValueError):
        zp.ImageBatch(arr, device=CPU).flood_fill(0, 40, (0, 0, 0))
