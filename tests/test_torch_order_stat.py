"""The port's order-statistic blurs (ops/order_stat.py) and their
``ImageBatch`` methods against the JAX package on JAX-CPU: array_equal
throughout. Inputs come from numpy with a seed and go to both packages as
the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.enums import BorderMode as JaxBorder
from zignal_tpu.ops import order_stat as jax_os

import zignal_tpu_torch as zp
from zignal_tpu_torch.enums import BorderMode
from zignal_tpu_torch.ops import order_stat

# op name -> extra positional arguments after the radius
OPS = {"percentile_blur": (0.7,), "min_blur": (), "max_blur": (),
       "midpoint_blur": (), "alpha_trimmed_mean_blur": (0.2,)}


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _both(op, x, radius, *args, border=BorderMode.MIRROR):
    got = getattr(order_stat, op)(torch.from_numpy(x), radius, *args,
                                  border).numpy()
    want = np.asarray(getattr(jax_os, op)(jnp.asarray(x), radius, *args,
                                          JaxBorder(int(border))))
    return got, want


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
@pytest.mark.parametrize("op", list(OPS))
def test_order_stat_matches_jax(op, border):
    x = _u8((13, 17, 3), 1)
    got, want = _both(op, x, 2, *OPS[op], border=border)
    assert got.dtype == np.uint8 and got.shape == x.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("border", list(BorderMode), ids=lambda b: b.name)
def test_windows_larger_than_the_image_match_jax(border):
    """radius >= min(H, W) takes the JAX package's gather branch
    (order_stat.py:45,54); the port has one gather for every size."""
    x = _u8((2, 7, 4), 2)
    for op in ("percentile_blur", "alpha_trimmed_mean_blur", "min_blur"):
        got, want = _both(op, x, 2, *OPS[op], border=border)
        assert np.array_equal(got, want), op


@pytest.mark.parametrize("op", list(OPS))
def test_one_pixel_axis_matches_jax(op):
    x = _u8((1, 9, 1), 3)
    got, want = _both(op, x, 1, *OPS[op])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("radius", [1, 2])
def test_median_blur_matches_jax(radius):
    x = _u8((11, 10, 4), 4)
    got = order_stat.median_blur(torch.from_numpy(x), radius).numpy()
    want = np.asarray(jax_os.median_blur(jnp.asarray(x), radius))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pct", [0.0, 1.0, 0.5, 0.123])
def test_percentile_ranks_match_jax(pct):
    x = _u8((9, 8, 1), 5)
    got, want = _both("percentile_blur", x, 1, pct,
                      border=BorderMode.ZERO)
    assert np.array_equal(got, want)


def test_rank_of_matches_jax():
    for pct in (0.0, 0.1, 0.25, 0.5, 0.9, 0.999, 1.0):
        for total in (1, 9, 25, 49, 121):
            assert order_stat._rank_of(pct, total) == \
                jax_os._rank_of(pct, total)


def test_chunked_window_stack_equals_one_chunk(monkeypatch):
    """A batch split into several window-stack chunks gives the same
    values as one chunk."""
    x = torch.from_numpy(_u8((5, 12, 9, 3), 6))
    want = [order_stat.percentile_blur(x, 2, 0.5, BorderMode.WRAP),
            order_stat.alpha_trimmed_mean_blur(x, 1, 0.3)]
    monkeypatch.setattr(order_stat, "_STACK_ELEMS", 12 * 9 * 3 * 25 * 2)
    assert len(order_stat._chunks(x, 25)) == 3
    assert torch.equal(order_stat.percentile_blur(x, 2, 0.5,
                                                  BorderMode.WRAP), want[0])
    assert torch.equal(order_stat.alpha_trimmed_mean_blur(x, 1, 0.3),
                       want[1])


def test_alpha_trimmed_mean_multiplies_by_the_f32_reciprocal():
    """``floor((sum + n // 2) * f32(1 / n))``, as the JAX package writes
    it, and not the exact ``(sum + n // 2) // n``: for n = 41 (a 7x7
    window trimmed by 4 a side) the two differ at kept sums 21, 62, 144,
    ..., where the f32 product falls just below the integer. A 0/1 plane
    has windows with such sums, and there the port agrees with JAX."""
    n, trim = 41, 4
    sums = np.arange(0, 255 * n + 1)
    f32 = np.floor((sums.astype(np.float32) + np.float32(n // 2))
                   * np.float32(1.0 / n))
    differ = sums[f32 != (sums + n // 2) // n]
    assert differ[0] == 21
    x = (np.random.default_rng(7).random((12, 14, 1)) < 0.5).astype(np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(
        np.pad(x[..., 0], 3, mode="reflect"), (7, 7)).reshape(12, 14, 49)
    kept = np.sort(windows, -1)[..., trim:49 - trim].sum(-1)
    assert np.isin(kept, differ).any()
    got, want = _both("alpha_trimmed_mean_blur", x, 3, 0.09)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("method,args", [
    ("median_blur", (2,)), ("percentile_blur", (1, 0.9, BorderMode.WRAP)),
    ("min_blur", (2, BorderMode.ZERO)), ("max_blur", (1,)),
    ("midpoint_blur", (2, BorderMode.REPLICATE)),
    ("alpha_trimmed_mean_blur", (2, 0.2))])
def test_image_batch_order_stat_matches_jax(method, args):
    x = _u8((2, 12, 15, 3), 8)
    jargs = [JaxBorder(int(a)) if isinstance(a, BorderMode) else a
             for a in args]
    got = getattr(zp.ImageBatch(x, device="cpu"), method)(*args)
    want = getattr(jz.ImageBatch(x), method)(*jargs)
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_order_stat_validation_matches_jax():
    x = _u8((1, 6, 6, 1), 9)
    for ib in (jz.ImageBatch(x), zp.ImageBatch(x, device="cpu")):
        assert np.array_equal(ib.median_blur(0).to_numpy(), x)
        with pytest.raises(ValueError, match="non-negative"):
            ib.min_blur(-1)
        with pytest.raises(ValueError, match="percentile"):
            ib.percentile_blur(1, 1.5)
        for bad in (0.5, -0.1, float("nan")):
            with pytest.raises(ValueError, match="trim_fraction"):
                ib.alpha_trimmed_mean_blur(1, bad)
