"""The port's file loader (zignal_tpu_torch.io_pipeline) and
``ImageBatch.from_paths`` / ``.save`` against zignal_tpu's on JAX-CPU, on
files written to ``tmp_path`` from seeded arrays, with ``device="cpu"`` on
the port's side (no pinned memory, no copy stream: the caller's request).
Decoded and letterboxed batches are held equal (u8)."""

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.io_pipeline import BatchLoader as JaxLoader
from zignal_tpu.io_pipeline import load_image_batch as jax_load
from zignal_tpu.native import get_lib as jax_native

import zignal_tpu_torch as zp
from zignal_tpu_torch import codecs
from zignal_tpu_torch.io_pipeline import BatchLoader, load_image_batch

CPU = "cpu"
SIZES = [(24, 32), (30, 20), (16, 16), (17, 40)]


@pytest.fixture(autouse=True)
def _jax_codecs_loaded():
    """Load the JAX package's codec library before its loader's thread
    pool does: its first get_lib hands None to threads that arrive while
    another loads (ROADMAP §3)."""
    assert jax_native() is not None


def _write(tmp_path, n, sizes=SIZES, exts=("png", "jpg", "bmp"), c=3):
    """``n`` seeded files of mixed sizes, formats and (for c=None) channel
    counts."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(n):
        ch = c or (1, 3, 4)[i % 3]
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(yy * 7 + xx * (3 + k)) % 256 for k in range(ch)],
                        -1)
        arr = np.clip(base + rng.integers(-20, 21, (h, w, ch)), 0, 255) \
            .astype(np.uint8)
        ext = exts[i % len(exts)]
        if ext == "jpg" and ch == 4:
            ext = "png"
        p = str(tmp_path / f"img_{i}.{ext}")
        codecs.save_array(p, arr)
        paths.append(p)
    return paths


@pytest.mark.parametrize("shape", [(16, 16), (20, 28), (24, 32)])
def test_load_image_batch_matches_jax(tmp_path, shape):
    paths = _write(tmp_path, 6, c=None)
    got = load_image_batch(paths, shape=shape, device=CPU)
    want = np.asarray(jax_load(paths, shape=shape))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.uint8 and got.shape == (6, *shape, 3)
    assert np.array_equal(got.numpy(), want)


def test_load_image_batch_nearest_and_no_shape_match_jax(tmp_path):
    paths = _write(tmp_path, 4, sizes=[(18, 22)])
    got = load_image_batch(paths, shape=(12, 30),
                           interpolation=zp.Interpolation.NEAREST,
                           workers=2, device=CPU)
    want = jax_load(paths, shape=(12, 30),
                    interpolation=jz.Interpolation.NEAREST, workers=2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    same = load_image_batch(paths, device=CPU)
    assert np.array_equal(same.numpy(), np.asarray(jax_load(paths)))


def test_batch_loader_order_and_remainder_match_jax(tmp_path):
    paths = _write(tmp_path, 7)
    loader = BatchLoader(paths, batch_size=3, shape=(16, 16), device=CPU)
    jloader = JaxLoader(paths, batch_size=3, shape=(16, 16))
    assert len(loader) == len(jloader) == 3
    got = list(loader)
    want = [np.asarray(b) for b in jloader]
    assert [tuple(b.shape) for b in got] == [(3, 16, 16, 3)] * 2 + \
        [(1, 16, 16, 3)]
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), w)
    # each batch is the files in order: the prefetch keeps the order
    for i, g in enumerate(got):
        one = load_image_batch(paths[3 * i:3 * i + 3], shape=(16, 16),
                               device=CPU)
        assert torch.equal(g, one)
    # iterating again starts over
    assert all(torch.equal(a, b) for a, b in zip(loader, got))


def test_batch_loader_drop_remainder(tmp_path):
    paths = _write(tmp_path, 7)
    loader = BatchLoader(paths, batch_size=3, shape=(8, 8),
                         drop_remainder=True, device=CPU)
    assert len(loader) == 2
    assert [tuple(b.shape) for b in loader] == [(3, 8, 8, 3)] * 2
    assert len(BatchLoader(paths[:6], batch_size=3, device=CPU)) == 2
    assert list(BatchLoader([], batch_size=3, device=CPU)) == []


def test_batch_loader_propagates_errors(tmp_path):
    paths = _write(tmp_path, 4)
    loader = BatchLoader([str(tmp_path / "missing.png")], batch_size=1,
                         device=CPU)
    with pytest.raises(FileNotFoundError):
        list(loader)
    # the batches before a bad file arrive; the error comes with its batch
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    loader = BatchLoader(paths[:2] + [str(bad)], batch_size=2,
                         shape=(16, 16), device=CPU)
    it = iter(loader)
    assert tuple(next(it).shape) == (2, 16, 16, 3)
    with pytest.raises(ValueError, match="unrecognized"):
        next(it)


def test_batch_loader_stops_early_without_hanging(tmp_path):
    paths = _write(tmp_path, 9)
    loader = BatchLoader(paths, batch_size=2, shape=(8, 8), device=CPU)
    for i, batch in enumerate(loader):
        if i == 1:
            break
    assert tuple(batch.shape) == (2, 8, 8, 3)


@pytest.mark.parametrize("shape", [None, (20, 24)])
def test_from_paths_matches_jax(tmp_path, shape):
    paths = _write(tmp_path, 4, sizes=[(20, 24)] if shape is None else SIZES,
                   c=None)
    got = zp.ImageBatch.from_paths(paths, shape=shape, device=CPU)
    want = jz.ImageBatch.from_paths(paths, shape=shape)
    assert got.dtype is zp.Rgb and got.batch_size == 4
    assert np.array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("ext", ["png", "jpg", "bmp"])
def test_save_matches_jax_and_round_trips(tmp_path, ext):
    arr = np.random.default_rng(2).integers(0, 256, (3, 16, 20, 3),
                                           np.uint8)
    ours = [str(tmp_path / f"p{i}.{ext}") for i in range(3)]
    theirs = [str(tmp_path / f"j{i}.{ext}") for i in range(3)]
    zp.ImageBatch(arr, device=CPU).save(ours, workers=2)
    jz.ImageBatch(arr).save(theirs)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    back = zp.ImageBatch.from_paths(ours, device=CPU)
    if ext != "jpg":
        assert np.array_equal(back.to_numpy(), arr)
    with pytest.raises(ValueError):
        zp.ImageBatch(arr, device=CPU).save(ours[:2])
