"""ImageBatch on a mesh: the sweep of tests/test_image_batch.py on 4 gloo
CPU ranks, on a 1-D mesh of 4 and on a 2x2 (batch x space) mesh
(tests/_torch_ranks.py, one spawn for the module).

Every sharded output must equal the port's batch without a mesh and the
JAX package's batch on a mesh of the same shape (conftest's virtual
devices): u8 array_equal; the per-image f32 metrics equal on a 1-D mesh
(the same local op) and, where the space axis splits the sums, within
1e-5 relative for PSNR and the mean error and 1e-5 absolute for SSIM
(tests/test_spatial_sharding.py's SSIM bound). The collective counts are
the counterpart of the JAX tests that read the compiled HLO
(tests/test_image_batch.py:100-120): a batch-sharded op issues none, a
space-sharded windowed op only point-to-point halo messages."""

import numpy as np
import pytest

import _torch_ranks as R

import zignal_tpu as jz
from zignal_tpu_torch import Blending, Colormap, Gray, ImageBatch
from zignal_tpu_torch.codecs import save_array

WORLD = 4
SHAPES = {"batch": dict(), "space": dict(b=4, h=64)}
_RESULTS = {}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    paths = []
    for i in range(4):
        p = str(d / f"img{i}.png")
        save_array(p, R.arr(b=1, h=20, w=24, seed=i)[0])
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def res(tmp_path_factory, files):
    if "r" not in _RESULTS:
        _RESULTS["r"] = R.run_ranks(WORLD, "batch_mesh",
                                    tmp_path_factory.mktemp("ranks"),
                                    args=(files,))
    return _RESULTS["r"][0]


def _jmesh(tag):
    import jax
    from jax.sharding import Mesh

    from zignal_tpu.parallel import make_mesh

    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest's virtual devices")
    if tag == "batch":
        return make_mesh(WORLD)
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(2, WORLD // 2),
                ("batch", "space"))


def _jargs(args):
    return tuple(jz.Interpolation.BICUBIC if a == "BICUBIC" else a
                 for a in args)


def _port(tag, name, args):
    b = ImageBatch(R.arr(**SHAPES[tag]), device="cpu")
    return getattr(b, name)(*R._args(args)).to_numpy()


def _jax(tag, name, args):
    b = jz.ImageBatch(R.arr(**SHAPES[tag]), mesh=_jmesh(tag))
    return getattr(b, name)(*_jargs(args)).to_numpy()


@pytest.mark.parametrize("name,args", R.SWEEP_OPS,
                         ids=[R.op_id(*op) for op in R.SWEEP_OPS])
def test_batch_sharded_matches(res, name, args):
    key = f"batch/{R.op_id(name, args)}"
    want = _port("batch", name, args)
    assert np.array_equal(res[key], want)
    assert np.array_equal(res[key], _jax("batch", name, args))
    # the output stays sharded: each rank holds 2 of the 8 images
    assert res[key + "/local_shape"][0] == 8 // WORLD


@pytest.mark.parametrize("name,args", R.SWEEP_OPS,
                         ids=[R.op_id(*op) for op in R.SWEEP_OPS])
def test_batch_sharded_ops_issue_no_collective(res, name, args):
    counts = res[f"batch/{R.op_id(name, args)}/counts"]
    assert counts == {"p2p": 0, "all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("name,args", R.SPACE_OPS,
                         ids=[R.op_id(*op) for op in R.SPACE_OPS])
def test_space_sharded_matches(res, name, args):
    key = f"space/{R.op_id(name, args)}"
    want = _port("space", name, args)
    assert np.array_equal(res[key], want)
    assert np.array_equal(res[key], _jax("space", name, args))
    assert res[key + "/local_shape"][:2] == (2, 32)


@pytest.mark.parametrize("name,args", [op for op in R.SPACE_OPS
                                       if op[0] in R.WINDOWED],
                         ids=[R.op_id(*op) for op in R.SPACE_OPS
                              if op[0] in R.WINDOWED])
def test_space_sharded_windowed_ops_send_only_halos(res, name, args):
    counts = res[f"space/{R.op_id(name, args)}/counts"]
    assert counts["p2p"] > 0
    assert counts["all_gather"] == 0 and counts["all_reduce"] == 0


@pytest.mark.parametrize("tag", SHAPES)
@pytest.mark.parametrize("name", ("psnr", "ssim", "mean_pixel_error"))
def test_metrics(res, tag, name):
    a = R.arr(**SHAPES[tag])
    b = ImageBatch(a, device="cpu")
    want = getattr(b, name)(b.gaussian_blur(3.0)).numpy()
    jb = jz.ImageBatch(a, mesh=_jmesh(tag))
    jwant = np.asarray(getattr(jb, name)(jb.gaussian_blur(3.0)))
    got = res[f"{tag}/{name}"]
    assert got.shape == (a.shape[0],)
    if tag == "batch":
        assert np.array_equal(got, want)
    elif name == "ssim":
        assert np.abs(got - want).max() < 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    tol = dict(atol=1e-5) if name == "ssim" else dict(rtol=1e-5)
    np.testing.assert_allclose(got, jwant, **tol)
    counts = res[f"{tag}/{name}/counts"]
    assert counts["all_gather"] == 0
    if tag == "batch":
        assert counts == {"p2p": 0, "all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("tag", SHAPES)
def test_diff_histogram_and_otsu(res, tag):
    a = R.arr(**SHAPES[tag])
    b = ImageBatch(a, device="cpu")
    jb = jz.ImageBatch(a, mesh=_jmesh(tag))
    vis, counts = b.diff(b.gaussian_blur(3.0), threshold=2.0)
    jvis, jcounts = jb.diff(jb.gaussian_blur(3.0), threshold=2.0)
    got_vis, got_counts = res[f"{tag}/diff"]
    assert np.array_equal(got_vis, vis.to_numpy())
    assert np.array_equal(got_counts, counts.numpy())
    assert np.array_equal(got_vis, jvis.to_numpy())
    assert np.array_equal(got_counts, np.asarray(jcounts))
    assert np.array_equal(res[f"{tag}/histogram"], b.histogram().numpy())
    assert np.array_equal(res[f"{tag}/histogram"], np.asarray(jb.histogram()))
    if tag == "batch":
        assert res["batch/histogram/counts"]["all_reduce"] == 0
    binary, thr = b.convert(Gray).threshold_otsu()
    jbinary, jthr = jb.convert(jz.Gray).threshold_otsu()
    got_bin, got_thr = res[f"{tag}/otsu"]
    assert np.array_equal(got_bin, binary.to_numpy())
    assert np.array_equal(got_thr, thr)
    assert np.array_equal(got_bin, jbinary.to_numpy())
    assert np.array_equal(got_thr, jthr)


@pytest.mark.parametrize("tag", SHAPES)
def test_pointwise_members(res, tag):
    a = R.arr(**SHAPES[tag])
    b = ImageBatch(a, device="cpu")
    jb = jz.ImageBatch(a, mesh=_jmesh(tag))
    over = R.arr(b=a.shape[0], h=a.shape[1], c=4, seed=5)
    want = b.blend(ImageBatch(over, device="cpu"), Blending.MULTIPLY)
    jwant = jb.blend(jz.ImageBatch(over), jz.Blending.MULTIPLY)
    assert np.array_equal(res[f"{tag}/blend"], want.to_numpy())
    assert np.array_equal(res[f"{tag}/blend"], jwant.to_numpy())
    cm = Colormap.jet(min=0, max=255)
    assert np.array_equal(res[f"{tag}/colormap"],
                          b.apply_colormap(cm).to_numpy())
    assert np.array_equal(res[f"{tag}/colormap"], jb.apply_colormap(
        jz.Colormap.jet(min=0, max=255)).to_numpy())
    assert np.array_equal(res[f"{tag}/convert_gray"],
                          jb.convert(jz.Gray).to_numpy())
    assert np.array_equal(res[f"{tag}/getitem"], a[1])


def test_repr_and_sharding(res):
    assert res["batch/repr"] == "ImageBatch(8x32x48, dtype=Rgb, " \
        "mesh=4 ('batch',))"
    assert res["space/repr"] == "ImageBatch(4x64x48, dtype=Rgb, " \
        "mesh=2x2 ('batch', 'space'))"
    assert res["batch/sharding"] == "(Shard(dim=0),)"
    assert res["space/sharding"] == "(Shard(dim=0), Shard(dim=1))"
    assert ImageBatch(R.arr(), device="cpu").sharding is None


def test_resize_blur_oklab_and_chain(res):
    a = R.arr()
    b = ImageBatch(a, device="cpu")
    want = b.resize_blur_oklab((16, 24), sigma=1.0).numpy()
    assert np.array_equal(res["batch/resize_blur_oklab"], want)
    jwant = np.asarray(jz.ImageBatch(a, mesh=_jmesh("batch"))
                       .resize_blur_oklab((16, 24), sigma=1.0))
    assert np.abs(res["batch/resize_blur_oklab"] - jwant).max() < 5e-6
    assert res["batch/resize_blur_oklab/counts"] == {
        "p2p": 0, "all_reduce": 0, "all_gather": 0}
    chain = b.resize((16, 16)).gaussian_blur(1.0).convert(Gray).equalize()
    assert np.array_equal(res["batch/chain"], chain.to_numpy())


@pytest.mark.parametrize("name", R.BATCH_ONLY)
def test_space_sharding_rejects_grid_changing_ops(res, name):
    msg = res[f"space_raises/{name}"]
    assert msg.startswith("ValueError:")
    assert "requires batch-only sharding" in msg


def test_construction_errors(res):
    assert res["err/batch"] == ("ValueError: batch size 3 not divisible by "
                                "mesh axis 'batch' (4 devices)")
    assert res["err/rows"] == ("ValueError: image height 31 not divisible "
                               "by mesh axis 'space' (2 devices)")
    assert res["err/device"].startswith("ValueError: device=meta differs")
    assert res["err/no_device"].startswith("TypeError:")


def test_with_mesh(res):
    whole, has_mesh, plain_has_none, local_b = res["with_mesh"]
    assert np.array_equal(whole, R.arr())
    assert has_mesh and plain_has_none and local_b == 2
    assert np.array_equal(res["with_mesh/2d"], R.arr())


def test_from_paths_with_mesh(res):
    want = np.stack([R.arr(b=1, h=20, w=24, seed=i)[0] for i in range(4)])
    got, local_b, size = res["from_paths"]
    assert np.array_equal(got, want)
    assert local_b == 1 and size == 4
    got, local_shape = res["from_paths/2d"]
    assert np.array_equal(got, want[:2])
    assert local_shape == (1, 10, 24, 3)
