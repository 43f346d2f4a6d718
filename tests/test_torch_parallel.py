"""The port's parallel/ on gloo CPU ranks (1-D meshes of 1, 2 and 4, and a
2x2 mesh) against the port's single-device ops and the JAX package.

The ranks run in spawned processes (tests/_torch_ranks.py, one spawn a
world size for the whole module). u8 outputs must be array_equal to the
port's single-device op and to JAX: to JAX's sharded function where it is
run here, else to JAX's single-device op where JAX's own tests
(tests/test_parallel.py, tests/test_spatial_sharding.py) hold its sharded
function equal to it. Float bounds: SSIM within 1e-5 and match_sharded
within 1 u8 step at under 2 % of pixels (tests/test_spatial_sharding.py),
global_mean_cov against f64 numpy with rtol 1e-5 (mean) and rtol 1e-4,
atol 1e-2 (cov) (tests/test_parallel.py)."""

import numpy as np
import pytest
import torch

import _torch_ranks as R

import zignal_tpu_torch.parallel as P
import zignal_tpu.parallel as JP
from zignal_tpu_torch.enums import BorderMode
from zignal_tpu_torch.ops import binary, convolution, enhancement, integral
from zignal_tpu_torch.ops import metrics, order_stat

WORLDS = (1, 2, 4)
_RESULTS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def get(world):
        if world not in _RESULTS:
            _RESULTS[world] = R.run_ranks(
                world, "parallel", tmp_path_factory.mktemp(f"w{world}"))
        return _RESULTS[world]

    return get


def _jmesh(world):
    import jax

    if len(jax.devices()) < world:
        pytest.skip("needs the conftest's virtual devices")
    return JP.make_mesh(world)


def _jshard(x, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    spec = PartitionSpec("batch", *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_all_matches_the_jax_package():
    assert sorted(P.__all__) == sorted(JP.__all__)
    assert all(callable(getattr(P, name)) for name in P.__all__)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_global_values(ranks, world):
    res = ranks(world)
    for key, val in res[0].items():
        if key.endswith("/counts"):
            continue
        for other in res[1:]:
            got = other[key]
            if isinstance(val, tuple):
                assert all(np.array_equal(a, b) for a, b in zip(val, got)), key
            else:
                assert np.array_equal(val, got), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("border", R.BORDERS)
@pytest.mark.parametrize("radius", (1, 3, R.SPATIAL["h"] - 1))
def test_halo_extend(ranks, world, border, radius):
    """Rank i's extended block is rows [i h - r, (i + 1) h + r) of the image
    padded in the border mode; a ring of one sends nothing."""
    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"]
    h = R.SPATIAL["h"]
    padded = R.pad_rows(img, radius, border)
    got = res[f"halo/{border}/{radius}"]
    for i in range(world):
        assert np.array_equal(got[i], padded[i * h:i * h + h + 2 * radius])
    counts = res[f"halo/{border}/{radius}/counts"]
    assert counts["all_reduce"] == counts["all_gather"] == 0
    assert (counts["p2p"] > 0) == (world > 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("border", R.BORDERS)
def test_spatial_gaussian_blur_and_spatial_op(ranks, world, border):
    from zignal_tpu.ops.convolution import gaussian_blur as jblur

    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"]
    mode = BorderMode[border.upper()]
    want = convolution.gaussian_blur(_t(img), 1.2, mode).numpy()
    assert np.array_equal(res[f"gauss/{border}"], want)
    assert np.array_equal(res[f"op/{border}"], want)
    assert np.array_equal(np.asarray(jblur(img, 1.2, int(mode))), want)
    jgot = JP.spatial_gaussian_blur(_jmesh(world), 1.2, int(mode))(
        _jshard(img, _jmesh(world)))
    assert np.array_equal(np.asarray(jgot), want)
    assert res[f"gauss/{border}/counts"]["all_gather"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_gaussian_blur_f32_and_sigma_zero(ranks, world):
    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"].astype(np.float32)
    want = convolution.gaussian_blur(_t(img), 1.5).numpy()
    assert np.array_equal(res["gauss/f32"], want)
    assert res["gauss/sigma0_is_input"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("radius", (1, 3))
def test_spatial_box_blur(ranks, world, radius):
    from zignal_tpu.ops.integral import box_blur as jbox

    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"]
    want = integral.box_blur(_t(img), radius).numpy()
    assert np.array_equal(res[f"box/{radius}"], want)
    assert np.array_equal(np.asarray(jbox(img, radius)), want)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_sharpen_and_adaptive_threshold(ranks, world):
    from zignal_tpu.ops.binary import adaptive_mean_threshold as jadapt
    from zignal_tpu.ops.integral import sharpen as jsharpen

    res = ranks(world)[0]
    x = R.parallel_inputs(world)
    want = integral.sharpen(_t(x["img"]), 2).numpy()
    assert np.array_equal(res["sharpen"], want)
    assert np.array_equal(np.asarray(jsharpen(x["img"], 2)), want)
    want = binary.adaptive_mean_threshold(_t(x["plane"]), 3, 5.0).numpy()
    assert np.array_equal(res["adaptive"], want)
    assert np.array_equal(np.asarray(jadapt(x["plane"], 3, 5.0)), want)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_sobel(ranks, world):
    from zignal_tpu.ops.convolution import sobel_magnitude as jsobel

    res = ranks(world)[0]
    plane = R.parallel_inputs(world)["fplane"]
    want = convolution.sobel_magnitude(_t(plane)).numpy()
    assert np.array_equal(res["sobel"], want)
    assert np.array_equal(np.asarray(jsobel(plane)), want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("ksize,iters", ((3, 1), (3, 2), (5, 1)))
def test_spatial_dilate_and_erode(ranks, world, ksize, iters):
    from zignal_tpu.ops.binary import dilate as jdilate, erode as jerode

    res = ranks(world)[0]
    mask = R.parallel_inputs(world)["mask"]
    want = binary.dilate(_t(mask), ksize, iters).numpy()
    assert np.array_equal(res[f"dilate/{ksize}/{iters}"], want)
    assert np.array_equal(np.asarray(jdilate(mask, ksize, iters)), want)
    want = binary.erode(_t(mask), ksize, iters).numpy()
    assert np.array_equal(res[f"erode/{ksize}/{iters}"], want)
    assert np.array_equal(np.asarray(jerode(mask, ksize, iters)), want)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_median_blur(ranks, world):
    from zignal_tpu.ops.order_stat import median_blur as jmedian

    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"]
    want = order_stat.median_blur(_t(img), 2).numpy()
    assert np.array_equal(res["median"], want)
    assert np.array_equal(np.asarray(jmedian(img, 2)), want)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_ssim(ranks, world):
    x = R.parallel_inputs(world)
    res = ranks(world)[0]
    h = x["img"].shape[0]
    want = float(metrics.ssim(_t(x["img"]), _t(x["other"])))
    assert abs(res["ssim"] - want) < 1e-5
    mesh = _jmesh(world)
    jgot = float(JP.spatial_ssim(mesh, h)(_jshard(x["img"], mesh),
                                         _jshard(x["other"], mesh)))
    assert abs(res["ssim"] - jgot) < 1e-5
    assert res["ssim/counts"]["all_gather"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_histogram_and_equalize(ranks, world):
    from zignal_tpu.ops.enhancement import equalize as jequalize

    res = ranks(world)[0]
    x = R.parallel_inputs(world)
    for c in range(3):
        want = np.bincount(x["img"][..., c].ravel(), minlength=256)
        assert np.array_equal(res["histogram"][c], want)
    assert res["histogram/counts"] == {"p2p": 0, "all_reduce": 1,
                                       "all_gather": 0}
    want = enhancement.equalize(_t(x["equalize"])).numpy()
    assert np.array_equal(res["equalize"], want)
    assert np.array_equal(np.asarray(jequalize(x["equalize"])), want)
    rgba = np.concatenate([x["equalize"], x["equalize"][..., :1]], axis=-1)
    assert np.array_equal(res["equalize/rgba"],
                          enhancement.equalize(_t(rgba)).numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_replicate_and_global_mesh(ranks, world):
    res = ranks(world)[0]
    batch = R.parallel_inputs(world)["batch"]
    whole, local_shape = res["shard_batch"]
    assert np.array_equal(whole, batch)
    assert local_shape == (2,) + batch.shape[1:]
    assert np.array_equal(res["replicate"], batch)
    assert res["global_mesh"] == (world,)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pipeline(ranks, world):
    from zignal_tpu.pipeline import resize_blur_oklab as jchain
    from zignal_tpu_torch.pipeline import resize_blur_oklab

    res = ranks(world)[0]
    batch = R.parallel_inputs(world)["batch"]
    want = resize_blur_oklab(_t(batch), 12, 12, 1.0).numpy()
    assert np.array_equal(res["pipeline"], want)
    # the port's chain is within the JAX tests' Oklab bound of JAX's
    assert np.abs(np.asarray(jchain(batch, 12, 12, 1.0)) - want).max() < 5e-6
    assert res["pipeline/counts"] == {"p2p": 0, "all_reduce": 0,
                                      "all_gather": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_global_mean_cov(ranks, world):
    res = ranks(world)[0]
    batch = R.parallel_inputs(world)["batch"]
    mean, cov = res["global_mean_cov"]
    flat = batch.reshape(-1, 3).astype(np.float64)
    want_mean = flat.mean(axis=0)
    want_cov = flat.T @ flat / flat.shape[0] - np.outer(want_mean, want_mean)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-5)
    np.testing.assert_allclose(cov, want_cov, rtol=1e-4, atol=1e-2)
    mesh = _jmesh(world)
    jmean, jcov = JP.global_mean_cov(mesh)(_jshard(batch, mesh))
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(cov, np.asarray(jcov), rtol=1e-4, atol=1e-2)
    assert res["global_mean_cov/counts"]["all_reduce"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_mean_cov_image(ranks, world):
    res = ranks(world)[0]
    img = R.parallel_inputs(world)["img"]
    mean, cov = res["mean_cov_image"]
    x = img.reshape(-1, 3).astype(np.float64) * np.float32(1 / 255)
    np.testing.assert_allclose(mean, x.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(cov, np.cov(x, rowvar=False), rtol=1e-5,
                               atol=1e-7)


def _step_share(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return diff.max(), (diff > 0).mean()


@pytest.mark.parametrize("world", WORLDS)
def test_match_sharded(ranks, world):
    """Within 1 u8 step at under 2 % of pixels of the port's update() and of
    JAX's match_sharded (tests/test_spatial_sharding.py's bound)."""
    from zignal_tpu.fdm import FeatureDistributionMatching as JFDM
    from zignal_tpu.image import Image as JImage
    from zignal_tpu_torch import FeatureDistributionMatching, Image

    res = ranks(world)[0]
    x = R.parallel_inputs(world)
    work = Image.from_numpy(x["img"].copy(), device="cpu")
    FeatureDistributionMatching().match(
        work, Image.from_numpy(x["target"].copy(), device="cpu"))
    worst, share = _step_share(res["match_sharded"], work.to_numpy())
    assert worst <= 1 and share < 0.02
    mesh = _jmesh(world)
    jgot = np.asarray(JFDM().match_sharded(
        _jshard(x["img"], mesh), JImage.from_numpy(x["target"].copy()),
        mesh))
    worst, share = _step_share(res["match_sharded"], jgot)
    assert worst <= 1 and share < 0.02


@pytest.mark.parametrize("world", WORLDS)
def test_errors(ranks, world):
    res = ranks(world)[0]
    assert res["err/small_shard"].startswith(
        "ValueError: shard of 16 rows too small for sigma=8.0")
    assert res["err/small_halo"].startswith(
        "ValueError: shard of 16 rows too small for halo radius 16")
    assert res["err/bigger_mesh"].startswith(
        f"ValueError: make_mesh({2 * world}) but only {world} rank(s)")
    if world > 1:
        assert "not divisible by mesh axis 'batch'" in res["err/batch"]
        assert "not divisible by mesh axis 'batch'" in res["err/rows"]


def test_spatial_op_ndim_on_2_ranks(ranks):
    """ndim fixes the lift's rank, as it fixes JAX's PartitionSpec: a plane
    at 2 and an image at 3 equal the op without a mesh, and an input of
    lower rank raises what JAX's shard_map raises."""
    res = ranks(2)[0]
    x = R.parallel_inputs(2)
    plane = convolution.gaussian_blur(_t(x["plane"])[..., None], 1.2)[..., 0]
    assert np.array_equal(res["ndim/2"], plane.numpy())
    want = convolution.gaussian_blur(_t(x["img"]), 1.2).numpy()
    assert np.array_equal(res["ndim/3"], want)
    jerr = pytest.raises(ValueError, JP.spatial_op(
        _jmesh(2), lambda t: t, 4), x["plane"])
    assert "in_specs" in str(jerr.value)
    for key in ("err/ndim", "err/ndim_2d"):
        assert res[key].startswith(f"{jerr.type.__name__}: the lift was "
                                   "made for rank"), res[key]


def test_spatial_op_2d_on_a_2x2_mesh(ranks):
    res = ranks(4)[0]
    x = R.parallel_inputs(4)
    want = order_stat.median_blur(_t(x["batch2d"]), 2).numpy()
    assert np.array_equal(res["op2d/median"], want)
    assert res["op2d/median/counts"]["all_gather"] == 0
    assert res["op2d/median/counts"]["p2p"] > 0
    want = convolution.sobel_magnitude(_t(x["planes2d"])).numpy()
    assert np.array_equal(res["op2d/sobel"], want)
    from zignal_tpu.ops.order_stat import median_blur as jmedian

    jwant = np.stack([np.asarray(jmedian(im, 2)) for im in x["batch2d"]])
    assert np.array_equal(res["op2d/median"], jwant)


def test_make_mesh_without_a_group_needs_one_rank():
    """With no process group running a mesh of more than one rank raises
    (in this test process no group is ever started)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="only 1 process is running"):
        P.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="no process group to join"):
        P.init_distributed(device="cpu")


def test_dryrun_multichip_on_cpu_ranks():
    from zignal_tpu_torch.entry import dryrun_multichip

    for n in (2, 4):
        dryrun_multichip(n, device="cpu")


def test_entry_returns_the_batch_callable():
    from zignal_tpu_torch.entry import entry
    from zignal_tpu_torch.pipeline import resize_blur_oklab

    fn, args = entry(device="cpu")
    (batch,) = args
    assert batch.shape == (2, 256, 256, 3) and batch.dtype == torch.uint8
    assert batch.device.type == "cpu"
    got = fn(*args)
    assert got.shape == (2, 128, 128, 3)
    assert torch.equal(got, resize_blur_oklab(batch, 128, 128, 1.5))
