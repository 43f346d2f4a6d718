"""The port's FDM, PCA, Matrix and CovarianceStats against zignal_tpu on
JAX-CPU, ``device="cpu"`` on the port's side.

Bounds:
- ``Matrix``, ``CovarianceStats``, ``PCA.fit`` / ``project`` /
  ``reconstruct`` / ``transform`` are host f64 copies: equal.
- ``PCA.fit_array`` / ``transform_array`` / ``reconstruct_array`` are f32
  reductions and matmuls in another order than XLA: within 1e-5
  relative.
- FDM's pixel map fed JAX's W and bias: equal (the port rounds as the
  compiled CPU program does: channels 0 and 1 unfused, channel 2 an FMA
  chain; ``fdm.py``'s docstring).
- FDM's means: equal (the port sums in XLA's tree order); the
  covariance within 1e-5 absolute. XLA's CPU dot chains all N products
  of ``xc.T @ xc`` through one f32 FMA accumulator, so the JAX package's
  covariance drifts from the exact one as N grows (1.6e-5 to 5.2e-5
  relative at 128^2, 5.6e-4 to 1.1e-3 at 1024^2); the port's tree stays
  within 1e-6 relative (``test_fdm_covariance_is_exact_where_jax_drifts``).
- FDM end to end (``match``, ``update``, ``match_batch``; colour and the
  three gray cases): JAX's covariance error moves its W, so at most 1 u8
  step at no more than 0.1 % of values (measured here on the colour
  path: 0 at 48x64, 0.050-0.056 % at 96x112, 0.016-0.083 % at 128^2;
  0 on the gray paths); PSNR within 0.01 dB and SSIM within 1e-4 of
  JAX's.

``python tests/test_torch_fdm_pca.py`` prints the measured shares and
covariance errors, from 48x64 up to 1024^2.
"""

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu import fdm as jfdm
from zignal_tpu.stats import CovarianceStats as JCovarianceStats

import zignal_tpu_torch as zp
from zignal_tpu_torch import fdm as pfdm
from zignal_tpu_torch.stats import CovarianceStats as PCovarianceStats

CPU = "cpu"
REL = 1e-5
STAT_ABS = 1e-5
SHARE = 1e-3        # of u8 values, at most 1 step off
PSNR_DB = 0.01
SSIM_ABS = 1e-4


def synth_photo(h, w, seed=0):
    """bench.py's synth_photo: smooth structure and grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([
        128 + 90 * np.sin(xx / 97.0) * np.cos(yy / 53.0),
        128 + 80 * np.cos(xx / 61.0 + yy / 41.0),
        128 + 70 * np.sin((xx + yy) / 151.0),
    ], axis=-1)
    noise = rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def cast_target(h, w, seed=4):
    """bench.py:490-494's target: crushed shadows, a warm cast."""
    t = synth_photo(h, w, seed).astype(np.float32) / 255.0
    t = t ** 2.2 * np.array([230.0, 180.0, 120.0]) + 20.0
    return np.clip(t, 0, 255).astype(np.uint8)


def _pair(arr):
    return (zp.Image.from_numpy(arr.copy(), device=CPU),
            jz.Image.from_numpy(arr.copy()))


def _close_u8(got, want):
    """At most one step off at no more than SHARE of the values; returns
    the share."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, int(d.max())
    share = float((d != 0).mean())
    assert share <= SHARE, share
    return share


# -- Matrix and CovarianceStats ----------------------------------------------

_A = np.random.default_rng(0).standard_normal((5, 5))
_B = np.random.default_rng(1).standard_normal((5, 3))
_MATRIX_OPS = {
    "dot": lambda M, a, b: M.from_numpy(a).dot(M.from_numpy(b)),
    "matmul": lambda M, a, b: M.from_numpy(a) @ M.from_numpy(b),
    "add": lambda M, a, b: M.from_numpy(a) + M.from_numpy(a),
    "sub_scalar": lambda M, a, b: M.from_numpy(a) - 1.5,
    "mul_scalar": lambda M, a, b: M.from_numpy(a) * 2.5,
    "transpose": lambda M, a, b: M.from_numpy(b).transpose(),
    "gram": lambda M, a, b: M.from_numpy(b).gram(),
    "covariance": lambda M, a, b: M.from_numpy(b).covariance(),
    "inv": lambda M, a, b: M.from_numpy(a).inv(),
    "solve": lambda M, a, b: M.from_numpy(a).solve(M.from_numpy(b)),
    "pinv": lambda M, a, b: M.from_numpy(b).pinv(),
    "det": lambda M, a, b: M.from_numpy(a).det(),
    "rank": lambda M, a, b: M.from_numpy(b).rank(),
    "trace": lambda M, a, b: M.from_numpy(a).trace(),
    "lu": lambda M, a, b: M.from_numpy(a).lu(),
    "chol": lambda M, a, b: M.from_numpy(a @ a.T + np.eye(5)).chol(),
    "qr": lambda M, a, b: M.from_numpy(b).qr(),
    "svd": lambda M, a, b: M.from_numpy(b).svd(),
    "eigh": lambda M, a, b: M.from_numpy(a + a.T).eigh(),
    "stats": lambda M, a, b: [getattr(M.from_numpy(a), n)() for n in (
        "sum", "mean", "min", "max", "variance", "std")],
    "sums": lambda M, a, b: [M.from_numpy(a).sum_rows(),
                             M.from_numpy(a).sum_cols()],
    "pow": lambda M, a, b: M.from_numpy(a).pow(3),
    "norms": lambda M, a, b: [getattr(M.from_numpy(a), n)() for n in (
        "frobenius_norm", "l1_norm", "max_norm", "nuclear_norm",
        "spectral_norm")] + [M.from_numpy(a).schatten_norm(3.0),
                             M.from_numpy(a).induced_norm(1.0),
                             M.from_numpy(a).element_norm(3.0)],
    "slices": lambda M, a, b: [M.from_numpy(a).row(2), M.from_numpy(a).col(1),
                               M.from_numpy(a).submatrix(1, 1, 3, 2)],
    "constructors": lambda M, a, b: [M.zeros(2, 3), M.ones(3, 2),
                                     M.identity(3, 4), M.full(2, 2, 7.0),
                                     M.random(3, 3, seed=4)],
}


def _plain(v):
    """Matrices to numpy, recursively, for an equality check."""
    if hasattr(v, "to_numpy"):
        return v.to_numpy()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", sorted(_MATRIX_OPS))
def test_matrix_copy_equals_jax(op):
    fn = _MATRIX_OPS[op]
    _assert_same(_plain(fn(zp.Matrix, _A, _B)), _plain(fn(jz.Matrix, _A, _B)))


def test_covariance_stats_copy_equals_jax():
    rng = np.random.default_rng(2)
    samples = rng.standard_normal((50, 3))
    stats = []
    for cls in (PCovarianceStats, JCovarianceStats):
        s = cls(3)
        for v in samples[:7]:
            s.add(v)
        s.extend(samples[7:30])
        s.extend(samples[30:])
        stats.append(s)
    p, j = stats
    assert p.count == j.count == 50
    np.testing.assert_array_equal(p.mean(), j.mean())
    np.testing.assert_array_equal(p.variance_vector(), j.variance_vector())
    np.testing.assert_array_equal(p.covariance_matrix().to_numpy(),
                                  j.covariance_matrix().to_numpy())
    assert isinstance(p.covariance_matrix(), zp.Matrix)


# -- PCA --------------------------------------------------------------------

def test_pca_fit_transform_project_equal_jax():
    data = np.random.default_rng(3).standard_normal((12, 5))
    p, j = zp.PCA(), jz.PCA()
    p.fit(zp.Matrix.from_numpy(data), num_components=3)
    j.fit(jz.Matrix.from_numpy(data), num_components=3)
    assert (p.dim, p.num_components) == (j.dim, j.num_components) == (5, 3)
    assert p.mean == j.mean and p.eigenvalues == j.eigenvalues
    np.testing.assert_array_equal(
        p.transform(zp.Matrix.from_numpy(data)).to_numpy(),
        j.transform(jz.Matrix.from_numpy(data)).to_numpy())
    coeffs = p.project(list(data[4]))
    assert coeffs == j.project(list(data[4]))
    assert p.reconstruct(coeffs) == j.reconstruct(coeffs)


@pytest.mark.parametrize("shape,k", [((32, 40, 3), None), ((500, 6), 4)])
def test_pca_arrays_within_bound_of_jax(shape, k):
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    x[..., 0] *= 3.0  # a dominant direction
    p, j = zp.PCA(), jz.PCA()
    p.fit_array(torch.from_numpy(x), k)
    j.fit_array(x, k)
    np.testing.assert_allclose(p.mean, j.mean, rtol=REL, atol=REL)
    np.testing.assert_allclose(p.eigenvalues, j.eigenvalues, rtol=REL)
    # eigenvectors up to sign
    pc, jc = p._components, j._components
    signs = np.sign((pc * jc).sum(axis=0))
    np.testing.assert_allclose(pc * signs, jc, atol=REL)
    # the projection from one fitted state (JAX's), each side
    p._mean, p._components, p._eigenvalues = j._mean, j._components, \
        j._eigenvalues
    got = p.transform_array(x, device=CPU)
    want = np.asarray(j.transform_array(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=REL)
    back = p.reconstruct_array(got)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(j.reconstruct_array(want)),
                               rtol=REL, atol=REL)


def test_pca_array_inputs_name_their_device():
    x = np.random.default_rng(5).random((20, 3)).astype(np.float32)
    p = zp.PCA()
    with pytest.raises(ValueError, match="device"):
        p.fit_array(x)
    p.fit_array(x, device=CPU)
    with pytest.raises(ValueError, match="device"):
        p.transform_array(x)
    assert p.transform_array(torch.from_numpy(x)).device.type == "cpu"
    # the precision setting is the caller's again after the call
    assert torch.get_float32_matmul_precision() == "highest"
    torch.set_float32_matmul_precision("high")
    try:
        p.fit_array(x, device=CPU)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")


# -- FDM: each stage fed JAX's state ------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64, 3), (2, 40, 56, 3)])
def test_fdm_pixel_map_fed_jax_weights_equals_jax(shape):
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, shape, np.uint8)
    lead = shape[:-3]
    w = np.eye(3) + rng.normal(0, 0.3, lead + (3, 3))
    bias = rng.normal(0, 0.1, lead + (3,))
    got = pfdm._apply_map(
        pfdm._unit(torch.from_numpy(x)).reshape(*lead, -1, 3), w, bias)
    if lead:
        # match_batch's compiled map
        xf = jnp.asarray(x).astype(jnp.float32).reshape(lead[0], -1, 3) / 255.0
        res = jnp.clip(jnp.einsum("bnc,bcd->bnd", xf,
                                  jnp.asarray(w, jnp.float32),
                                  precision="highest")
                       + jnp.asarray(bias, jnp.float32)[:, None, :], 0.0, 1.0)
        want = np.asarray(jnp.floor(res * 255.0 + 0.5).astype(jnp.uint8))
    else:
        want = np.asarray(jfdm._apply_map(x, w, bias)).reshape(-1, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(72, 88, 3), (2, 40, 56, 3)])
def test_fdm_statistics_within_bound_of_jax(shape):
    x = synth_photo(72, 88, 3) if len(shape) == 3 else \
        np.stack([synth_photo(*shape[1:3], seed=s) for s in (1, 2)])
    xf = pfdm._unit(torch.from_numpy(x)).reshape(*shape[:-3], -1, 3)
    mean, cov = pfdm._mean_cov(xf)
    if len(shape) == 3:
        jmean, jcov = jfdm._mean_cov_device(x)
    else:
        jmean, jcov = zip(*(jfdm._mean_cov_device(im) for im in x))
    np.testing.assert_array_equal(mean, np.asarray(jmean))
    np.testing.assert_allclose(cov, np.asarray(jcov), atol=STAT_ABS, rtol=0)


def test_tree_sum_takes_xla_order():
    import jax
    import jax.numpy as jnp

    for shape in [(96, 112), (40, 52), (333, 47), (20, 112), (112, 20)]:
        x = np.random.default_rng(sum(shape)).integers(0, 256, shape) \
            .astype(np.float32) * np.float32(1 / 255)
        want = np.asarray(jax.jit(jnp.sum)(x))
        assert pfdm._tree_sum(torch.from_numpy(x), 2).numpy() == want
        want_cols = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(x))
        np.testing.assert_array_equal(
            pfdm._tree_sum(torch.from_numpy(x.T.copy()), 1).numpy(),
            want_cols)


def test_fdm_covariance_is_exact_where_jax_drifts():
    """ROADMAP §3: the JAX package's f32 covariance drifts with N (one
    FMA accumulator over all pixels); the port's stays near the f64
    answer."""
    x = synth_photo(128, 128, 3)
    xd = (x.reshape(-1, 3).astype(np.float32) * np.float32(1 / 255)) \
        .astype(np.float64)
    exact = np.cov(xd.T)
    _, cov = pfdm._mean_cov(pfdm._unit(torch.from_numpy(x)).reshape(-1, 3))
    _, jcov = jfdm._mean_cov_device(x)
    scale = np.abs(exact).max()
    assert np.abs(cov - exact).max() <= 1e-6 * scale
    assert np.abs(jcov - exact).max() >= 1e-5 * scale
    p, j = _pair(x)
    pm, pv = pfdm._gray_stats(p)
    jm, jv = jfdm._gray_stats(j)
    assert abs(pm - jm) <= STAT_ABS and abs(pv - jv) <= STAT_ABS


# -- FDM end to end -----------------------------------------------------------

def _quality(p_out, j_out, source):
    """PSNR and SSIM of each result against the source."""
    ps, js = _pair(source)
    assert abs(ps.psnr(p_out) - js.psnr(j_out)) <= PSNR_DB
    assert abs(ps.ssim(p_out) - js.ssim(j_out)) <= SSIM_ABS


@pytest.mark.parametrize("shape", [(48, 64), (96, 112)])
def test_fdm_match_colour_end_to_end(shape):
    src = synth_photo(*shape, seed=3)
    tgt = cast_target(*shape)
    ps, js = _pair(src)
    pt, jt = _pair(tgt)
    pf, jf = zp.FeatureDistributionMatching(), jz.FeatureDistributionMatching()
    pf.match(ps, pt)
    jf.match(js, jt)
    _close_u8(ps.to_numpy(), js.to_numpy())
    _quality(ps, js, src)
    # update() on a second source against the kept target
    src2 = synth_photo(*shape, seed=7)
    ps2, js2 = _pair(src2)
    pf.set_source(ps2)
    pf.update()
    jf.set_source(js2)
    jf.update()
    _close_u8(ps2.to_numpy(), js2.to_numpy())


def _gray(arr):
    return np.ascontiguousarray(arr[..., :1])


@pytest.mark.parametrize("case", ["gray_source", "gray_target", "both_gray",
                                  "rgba_source"])
def test_fdm_gray_paths_and_rgba_end_to_end(case):
    src = synth_photo(40, 52, seed=8)
    tgt = cast_target(40, 52)
    if case in ("gray_source", "both_gray"):
        src = _gray(src)
    if case in ("gray_target", "both_gray"):
        tgt = _gray(tgt)
    if case == "rgba_source":
        src = np.concatenate([src, np.full_like(src[..., :1], 200)], axis=-1)
    ps, js = _pair(src)
    pt, jt = _pair(tgt)
    zp.FeatureDistributionMatching().match(ps, pt)
    jz.FeatureDistributionMatching().match(js, jt)
    _close_u8(ps.to_numpy(), js.to_numpy())
    if case != "rgba_source":
        _quality(ps, js, src)


def test_fdm_match_batch_end_to_end_equals_its_images():
    b = np.stack([synth_photo(40, 48, seed=s) for s in (11, 12, 13)])
    tgt = cast_target(40, 48)
    pt, jt = _pair(tgt)
    got = zp.FeatureDistributionMatching().match_batch(torch.from_numpy(b), pt)
    want = np.asarray(jz.FeatureDistributionMatching().match_batch(b, jt))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    _close_u8(got.numpy(), want)
    # an ImageBatch runs on its device; numpy names its device
    ib = zp.ImageBatch(b, device=CPU)
    fdm = zp.FeatureDistributionMatching()
    assert torch.equal(fdm.match_batch(ib, pt), got)
    assert torch.equal(fdm.match_batch(b, pt, device=CPU), got)
    with pytest.raises(ValueError, match="device"):
        fdm.match_batch(b, pt)
    # each image of the batch is the single-image map
    one = zp.Image.from_numpy(b[1].copy(), device=CPU)
    fdm.match(one, pt)
    np.testing.assert_array_equal(got[1].numpy(), one.to_numpy())


def test_fdm_errors_and_sharded_path():
    fdm = zp.FeatureDistributionMatching()
    with pytest.raises(RuntimeError):
        fdm.update()
    with pytest.raises(TypeError):
        fdm.set_target(np.zeros((4, 4, 3), np.uint8))
    gray = zp.Image.from_numpy(np.zeros((8, 8, 1), np.uint8), device=CPU)
    with pytest.raises(ValueError, match="color target"):
        fdm.match_batch(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), gray)
    rgb = zp.Image.from_numpy(synth_photo(8, 8), device=CPU)
    with pytest.raises(NotImplementedError, match="item 15"):
        fdm.match_sharded(None, rgb, None)


def _report():
    """The shares and covariance errors quoted in this file's docstring
    and in ROADMAP §3, on the CPU, at the bench's inputs from 48x64 up to
    1024^2 (the large sizes take a minute)."""
    for h, w in ((48, 64), (96, 112), (128, 128), (256, 256), (512, 512),
                 (1024, 1024)):
        for seed in (3, 7):
            src, tgt = synth_photo(h, w, seed), cast_target(h, w)
            ps, js = _pair(src)
            pt, jt = _pair(tgt)
            zp.FeatureDistributionMatching().match(ps, pt)
            jz.FeatureDistributionMatching().match(js, jt)
            d = np.abs(ps.to_numpy().astype(np.int32) - js.to_numpy())
            xd = (src.reshape(-1, 3).astype(np.float32)
                  * np.float32(1 / 255)).astype(np.float64)
            exact = np.cov(xd.T)
            _, cov = pfdm._mean_cov(
                pfdm._unit(torch.from_numpy(src)).reshape(-1, 3))
            _, jcov = jfdm._mean_cov_device(src)
            scale = np.abs(exact).max()
            print(f"{h}x{w} seed {seed}: {int((d != 0).sum())} of {d.size} "
                  f"u8 values differ ({100 * (d != 0).mean():.4f} %, max "
                  f"{int(d.max())}); covariance relative error: JAX "
                  f"{np.abs(jcov - exact).max() / scale:.3g}, port "
                  f"{np.abs(cov - exact).max() / scale:.3g}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _report()
