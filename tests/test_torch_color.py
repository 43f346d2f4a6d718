"""The port's colour graph, u8 edges and fused chain against zignal_tpu on
JAX-CPU (zignal_tpu_torch/color/, ops/color_chain.py,
pipeline.color_chain_u8 and pipeline.color_chain_values).

Tolerances, stated once:
- UNIT = 1e-5 max-abs on unit-range channels (rgb, gray, ycbcr, lms,
  oklab, xyb, alpha);
- SCALED = 5e-4 max-abs on 0-100-scaled channels (xyz, lab, L and C of
  lch, s and v/l of hsv/hsl);
- beyond the nominal range (an out-of-gamut input can give a chroma of
  466) the tolerance grows with the value: the error is divided by
  max(1, |value| / range);
- a hue is compared through its cartesian form (C cos h, C sin h), with C
  the chroma: near grey the hue is ill-conditioned, so a direct comparison
  fails on correct code (0.58 degrees at chroma 1.3e-3);
- rgb reached from a linear space is compared in linear light: a dark
  channel is a difference of matrix terms near 1, and the sRGB curve
  multiplies its ulp-level error by up to 12.92, so the gamma values of two
  correct implementations differ by up to ~1e-4 there, still far inside
  BASELINE's 1/255, which the gamma values are also held to;
- hsv and hsl carry that gamma rgb (times 100) and divide by it (s is the
  chroma over v or over 1 - |2l - 1|, ill-conditioned near black and
  white), so they are compared through the rgb they encode, by the rgb
  rule, which weights the hue and the saturation by the chroma.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zignal_tpu.color import CLASS_BY_SPACE as JAX_CLASS_BY_SPACE
from zignal_tpu.color import _array as jax_array
from zignal_tpu.color import _scalar
from zignal_tpu.color import convert_array as jax_convert
from zignal_tpu.color import convert_chain as jax_chain
from zignal_tpu.color import convert_u8_array as jax_convert_u8
from zignal_tpu.ops import pallas_color
from zignal_tpu.pipeline import color_chain_u8 as jax_color_chain_u8

from zignal_tpu_torch import pipeline
from zignal_tpu_torch.color import (NUM_CHANNELS, conversion_path,
                                    convert_array, convert_chain,
                                    convert_u8_array)
from zignal_tpu_torch.color import _array as port_array
from zignal_tpu_torch.ops import color_chain as cc

UNIT = 1e-5
SCALED = 5e-4
BASELINE = 1.0 / 255.0

BENCH_CHAIN = ("rgb", "lab", "rgb", "oklch", "rgb", "xyb", "rgb")
KERNEL_CHAINS = [  # test_pallas_color.py's chains
    BENCH_CHAIN,
    ("rgb", "oklab", "rgb"),
    ("rgb", "lab", "lch", "lab", "rgb"),
    ("rgb", "xyz", "rgb"),
    ("rgb", "xyb", "rgb"),
    ("rgb", "oklch", "rgb"),
]
STOCK_CHAINS = [("rgb", "hsv", "rgb"), ("rgb", "xyz", "lch"), ("rgb", "lab")]
# a supported chain with a stock hop between two linear spaces
LINEAR_HOP_CHAINS = [("rgb", "xyz", "lab", "rgb"),
                     ("rgb", "lab", "oklab", "xyb", "rgb"),
                     ("rgb", "xyb", "xyz", "oklab", "oklch", "rgb"),
                     ("rgb", "oklab", "lab", "lch", "rgb")]
MULTI_HOP = [("hsv", "lab"), ("lch", "xyb"), ("ycbcr", "oklch"),
             ("gray", "lms"), ("hsl", "oklab"), ("lab", "hsv"),
             ("oklch", "hsl"), ("xyb", "lch"), ("lms", "rgb"),
             ("rgba", "lab"), ("xyz", "oklch"), ("oklab", "ycbcr"),
             ("lch", "gray"), ("hsv", "xyz")]


def _ids(pairs):
    return ["-".join(p) for p in pairs]


def _inputs(space, n, seed):
    """Random values in ``space``'s nominal float range."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)  # noqa: E731
    cols = {
        "hsv": [u(0, 360), u(0, 100), u(0, 100)],
        "hsl": [u(0, 360), u(0, 100), u(0, 100)],
        "lab": [u(0, 100), u(-80, 80), u(-80, 80)],
        "lch": [u(0, 100), u(0, 80), u(0, 360)],
        "xyz": [u(0, 95), u(0, 100), u(0, 108)],
        "oklab": [u(0, 1), u(-0.3, 0.3), u(-0.3, 0.3)],
        "oklch": [u(0, 1), u(0, 0.3), u(0, 360)],
        "ycbcr": [u(0, 1), u(-0.5, 0.5), u(-0.5, 0.5)],
        "xyb": [u(-0.03, 0.03), u(0, 0.8), u(0, 0.8)],
        "lms": [u(0, 1), u(0, 1), u(0, 1)],
    }.get(space)
    if cols is None:
        cols = [u(0, 1) for _ in range(NUM_CHANNELS[space])]
    return np.stack(cols, -1).astype(np.float32)


def _lin(c):
    """sRGB -> linear light in f64 (the comparison of rgb values)."""
    c = np.asarray(c, np.float64)
    return np.where(c > 0.04045,
                    ((np.maximum(c, 0.04045) + 0.055) / 1.055) ** 2.4,
                    c / 12.92)


def _hue_cart(h, c):
    hr = np.radians(np.asarray(h, np.float64))
    return c * np.cos(hr), c * np.sin(hr)


def _rel(g, w, scale):
    """max |g - w|, each divided by max(1, |w| / scale)."""
    return float((np.abs(g - w) / np.maximum(1.0, np.abs(w) / scale)).max())


def _err(space, got, want):
    """{channel name: (error, tolerance)} of ``got`` against ``want``."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    out = {}
    if space in ("rgb", "rgba"):
        out["rgb linear"] = (_rel(_lin(g[..., :3]), _lin(w[..., :3]), 1.0),
                             UNIT)
        out["rgb gamma"] = (np.abs(g[..., :3] - w[..., :3]).max(), BASELINE)
        if space == "rgba":
            out["alpha"] = (_rel(g[..., 3], w[..., 3], 1.0), UNIT)
    elif space in ("hsv", "hsl"):
        to_rgb = jax_array.hsv_to_rgb if space == "hsv" \
            else jax_array.hsl_to_rgb
        for name, (err, tol) in _err(
                "rgb", np.asarray(to_rgb(jnp.asarray(got, jnp.float32))),
                np.asarray(to_rgb(jnp.asarray(want, jnp.float32)))).items():
            out[f"{space} as {name}"] = (err, tol)
    elif space in ("lch", "oklch"):
        tol, scale = (SCALED, 100.0) if space == "lch" else (UNIT, 1.0)
        out["L"] = (_rel(g[..., 0], w[..., 0], scale), tol)
        out["C"] = (_rel(g[..., 1], w[..., 1], scale), tol)
        gc, gs = _hue_cart(g[..., 2], g[..., 1])
        wc, ws = _hue_cart(w[..., 2], w[..., 1])
        out["C cos h, C sin h"] = (max(_rel(gc, wc, scale),
                                       _rel(gs, ws, scale)), tol)
    else:
        tol, scale = (SCALED, 100.0) if space in ("xyz", "lab") \
            else (UNIT, 1.0)
        out[space] = (_rel(g, w, scale), tol)
    return out


def _assert_close(space, got, want):
    for name, (err, tol) in _err(space, got, want).items():
        assert err <= tol, f"{space} {name}: {err} > {tol}"


def _both(src, dst, x):
    got = convert_array(torch.from_numpy(x), src, dst).numpy()
    want = np.asarray(jax_convert(jnp.asarray(x), src, dst))
    return got, want


# -- the fault of the port's cube root -------------------------------------


def test_rgb_to_oklab_is_finite_where_lms_goes_negative():
    rows = np.array([[-0.5, 0, 0], [0, -0.2, 0.1], [1.2, 0.5, -0.01],
                     [0.5, 0.5, 0.5]], np.float32)
    got, want = _both("rgb", "oklab", rows)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6
    assert np.allclose(want[:2], [[-0.2124, -0.0761, -0.0426],
                                  [-0.2101, 0.1779, -0.2718]], atol=1e-4)


def test_cube_root_is_real_below_zero():
    x = torch.tensor([-27.0, -8.0, -1e-6, 0.0, 1e-6, 8.0, 27.0])
    got = port_array._cbrt(x).numpy()
    assert np.abs(got - np.cbrt(x.numpy())).max() <= 1e-6
    assert got[3] == 0.0


# -- the float graph --------------------------------------------------------


def test_path_tables_equal_the_jax_package():
    from zignal_tpu_torch.color import _path

    assert _path._DIRECT == frozenset(_scalar._DIRECT)
    assert _path._FALLBACK == _scalar._FALLBACK
    assert _path._SPECIAL == _scalar._SPECIAL
    assert _path.SPACES == _scalar.SPACES
    for src in _scalar.SPACES:
        for dst in _scalar.SPACES:
            assert conversion_path(src, dst) == \
                _scalar.conversion_path(src, dst)


EDGES = list(jax_array._EDGES) + list(jax_array._FUSED_EDGES)


def test_the_edge_tables_cover_the_jax_package():
    assert set(port_array._EDGES) == set(jax_array._EDGES)
    assert set(port_array._FUSED_EDGES) == set(jax_array._FUSED_EDGES)
    for name in ("_RGB2XYZ", "_XYZ2RGB", "_XYZ2LMS", "_LMS2XYZ",
                 "_XYZ2OKLMS", "_OKLMS2LAB", "_OKLAB2LMS", "_OKLMS2XYZ",
                 "_RGB2OKLMS", "_OKLMS2RGB", "_LINRGB2XYBMIX",
                 "_XYBMIX2LINRGB"):
        assert getattr(port_array, name) == getattr(jax_array, name), name


@pytest.mark.parametrize("src,dst", EDGES + MULTI_HOP,
                         ids=_ids(EDGES + MULTI_HOP))
def test_convert_array_matches_jax(src, dst):
    x = _inputs(src, 4096, seed=len(src) * 31 + len(dst))
    got, want = _both(src, dst, x)
    assert got.dtype == np.float32 and got.shape[-1] == NUM_CHANNELS[dst]
    _assert_close(dst, got, want)


RGB_EDGES = [e for e in EDGES if e[0] == "rgb"] + [("rgb", "lab"),
                                                   ("rgb", "lch")]


@pytest.mark.parametrize("src,dst", RGB_EDGES, ids=_ids(RGB_EDGES))
def test_convert_array_matches_jax_outside_the_gamut(src, dst):
    x = np.random.default_rng(5).uniform(-0.5, 1.5, (2048, 3)) \
        .astype(np.float32)
    got, want = _both(src, dst, x)
    _assert_close(dst, got, want)


def test_convert_array_casts_and_checks_channels():
    x = np.random.default_rng(6).integers(0, 2, (4, 5, 3)).astype(np.float64)
    got = convert_array(torch.from_numpy(x), "rgb", "xyz")
    assert got.dtype == torch.float32 and got.shape == (4, 5, 3)
    ident = convert_array(torch.from_numpy(x), "rgb", "rgb")
    assert ident.dtype == torch.float32
    assert np.array_equal(ident.numpy(), x.astype(np.float32))
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        convert_array(torch.zeros(4, 4), "rgb", "lab")
    with pytest.raises(ValueError, match="unknown"):
        convert_array(torch.zeros(4, 3), "rgb", "cmyk")


# -- the u8 edges -----------------------------------------------------------

U8_SPACES = ("gray", "rgb", "rgba", "ycbcr")
U8_PAIRS = [(s, d) for s in U8_SPACES for d in U8_SPACES]


@pytest.mark.parametrize("src,dst", U8_PAIRS, ids=_ids(U8_PAIRS))
def test_convert_u8_array_matches_jax(src, dst):
    x = np.random.default_rng(7).integers(
        0, 256, (3, 17, 19, NUM_CHANNELS[src]), np.uint8)
    got = convert_u8_array(torch.from_numpy(x), src, dst).numpy()
    want = np.asarray(jax_convert_u8(jnp.asarray(x), src, dst))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


def _all_triples():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)


def test_u8_ycbcr_round_trip_and_gray_on_every_rgb_triple():
    x = _all_triples()
    xt = torch.from_numpy(x)
    ycc = convert_u8_array(xt, "rgb", "ycbcr")
    assert np.array_equal(ycc.numpy(),
                          np.asarray(jax_convert_u8(x, "rgb", "ycbcr")))
    back = convert_u8_array(ycc, "ycbcr", "rgb").numpy()
    assert np.array_equal(back, np.asarray(
        jax_convert_u8(np.asarray(ycc), "ycbcr", "rgb")))
    gray = convert_u8_array(xt, "rgb", "gray").numpy()
    assert np.array_equal(gray, np.asarray(jax_convert_u8(x, "rgb", "gray")))


def test_ycbcr_to_rgb_truncates_toward_zero():
    # negative chroma terms: the int32 cast truncates, a floor would not
    x = torch.tensor([[0, 0, 0], [10, 0, 255], [255, 255, 0],
                      [128, 1, 2]], dtype=torch.uint8)
    want = np.asarray(jax_convert_u8(x.numpy(), "ycbcr", "rgb"))
    assert np.array_equal(convert_u8_array(x, "ycbcr", "rgb").numpy(), want)


def test_convert_u8_array_rejects_float_spaces():
    with pytest.raises(ValueError, match="u8"):
        convert_u8_array(torch.zeros(2, 3, dtype=torch.uint8), "rgb", "lab")


# -- the package's scalar names: the 13 classes and the scalar conversions --

U8_SPACES = ("gray", "rgb", "rgba", "ycbcr")


def _scalar_samples(spec, rng, n=4):
    """Seeded in-range component tuples of a class spec (the JAX
    package's ``_SPECS`` entry)."""
    _, _, ints, ranges, _ = spec
    return [tuple(int(rng.integers(lo, hi + 1)) if ints
                  else float(rng.uniform(lo, min(hi, 200.0)))
                  for lo, hi in ranges) for _ in range(n)]


@pytest.mark.parametrize("src", list(JAX_CLASS_BY_SPACE))
def test_color_package_scalar_names_match_jax(src):
    """zignal_tpu_torch.color's classes, CLASS_BY_SPACE, convert_float and
    convert_u8 against zignal_tpu.color's, from ``src`` to every space:
    the same pure-Python f64 arithmetic, so equal."""
    import zignal_tpu.color as jc
    import zignal_tpu_torch.color as pc
    from zignal_tpu.color._classes import _SPECS

    assert list(pc.CLASS_BY_SPACE) == list(jc.CLASS_BY_SPACE)
    pcls, jcls = pc.CLASS_BY_SPACE[src], jc.CLASS_BY_SPACE[src]
    assert pcls.__name__ == jcls.__name__ and getattr(pc, pcls.__name__) \
        is pcls
    rng = np.random.default_rng(list(JAX_CLASS_BY_SPACE).index(src))
    for vals in _scalar_samples(_SPECS[jcls.__name__], rng):
        p, j = pcls(*vals), jcls(*vals)
        for dst, jdst in jc.CLASS_BY_SPACE.items():
            assert pc.convert_float(src, dst, vals) == \
                jc.convert_float(src, dst, vals), (vals, dst)
            if src in U8_SPACES and dst in U8_SPACES:
                assert pc.convert_u8(src, dst, vals) == \
                    jc.convert_u8(src, dst, vals), (vals, dst)
            got = p.to(pc.CLASS_BY_SPACE[dst])
            assert type(got).__name__ == jdst.__name__
            assert got._v == j.to(jdst)._v, (vals, dst)


# -- the chain --------------------------------------------------------------


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _extremes():
    """test_pallas_color.py's extreme-values plane: all 0 / all 255 /
    1 / a saturated channel, on both sides of every branch."""
    x = np.zeros((1, 32, 128, 3), np.uint8)
    x[0, :8] = 255
    x[0, 8:16] = 1
    x[0, 16:24, :, 0] = 255
    return x


CHAINS = KERNEL_CHAINS + STOCK_CHAINS + LINEAR_HOP_CHAINS


@pytest.mark.parametrize("spaces", CHAINS, ids=_ids(CHAINS))
def test_convert_chain_matches_jax(spaces):
    x = _u8((2, 16, 64, 3), 8).astype(np.float32) / 255.0
    got = convert_chain(torch.from_numpy(x), spaces).numpy()
    want = np.asarray(jax_chain(jnp.asarray(x), spaces))
    _assert_close(spaces[-1], got, want)


def test_convert_chain_rejects_short_chains():
    with pytest.raises(ValueError, match="at least"):
        convert_chain(torch.zeros(2, 3), ("rgb",))


def _jax_planar(x, spaces):
    """JAX's kernel math (_chain_planar_u8, exact profile) in plain jnp,
    and its f32 values before the quantization (convert_chain)."""
    xj = jnp.asarray(x)
    u8 = np.stack(pallas_color._chain_planar_u8(
        tuple(xj[..., c] for c in range(3)), spaces), -1)
    f = np.asarray(jax_chain(xj.astype(jnp.float32) / 255.0, spaces))
    return u8, f


@pytest.mark.parametrize("spaces", KERNEL_CHAINS, ids=_ids(KERNEL_CHAINS))
@pytest.mark.parametrize("which", ["random", "extremes"])
def test_chain_reference_matches_the_tpu_kernel_math(spaces, which):
    x = _u8((2, 64, 128, 3), 9) if which == "random" else _extremes()
    want_u8, want_f = _jax_planar(x, spaces)
    xt = torch.from_numpy(x)
    got_u8 = cc.fused_color_chain_u8_reference(xt, spaces).numpy()
    got_f = cc.fused_color_chain_u8_reference(xt, spaces,
                                              quantize=False).numpy()
    assert got_u8.dtype == np.uint8 and got_f.dtype == np.float32
    assert np.array_equal(got_u8, np.asarray(want_u8))
    _assert_close("rgb", got_f, want_f)
    # the wrapper on a CPU tensor is the plain version
    assert np.array_equal(cc.fused_color_chain_u8(xt, spaces).numpy(),
                          got_u8)


def test_chain_reference_matches_the_tpu_kernel_in_interpret_mode():
    x = _u8((2, 64, 128, 3), 10)
    want = np.asarray(pallas_color.fused_color_chain_u8(
        jnp.asarray(x), BENCH_CHAIN, interpret=True))
    got = cc.fused_color_chain_u8_reference(torch.from_numpy(x), BENCH_CHAIN)
    assert np.array_equal(got.numpy(), want)


def test_bench_chain_on_a_lattice_of_rgb_triples():
    x = _all_triples()[::17][None, None]            # ~1M triples
    got = cc.fused_color_chain_u8_reference(torch.from_numpy(x), BENCH_CHAIN)
    want, _ = _jax_planar(x, BENCH_CHAIN)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), x)            # the chain is identity


@pytest.mark.parametrize("spaces", LINEAR_HOP_CHAINS,
                         ids=_ids(LINEAR_HOP_CHAINS))
def test_linear_hops_the_tpu_gate_admits_run_here(spaces):
    """The TPU gate admits a stock hop between two linear spaces, which the
    TPU kernel's state machine cannot trace (a fault of the JAX package,
    ROADMAP §3); the port's kernel has step codes for it and equals
    convert_chain."""
    assert pallas_color._chain_supported(spaces)
    x = _u8((1, 8, 128, 3), 11)
    with pytest.raises(AssertionError):
        pallas_color.fused_color_chain_u8(jnp.asarray(x), spaces,
                                          interpret=True)
    got = cc.fused_color_chain_u8_reference(torch.from_numpy(x), spaces,
                                            quantize=False).numpy()
    want = np.asarray(jax_chain(jnp.asarray(x, jnp.float32) / 255.0, spaces))
    _assert_close("rgb", got, want)


GATE_CHAINS = [
    BENCH_CHAIN, ("rgb", "xyz", "lch", "rgb"), ("rgb", "lab"),
    ("rgb", "hsv", "rgb"), ("rgb",), ("lab", "rgb"), ("rgb", "rgb"),
    ("rgb", "lch", "rgb"), ("rgb", "lch", "lab", "rgb"),
    ("rgb", "lab", "lch", "rgb"), ("rgb", "lch", "oklch", "rgb"),
    ("rgb", "oklch", "oklab", "xyb", "rgb"), ("rgb", "oklab", "lch", "rgb"),
    ("rgb", "lch"), ("rgb", "gray", "rgb"), ("rgb", "xyz", "lab", "rgb"),
    ("rgb", "lms", "rgb"), ("rgb", "lab", "lab", "rgb"),
    ("rgb", "oklch", "oklch", "rgb"), ("rgb", "ycbcr", "rgb"),
    *KERNEL_CHAINS, *LINEAR_HOP_CHAINS,
]


def test_chain_supported_is_the_tpu_gate():
    for spaces in GATE_CHAINS:
        assert cc.chain_supported(spaces) == \
            pallas_color._chain_supported(spaces), spaces
        assert cc.chain_supported(list(spaces)) == \
            cc.chain_supported(spaces)


# -- compile_chain: the host half of the kernel ------------------------------


def _interpret(codes, x_u8):
    """A numpy f32 model of the kernel (csrc/fused_color_chain_u8.cu): the
    step codes run on the constants table the wrapper passes, divisions as
    multiplications by the reciprocals rounded to f32, cube roots as
    sign * |x|^(1/3)."""
    table = cc.constants()
    m = {n: table[9 * i:9 * i + 9].reshape(3, 3)
         for i, n in enumerate(cc.MATRICES)}
    k = dict(zip(cc.SCALARS, table[9 * len(cc.MATRICES):]))
    f32 = np.float32

    def mix(v, name):
        t = m[name]
        return [f32(v[0] * t[0, j]) + f32(v[1] * t[1, j]) + f32(v[2] * t[2, j])
                for j in range(3)]

    def cbrt(x):
        return np.sign(x) * np.power(np.abs(x), k["ONE_THIRD"])

    def scale(v, s):
        return [c * s for c in v]

    def clip(v):
        return [np.clip(c, f32(0), f32(1)) for c in v]

    def g2l(c):
        return np.where(c > k["SRGB_GAMMA_THRESHOLD"],
                        np.power((c + k["SRGB_GAMMA_OFFSET"])
                                 * k["INV_SRGB_GAMMA_SCALE"],
                                 k["SRGB_GAMMA_EXPONENT"]),
                        c * k["INV_SRGB_LINEAR_SLOPE"])

    def l2g(c):
        return np.clip(np.where(
            c > k["SRGB_LINEAR_THRESHOLD"],
            k["SRGB_GAMMA_SCALE"] * np.power(np.maximum(c, f32(0)),
                                             k["SRGB_INV_GAMMA_EXPONENT"])
            - k["SRGB_GAMMA_OFFSET"],
            c * k["SRGB_LINEAR_SLOPE"]), f32(0), f32(1))

    def lab_f(t):
        return np.where(t > k["LAB_EPSILON"], cbrt(t),
                        k["LAB_KAPPA_DIV_116"] * t + k["LAB_DELTA"])

    def xyz_to_lab(v):
        fx, fy, fz = (lab_f(v[i] * k["INV_D65_" + a])
                      for i, a in enumerate("XYZ"))
        return [np.maximum(f32(116) * fy - f32(16), f32(0)),
                f32(500) * (fx - fy), f32(200) * (fy - fz)]

    def lab_to_xyz(v):
        fy = (v[0] + f32(16)) * k["INV_116"]
        fx = v[1] * k["INV_500"] + fy
        fz = fy - v[2] * k["INV_200"]

        def unf(f):
            f3 = f * f * f
            return np.where(f3 > k["LAB_EPSILON"], f3,
                            (f - k["LAB_DELTA"]) * k["INV_LAB_KAPPA_DIV_116"])

        return [unf(f) * k["D65_" + a] for f, a in zip((fx, fy, fz), "XYZ")]

    def lin_to_xyb(v):
        lms = [np.maximum(c + k["XYB_BIAS"], f32(0))
               for c in mix(v, "LINRGB2XYBMIX")]
        d = [cbrt(c) - k["XYB_CBRT_BIAS_ENCODE"] for c in lms]
        return [f32(0.5) * (d[0] - d[1]), f32(0.5) * (d[0] + d[1]), d[2]]

    def xyb_to_lin(v):
        dec, bias = k["XYB_CBRT_BIAS_DECODE"], k["XYB_BIAS"]
        d = [v[1] + v[0] + dec, v[1] - v[0] + dec, v[2] + dec]
        return mix([c * c * c - bias for c in d], "XYBMIX2LINRGB")

    def oklab_from_lms(v):
        return mix([cbrt(c) for c in v], "OKLMS2LAB")

    def oklab_to_lms3(v):
        return [c * c * c for c in mix(v, "OKLAB2LMS")]

    run = {
        "GAMMA_TO_LINEAR": lambda v: [g2l(c) for c in v],
        "LINEAR_TO_GAMMA": lambda v: [l2g(c) for c in v],
        "LIN_TO_XYZ": lambda v: scale(mix(v, "RGB2XYZ"), f32(100)),
        "LIN_TO_LAB": lambda v: xyz_to_lab(scale(mix(v, "RGB2XYZ"),
                                                 f32(100))),
        "LIN_TO_OKLAB": lambda v: oklab_from_lms(mix(v, "RGB2OKLMS")),
        "LIN_TO_XYB": lin_to_xyb,
        "XYZ_TO_LIN": lambda v: clip(mix(scale(v, k["INV_100"]), "XYZ2RGB")),
        "LAB_TO_LIN": lambda v: clip(mix(scale(lab_to_xyz(v), k["INV_100"]),
                                         "XYZ2RGB")),
        "OKLAB_TO_LIN": lambda v: clip(mix(oklab_to_lms3(v), "OKLMS2RGB")),
        "XYB_TO_LIN": lambda v: clip(xyb_to_lin(v)),
        "SHADOW": lambda v: v,
        "XYZ_TO_LAB": xyz_to_lab,
        "LAB_TO_XYZ": lab_to_xyz,
        "XYZ_TO_OKLAB": lambda v: oklab_from_lms(mix(scale(v, k["INV_100"]),
                                                     "XYZ2OKLMS")),
        "OKLAB_TO_XYZ": lambda v: scale(mix(oklab_to_lms3(v), "OKLMS2XYZ"),
                                        f32(100)),
        "XYZ_TO_XYB": lambda v: lin_to_xyb(scale(mix(v, "XYZ2RGB"),
                                                 k["INV_100"])),
        "XYB_TO_XYZ": lambda v: scale(mix(xyb_to_lin(v), "RGB2XYZ"),
                                      f32(100)),
    }
    assert set(run) == set(cc.STEPS)
    v = [x_u8[..., c].astype(f32) * k["INV_255"] for c in range(3)]
    with np.errstate(all="ignore"):
        for code in codes:
            v = [np.asarray(c, f32) for c in run[cc.STEPS[code]](v)]
    return np.stack(v, -1)


STEP_CHAINS = KERNEL_CHAINS + LINEAR_HOP_CHAINS + [
    ("rgb", "rgb"), ("rgb", "lch", "rgb"), ("rgb", "lch", "lab", "rgb"),
    ("rgb", "oklch", "oklab", "xyz", "rgb"), ("rgb", "rgb", "xyb", "rgb"),
    ("rgb", "xyb", "xyz", "lab", "oklab", "rgb"),
]


@pytest.mark.parametrize("spaces", STEP_CHAINS, ids=_ids(STEP_CHAINS))
def test_compiled_steps_reproduce_the_chain(spaces):
    x = np.concatenate([_u8((1, 40, 128, 3), 12), _extremes()[:, :24]], 1)
    codes = cc.compile_chain(spaces)
    assert len(codes) <= cc.MAX_STEPS and cc.compile_chain(spaces) is codes
    got = _interpret(codes, x)
    want = cc.fused_color_chain_u8_reference(torch.from_numpy(x), spaces,
                                             quantize=False).numpy()
    _assert_close("rgb", got, want)
    q = np.clip(np.rint(got * np.float32(255)), 0, 255).astype(np.uint8)
    assert np.array_equal(q, cc.fused_color_chain_u8_reference(
        torch.from_numpy(x), spaces).numpy())


def test_compiled_steps_of_the_bench_chain():
    assert [cc.STEPS[c] for c in cc.compile_chain(BENCH_CHAIN)] == [
        "GAMMA_TO_LINEAR", "LIN_TO_LAB", "LAB_TO_LIN", "LIN_TO_OKLAB",
        "SHADOW", "OKLAB_TO_LIN", "LIN_TO_XYB", "XYB_TO_LIN",
        "LINEAR_TO_GAMMA"]
    assert cc.compile_chain(("rgb", "rgb")) == ()
    with pytest.raises(ValueError, match="does not run"):
        cc.compile_chain(("rgb", "hsv", "rgb"))


# -- pipeline.color_chain_u8 -------------------------------------------------


@pytest.mark.parametrize("spaces", [BENCH_CHAIN, ("rgb", "hsv", "rgb"),
                                    ("rgb", "xyz", "lch", "rgb"),
                                    ("rgb", "ycbcr", "rgb")],
                         ids=["bench", "hsv", "xyz-lch", "ycbcr"])
def test_color_chain_u8_matches_jax(spaces):
    x = _u8((2, 32, 64, 3), 13)
    got = pipeline.color_chain_u8(torch.from_numpy(x), spaces)
    want = np.asarray(jax_color_chain_u8(jnp.asarray(x), spaces))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_color_chain_u8_routes_from_the_chain_alone(monkeypatch):
    calls = []
    real = cc.fused_color_chain_u8
    monkeypatch.setattr(pipeline, "fused_color_chain_u8",
                        lambda b, s: calls.append(s) or real(b, s))
    x = torch.from_numpy(_u8((1, 4, 6, 3), 14))
    pipeline.color_chain_u8(x, BENCH_CHAIN)
    pipeline.color_chain_u8(x, ("rgb", "hsv", "rgb"))
    pipeline.color_chain_u8(x[:, :, ::2], list(BENCH_CHAIN))
    assert calls == [BENCH_CHAIN, BENCH_CHAIN]


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match=r"uint8 \[B, H, W, 3\]"):
        cc.fused_color_chain_u8(torch.zeros(1, 4, 4, 3), BENCH_CHAIN)
    with pytest.raises(ValueError, match=r"uint8 \[B, H, W, 3\]"):
        cc.fused_color_chain_u8(torch.zeros(1, 4, 4, 4, dtype=torch.uint8),
                                BENCH_CHAIN)
    with pytest.raises(ValueError, match="does not run"):
        cc.fused_color_chain_u8(torch.zeros(1, 4, 4, 3, dtype=torch.uint8),
                                ("rgb", "hsv", "rgb"))
    with pytest.raises(ValueError, match="no kernel for device"):
        cc.fused_color_chain_u8(
            torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device="meta"),
            BENCH_CHAIN)


# -- pipeline.color_chain_values: K3's f32-values route ----------------------

VALUE_CHAINS = [("rgb", "xyz"), ("rgb", "lab"), ("rgb", "oklab"),
                ("rgb", "xyb"), ("rgb", "lab", "rgb", "oklch", "rgb", "lab")]


@pytest.mark.parametrize("spaces", VALUE_CHAINS, ids=_ids(VALUE_CHAINS))
@pytest.mark.parametrize("which", ["random", "extremes"])
def test_color_chain_values_match_jax_convert_chain(spaces, which):
    x = _u8((2, 32, 64, 3), 16) if which == "random" else _extremes()
    got = pipeline.color_chain_values(torch.from_numpy(x), spaces)
    want = np.asarray(jax_chain(jnp.asarray(x, jnp.float32) / 255.0, spaces))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_close(spaces[-1], got.numpy(), want)
    assert cc.values_chain_supported(spaces)
    # the route's plain version is the same values
    assert torch.equal(got, cc.fused_color_chain_u8_reference(
        torch.from_numpy(x), spaces, quantize=False))


@pytest.mark.parametrize("spaces", VALUE_CHAINS, ids=_ids(VALUE_CHAINS))
def test_compiled_steps_reproduce_the_values_chain(spaces):
    x = np.concatenate([_u8((1, 40, 128, 3), 17), _extremes()[:, :24]], 1)
    codes = cc.compile_chain(spaces)
    assert "LINEAR_TO_GAMMA" not in [cc.STEPS[c] for c in codes]
    want = cc.fused_color_chain_u8_reference(torch.from_numpy(x), spaces,
                                             quantize=False).numpy()
    _assert_close(spaces[-1], _interpret(codes, x), want)


def test_values_gate_takes_cartesian_ends_from_rgb():
    assert cc.values_chain_supported(["rgb", "lab"])
    assert cc.values_chain_supported(("rgb", "lch", "lab"))
    assert cc.values_chain_supported(("rgb", "oklch", "oklab", "xyz"))
    for spaces in [("rgb", "lch"), ("rgb", "oklch"), ("rgb", "lab", "lch"),
                   ("lab", "xyz"), ("xyz", "lab"), ("oklab", "rgb", "lab"),
                   ("rgb",), ("lab",), ("rgb", "rgb"), ("rgb", "hsv"),
                   ("rgb", "lms"), ("rgb", "hsv", "lab"), ("rgb", "gray"),
                   ("rgb", "lch", "oklab"), *KERNEL_CHAINS]:
        assert not cc.values_chain_supported(spaces), spaces
    # the rgb-to-rgb gate is the TPU's still, and takes no values chain
    for spaces in VALUE_CHAINS:
        assert not cc.chain_supported(spaces)
        assert not pallas_color._chain_supported(spaces)


def test_values_chain_is_never_quantized():
    x = torch.from_numpy(_u8((1, 4, 6, 3), 18))
    with pytest.raises(ValueError, match="does not run .* quantized"):
        cc.fused_color_chain_u8_reference(x, ("rgb", "lab"))
    with pytest.raises(ValueError, match="does not run .* quantized"):
        cc.fused_color_chain_u8(x, ("rgb", "lab"))
    with pytest.raises(ValueError, match="does not run"):
        cc.fused_color_chain_u8(x, ("rgb", "lch"), quantize=False)


def test_color_chain_values_routes_from_the_chain_alone(monkeypatch):
    calls = []
    real = cc.fused_color_chain_u8
    monkeypatch.setattr(pipeline, "fused_color_chain_u8",
                        lambda b, s, quantize=True: calls.append(
                            (s, quantize)) or real(b, s, quantize))
    x = torch.from_numpy(_u8((1, 4, 6, 3), 19))
    launches, values = cc.LAUNCHES, cc.VALUES
    lab = pipeline.color_chain_values(x, ["rgb", "lab"])
    lch = pipeline.color_chain_values(x, ("rgb", "lch"))
    odd = pipeline.color_chain_values(x[:, :, ::2], ("rgb", "lab"))
    flt = pipeline.color_chain_values(x.to(torch.float32), ("rgb", "lab"))
    assert calls == [(("rgb", "lab"), False)] * 2
    assert (cc.LAUNCHES, cc.VALUES) == (launches, values)  # the CPU's
    assert torch.equal(lch, convert_chain(x.to(torch.float32) / 255.0,
                                          ("rgb", "lch")))
    assert torch.equal(odd, lab[:, :, ::2]) and torch.equal(flt, lab)


# -- K3p's plain version ------------------------------------------------------


def test_gamma_table_matches_the_jax_gamma_curve():
    """K1's and K3's input gamma table against zignal_tpu's sRGB curve on
    the 256 bytes, on JAX-CPU: within UNIT, and 0 and 1 exactly."""
    from zignal_tpu_torch.ops.tables import gamma_table

    table = gamma_table("cpu")
    want = np.asarray(jax_array.gamma_to_linear(
        jnp.arange(256, dtype=jnp.float32) / 255.0))
    assert table.dtype == torch.float32 and table.shape == (256,)
    assert np.abs(table.numpy() - want).max() <= UNIT
    assert float(table[0]) == 0.0 and float(table[255]) == 1.0


def test_probe_reference_is_the_tpu_probe_expression():
    x = np.random.default_rng(15).uniform(0, 2, (8, 128)).astype(np.float32)
    x[0, :4] = [0.0, 0.5, 1.0, 2.0]
    got = cc.transcendentals_probe(torch.from_numpy(x)).numpy()
    xj = jnp.asarray(x)
    want = np.array(jnp.where(xj > 0.5, jnp.cbrt(xj) + xj ** 2.4,
                              xj ** (1 / 2.4) + xj ** 3))
    assert cc.probe_error(torch.from_numpy(got),
                          torch.from_numpy(want)) <= cc.PROBE_TOL
