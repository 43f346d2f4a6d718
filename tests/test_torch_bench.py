"""The port's bench, ``python -m zignal_tpu_torch.bench``, on the CPU.

- Its inputs are bench.py's: ``synth_photo`` byte-equal at the shapes and
  seeds the configs use, the config names and metric strings equal, and
  every config's input shapes equal at full size (bench.py's expressions
  evaluated from its source, not run) and at ``--smoke``.
- Its workloads at smoke size equal the JAX package's on JAX-CPU: the
  north star's Oklab within 5e-6; config 2's chain, equalize and
  autocontrast and config 3's mask equal; config 1's PNG bytes equal to
  JAX's ``Image.resize`` on its device route (``ZT_PLACEMENT=device``;
  ROADMAP §3); FDM within 1 u8 step at no more than 0.1 % of the values;
  the Hough accumulator, its lines and the canvas equal. ORB is left to
  tests/test_torch_features.py: JAX's batched-ORB compile alone takes
  ~18 s on this CPU.
- The smoke run end to end in a subprocess, the default device without a
  card (exit 1, one error line, no number), and checks that catch bad
  outputs: a colour chain that copies its input (a u8 check passes it)
  and a north-star value moved past 5e-6.
- ``entry()`` runs as returned, within 5e-6 of ``__graft_entry__``'s.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
import zignal_tpu_torch as zp
from zignal_tpu_torch import bench as pbench

REPO = Path(__file__).resolve().parent.parent
OKLAB_TOL = 5e-6
FDM_SHARE = 1e-3
BENCH_PY = ast.parse((REPO / "bench.py").read_text())


# -- bench.py's geometry, evaluated from its source ---------------------------

def _func(name):
    return next(n for n in BENCH_PY.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _eval(node, env):
    return eval(compile(ast.Expression(node), "bench.py", "eval"),
                {"np": np}, dict(env))


def _env(smoke: bool) -> dict:
    env = {"_SMOKE": smoke}
    dim = next(n.value for n in BENCH_PY.body if isinstance(n, ast.Assign)
               and n.targets[0].id == "_DIM")
    env["_DIM"] = _eval(dim, env)
    return env


def _assigned(func: str, name: str, smoke: bool):
    """The first value bench.py's ``func`` assigns to ``name``."""
    node = next(n for n in ast.walk(_func(func)) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name)
    return _eval(node.value, _env(smoke))


def _call_arg(func: str, attr: str, index: int, smoke: bool,
              inside: str | None = None):
    """Argument ``index`` of the first ``*.attr(...)`` call in ``func`` (in
    the first call of the name ``inside`` when one is given)."""
    scope = _func(func)
    if inside:
        scope = next(n for n in ast.walk(scope) if isinstance(n, ast.Call)
                     and getattr(n.func, "id", None) == inside)
    node = next(n for n in ast.walk(scope) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == attr)
    return _eval(node.args[index], _env(smoke))


def _bench_py_shapes(smoke: bool) -> dict:
    dim = _env(smoke)["_DIM"]
    h, w = _assigned("bench_codec_roundtrip", "shape", smoke)
    f = _assigned("bench_features_stretch", "dim", smoke)
    k = _assigned("bench_features_stretch", "k_batch", smoke)
    n = _assigned("bench_fdm", "n", smoke)
    return {
        "north_star": [(b, dim, dim, 3) for b, _, _ in _assigned(
            "bench_north_star", "sizes", smoke)],
        "codec_roundtrip": [(h, w, 3)] * _assigned(
            "bench_codec_roundtrip", "n_stream", smoke),
        "colorspace": [_call_arg("bench_colorspace", "integers", 2, smoke)],
        "filter_fusion": [_call_arg("bench_filter_fusion", "integers", 2,
                                    smoke)],
        # the image and k - 2 seeded ones (the rotated view is derived),
        # then the canvas
        "features": [(f, f, 3)] * (k - 1) + [_call_arg(
            "bench_features_stretch", "zeros", 0, smoke, inside="Canvas")],
        "fdm": [(n, n, 3), (n, n, 3)],
    }


def test_config_names_and_metric_strings_are_bench_py_s():
    assert pbench._CONFIGS == jbench._CONFIGS
    assert pbench._METRIC_NAMES == jbench._METRIC_NAMES


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_input_shapes_are_bench_py_s(smoke):
    assert pbench.input_shapes(smoke) == _bench_py_shapes(smoke)
    assert pbench.geometry(smoke)["north_star"] == _assigned(
        "bench_north_star", "sizes", smoke)
    made = {"north_star": pbench.north_star_inputs,
            "colorspace": lambda s: [pbench.colorspace_input(s)],
            "filter_fusion": lambda s: pbench.filter_inputs(s)[:1]}
    if smoke:  # the arrays themselves, at the toy sizes
        for name, fn in made.items():
            assert [a.shape for a in fn(smoke)] == \
                pbench.input_shapes(smoke)[name], name


_PHOTOS = {  # (h, w, seeds) of each config's synth_photo calls
    "codec": lambda s: (*pbench.geometry(s)["codec_shape"],
                        range(100, 100 + pbench.geometry(s)["codec_count"])),
    "features": lambda s: (pbench.geometry(s)["features_dim"],
                           pbench.geometry(s)["features_dim"],
                           [5] + [50 + i for i in range(
                               pbench.geometry(s)["orb_batch"] - 2)]),
    "fdm": lambda s: (pbench.geometry(s)["fdm_dim"],
                      pbench.geometry(s)["fdm_dim"], (3, 4)),
}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("config", sorted(_PHOTOS))
def test_synth_photo_is_bench_py_s_byte_for_byte(config, smoke):
    h, w, seeds = _PHOTOS[config](smoke)
    for seed in seeds:
        got, want = pbench.synth_photo(h, w, seed), jbench.synth_photo(
            h, w, seed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# -- the workloads against the JAX package at smoke size ----------------------

def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def test_north_star_within_bound_of_jax():
    import jax.numpy as jnp
    from zignal_tpu.batch import resize_blur_oklab_fn
    from zignal_tpu.enums import Interpolation

    jfn = resize_blur_oklab_fn(64, 64, 2.0, Interpolation.BILINEAR)
    for arr in pbench.north_star_inputs(True):
        got = pbench.north_star_fn(128)(_t(arr)).numpy()
        want = np.asarray(jfn(jnp.asarray(arr)))
        assert got.shape == want.shape == (arr.shape[0], 64, 64, 3)
        assert float(np.abs(got - want).max()) <= OKLAB_TOL


def test_colorspace_chain_equalize_autocontrast_equal_jax():
    import jax.numpy as jnp
    from zignal_tpu.ops.enhancement import autocontrast, equalize
    from zignal_tpu.pipeline import color_chain_u8

    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import enhancement

    arr = pbench.colorspace_input(True)
    u8 = pipeline.color_chain_u8(_t(arr), pbench.SPACES)
    ju8 = color_chain_u8(jnp.asarray(arr), pbench.SPACES)
    np.testing.assert_array_equal(u8.numpy(), np.asarray(ju8))
    np.testing.assert_array_equal(enhancement.equalize(u8[0]).numpy(),
                                  np.asarray(equalize(ju8[0])))
    np.testing.assert_array_equal(enhancement.autocontrast(u8[1]).numpy(),
                                  np.asarray(autocontrast(ju8[1])))
    step = (np.asarray(equalize(ju8[0])).astype(np.float32)
            + np.asarray(autocontrast(ju8[1])).astype(np.float32))
    np.testing.assert_array_equal(pbench.colorspace_step(_t(arr)).numpy(),
                                  step)


def test_filter_fusion_equals_jax():
    import jax.numpy as jnp
    from zignal_tpu.pipeline import filter_chain

    for arr in pbench.filter_inputs(True):
        np.testing.assert_array_equal(
            pbench.filter_step(_t(arr)).numpy(),
            np.asarray(filter_chain(jnp.asarray(arr)[..., 0], 2.0, 2,
                                    128.0)))


def test_codec_roundtrip_png_bytes_equal_jax_device_route(monkeypatch):
    from zignal_tpu.codecs import jpeg, png
    from zignal_tpu.image import Image

    monkeypatch.setenv("ZT_PLACEMENT", "device")
    for jpg in pbench.codec_corpus(True):
        arr, _ = jpeg.decode(jpg)
        out = Image.from_numpy(arr).resize((arr.shape[0] // 2,
                                            arr.shape[1] // 2))
        assert pbench.codec_once(jpg, "cpu") == png.encode(out.to_numpy())


def test_fdm_within_one_step_of_jax():
    from zignal_tpu.fdm import FeatureDistributionMatching
    from zignal_tpu.image import Image

    src, tgt = pbench.fdm_inputs(True)
    fdm = FeatureDistributionMatching()
    fdm.set_target(Image.from_numpy(tgt.copy()))
    work = Image.from_numpy(src.copy())
    fdm.set_source(work)
    fdm.update()
    got = pbench.fdm_transfer(src, tgt, "cpu").to_numpy()
    d = np.abs(got.astype(np.int32) - np.asarray(work.to_numpy(), np.int32))
    assert d.max() <= 1 and (d != 0).mean() <= FDM_SHARE


def test_hough_and_canvas_equal_jax():
    from zignal_tpu.canvas import Canvas
    from zignal_tpu.image import Image
    from zignal_tpu.ops.hough import HoughTransform

    arr = pbench.synth_photo(128, 128, seed=5)
    acc, lines = pbench.hough_lines(zp.Image.from_numpy(arr, device="cpu"))
    hough = HoughTransform(256)
    jacc = hough.compute(Image.from_numpy(arr).sobel())
    jlines = hough.find_lines(jacc, threshold=120)
    np.testing.assert_array_equal(acc, np.asarray(jacc))
    assert lines and [dataclasses.astuple(x) for x in lines] == \
        [dataclasses.astuple(x) for x in jlines]

    canvas = Canvas(Image.from_numpy(np.zeros((512, 512, 3), np.uint8)))
    for i in range(50):
        canvas.draw_line((10 + i * 9, 20), (500 - i * 9, 490), (255, 128, 0))
        canvas.draw_circle((256, 256), 40 + i * 2, (0, 255, 128))
    np.testing.assert_array_equal(pbench.draw_canvas("cpu").to_numpy(),
                                  np.asarray(canvas.image.to_numpy()))


# -- the process: smoke run, no fallback, checks that catch -------------------

def _bench(args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "zignal_tpu_torch.bench", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_smoke_run_on_the_cpu_end_to_end():
    proc = _bench(["--device", "cpu", "--smoke"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()
    lines = [json.loads(x) for x in out]
    assert [x["metric"] for x in lines[:-1]] == \
        [jbench._METRIC_NAMES[n] for n in jbench._CONFIGS]
    for line in lines[:-1]:
        assert line["device"] == "cpu" and line["l2_flushed"] is False
        assert line["value"] > 0 and "check" in line
        assert set(line["launches"]) == {"K1", "K2", "K3", "K3p", "K4",
                                         "DET", "DESC"}
        # the CPU launches no kernel
        assert line["launches"]["DET"] == line["launches"]["DESC"] == 0
        assert line["k1_streamed"] == 0  # the CPU launches no kernel
    last = lines[-1]
    assert len(out[-1].encode()) < 2000 and last["summary"] is True
    assert last["device"] == "cpu"
    assert last["values"] == {n: lines[i]["value"]
                              for i, n in enumerate(jbench._CONFIGS)}


def test_the_default_device_without_a_card_exits_1_with_no_number():
    proc = _bench([], env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert len(proc.stderr.strip().splitlines()) == 1
    assert "no CUDA device" in proc.stderr


def _error_line(capsys, config, ran=()):
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    line = next(x for x in lines
                if x.get("metric") == jbench._METRIC_NAMES[config])
    assert line["value"] is None and line["unit"] == "error"
    assert lines[-1]["values"][config] is None
    assert all(v is not None for k, v in lines[-1]["values"].items()
               if k != config and k in ran)
    return line["error"]


def test_the_colour_check_catches_a_chain_that_copies_its_input(
        monkeypatch, capsys):
    from zignal_tpu_torch import pipeline
    from zignal_tpu_torch.ops import color_chain as cc

    def copy(batch, spaces, quantize=True):
        return batch.clone() if quantize else batch.to(torch.float32) / 255

    x = _t(pbench.colorspace_input(True))
    # the copy passes a u8 check: every chain K3 accepts is the identity
    assert torch.equal(copy(x, pbench.SPACES),
                       cc.fused_color_chain_u8_reference(x, pbench.SPACES))
    monkeypatch.setattr(cc, "fused_color_chain_u8", copy)
    monkeypatch.setattr(pipeline, "fused_color_chain_u8", copy)
    assert pbench.main(["--device", "cpu", "--smoke", "--only",
                        "colorspace"]) == 1
    assert "f32 values" in _error_line(capsys, "colorspace")


def test_the_north_star_check_catches_a_value_past_its_bound(
        monkeypatch, capsys):
    from zignal_tpu_torch import pipeline

    real = pipeline.fused_resize_blur_oklab

    def moved(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out.view(-1)[7] += 2 * OKLAB_TOL
        return out

    monkeypatch.setattr(pipeline, "fused_resize_blur_oklab", moved)
    assert pbench.main(["--device", "cpu", "--smoke", "--only",
                        "north_star,filter_fusion"]) == 1
    assert "Oklab max_abs_err" in _error_line(capsys, "north_star",
                                              ran=("filter_fusion",))


# -- entry() -------------------------------------------------------------------

def test_entry_runs_as_returned_within_bound_of_jax():
    import __graft_entry__
    from zignal_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs))
    assert got.shape == want.shape == (2, 128, 128, 3)
    assert float(np.abs(got.numpy() - want).max()) <= OKLAB_TOL


def test_entry_without_a_card_raises(monkeypatch):
    from zignal_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
