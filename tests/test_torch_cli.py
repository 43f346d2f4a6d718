"""The port's CLI (zignal_tpu_torch/cli/) against zignal_tpu's on JAX-CPU:
every subcommand through both ``main``s, the port's with ``--device cpu``,
on the same seeded input files.

Bounds:
- output files byte-equal: ``resize`` (all six filters), ``blur`` (all
  nine types), ``edges`` (three filters), ``pipeline`` (.zon and .json),
  ``tile`` (five modes), ``diff`` (``--binary``, ``--threshold``) and
  ``qr encode -o``;
- stdout equal: ``info --stats`` (PNG, JPEG, BMP, GIF), ``diff``, ``qr``
  encode to the terminal and ``decode``, ``display`` (SGR, braille), and
  ``version`` up to the package's name;
- ``metrics``: each printed number within 1e-5 relative, the metrics'
  bound (tests/test_torch_metrics.py);
- ``fdm``: at most 1 u8 step at no more than 0.1 % of values, the bound
  of tests/test_torch_fdm_pca.py (the JAX package's covariance drifts);
- exit codes equal on the error paths.
The port's default ``--device`` is ``cuda``: without a card it fails
with exit code 1 and writes nothing.

The JAX CLI runs with ``ZT_PLACEMENT=device``. Its auto placement resizes
a small host image on the host (``zignal_tpu/placement.py``, not ported),
and that bilinear route is not bit-identical to its device route
(36x52 -> 14x20: 5 values one step off); the port's resize is the device
route's arithmetic (ROADMAP §3, JAX-side faults).
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu.cli.main import main as jax_main

import zignal_tpu_torch as zp
from zignal_tpu_torch.cli.main import main as port_main

REPO = Path(__file__).resolve().parent.parent
REL = 1e-5          # the metrics' bound
FDM_SHARE = 1e-3    # of u8 values, at most 1 step off
FILTERS = ("nearest", "bilinear", "bicubic", "catmull_rom", "mitchell",
           "lanczos")
BLURS = ("gaussian", "box", "median", "min", "max", "midpoint", "linear",
         "zoom", "spin")
ZON = """
.{
    .steps = .{
        .{ .resize = .{ .scale = 0.5 } },
        .{ .blur = .{ .type = .gaussian, .sigma = 1.0 } },
        .{ .edges = .{ .filter = .sobel } },
    },
}
"""
JSON = ('{"steps": [{"resize": {"width": 40, "height": 20, "filter": '
        '"bicubic"}}, {"blur": {"type": "box", "radius": 2}}, '
        '{"edges": {"filter": "canny", "sigma": 1.2}}]}')


def synth_photo(h, w, seed=0):
    """bench.py's synth_photo: smooth structure and grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([
        128 + 90 * np.sin(xx / 9.7) * np.cos(yy / 5.3),
        128 + 80 * np.cos(xx / 6.1 + yy / 4.1),
        128 + 70 * np.sin((xx + yy) / 15.1),
    ], axis=-1)
    noise = rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.fixture(autouse=True)
def jax_device_placement(monkeypatch):
    monkeypatch.setenv("ZT_PLACEMENT", "device")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs, written once by the port's codecs: RGB PNGs of 36x52
    (a source, its blurred copy, a second photo, a warm target), a gray
    PNG, and the source as JPEG, BMP and GIF."""
    d = tmp_path_factory.mktemp("cli_inputs")
    src = synth_photo(36, 52, seed=1)
    arrays = {
        "src.png": src,
        "other.png": synth_photo(36, 52, seed=2),
        "target.png": np.clip(synth_photo(36, 52, seed=4).astype(np.int32)
                              * [9, 7, 5] // 8 + [20, 10, 0], 0, 255)
        .astype(np.uint8),
        "gray.png": synth_photo(36, 52, seed=5)[..., :1],
        "src.jpg": src, "src.bmp": src, "src.gif": src,
    }
    paths = {}
    for name, arr in arrays.items():
        paths[name] = str(d / name)
        zp.Image.from_numpy(np.ascontiguousarray(arr), device="cpu") \
            .save(paths[name])
    paths["blurred.png"] = str(d / "blurred.png")
    zp.Image.from_numpy(src.copy(), device="cpu").gaussian_blur(1.5) \
        .save(paths["blurred.png"])
    return paths


def _both(capsys, tmp_path, argv, out=None):
    """Run ``argv`` through the JAX CLI and the port's (``--device cpu``);
    ``{out}`` in it names a file (or, ending in a separator, a directory)
    of each side's own. Returns [(rc, stdout, out path)] for JAX, port."""
    results = []
    for tag, run in (("jax", jax_main),
                     ("port", lambda a: port_main(["--device", "cpu", *a]))):
        target = None
        if out is not None:
            (tmp_path / tag).mkdir(exist_ok=True)
            target = str(tmp_path / tag / out)
            if out.endswith("/"):
                target = str(tmp_path / tag / out.rstrip("/")) + "/"
        rc = run([target if a == "{out}" else a for a in argv])
        results.append((rc, capsys.readouterr().out, target))
    return results


def _same_file(capsys, tmp_path, argv, out="out.png"):
    (rc_j, text_j, out_j), (rc_p, text_p, out_p) = _both(capsys, tmp_path,
                                                         argv, out)
    assert rc_j == rc_p == 0
    want = Path(out_j).read_bytes()
    assert Path(out_p).read_bytes() == want
    return text_j, text_p


# -- output files byte-equal -------------------------------------------------

@pytest.mark.parametrize("size", [("--scale", "0.5"), ("--width", "70")],
                         ids=["scale-0.5", "width-70"])
@pytest.mark.parametrize("flt", FILTERS)
def test_resize_files_equal_jax(files, capsys, tmp_path, flt, size):
    _same_file(capsys, tmp_path, ["resize", files["src.png"], *size,
                                  "--filter", flt, "-o", "{out}"])


def test_resize_of_a_jpeg_into_a_directory_equals_jax(files, capsys,
                                                      tmp_path):
    (rc_j, _, d_j), (rc_p, _, d_p) = _both(
        capsys, tmp_path, ["resize", files["src.jpg"], files["gray.png"],
                           "--height", "24", "-o", "{out}"], out="dir/")
    assert rc_j == rc_p == 0
    for name in ("src_resized.jpg", "gray_resized.png"):
        assert (Path(d_p) / name).read_bytes() == \
            (Path(d_j) / name).read_bytes()


@pytest.mark.parametrize("kind", BLURS)
def test_blur_files_equal_jax(files, capsys, tmp_path, kind):
    _same_file(capsys, tmp_path, ["blur", files["src.png"], "--type", kind,
                                  "-o", "{out}"])


def test_blur_with_options_equals_jax(files, capsys, tmp_path):
    _same_file(capsys, tmp_path, ["blur", files["src.png"], "--type",
                                  "linear", "--angle", "30", "--distance",
                                  "7", "-o", "{out}"])
    _same_file(capsys, tmp_path, ["blur", files["gray.png"], "--sigma", "2",
                                  "-o", "{out}"], out="gray.png")


@pytest.mark.parametrize("flt", ["sobel", "canny", "shen_castan"])
def test_edges_files_equal_jax(files, capsys, tmp_path, flt):
    _same_file(capsys, tmp_path, ["edges", files["src.png"], "--filter", flt,
                                  "-o", "{out}"])


@pytest.mark.parametrize("ext,text", [(".zon", ZON), (".json", JSON)])
def test_pipeline_files_equal_jax(files, capsys, tmp_path, ext, text):
    recipe = tmp_path / f"recipe{ext}"
    recipe.write_text(text)
    _same_file(capsys, tmp_path, ["pipeline", str(recipe), files["src.png"],
                                  "-o", "{out}"])


def test_pipeline_batch_into_a_directory_equals_jax(files, capsys,
                                                    tmp_path):
    recipe = tmp_path / "recipe.zon"
    recipe.write_text(ZON)
    (rc_j, _, d_j), (rc_p, _, d_p) = _both(
        capsys, tmp_path, ["pipeline", str(recipe), files["src.png"],
                           files["other.png"], "-o", "{out}"], out="dir/")
    assert rc_j == rc_p == 0
    for name in ("src_processed.png", "other_processed.png"):
        assert (Path(d_p) / name).read_bytes() == \
            (Path(d_j) / name).read_bytes()


@pytest.mark.parametrize("mode", ["square", "horizontal", "vertical", "grid",
                                  "factors"])
def test_tile_files_equal_jax(files, capsys, tmp_path, mode):
    inputs = [files[k] for k in ("src.png", "other.png", "target.png",
                                 "blurred.png")]
    _same_file(capsys, tmp_path, ["tile", *inputs, "--mode", mode, "-o",
                                  "{out}"])


def test_tile_with_forced_cells_equals_jax(files, capsys, tmp_path):
    inputs = [files[k] for k in ("src.png", "other.png", "target.png")]
    _same_file(capsys, tmp_path, ["tile", *inputs, "--cols", "2", "--width",
                                  "30", "--height", "20", "-o", "{out}"])


@pytest.mark.parametrize("opts", [["--binary"], ["--threshold", "10"]],
                         ids=["binary", "threshold"])
def test_diff_file_and_stdout_equal_jax(files, capsys, tmp_path, opts):
    text_j, text_p = _same_file(capsys, tmp_path, [
        "diff", files["src.png"], files["blurred.png"], *opts, "-o",
        "{out}"])
    assert text_p == text_j and "max diff" in text_j


def test_qr_encode_file_equals_jax(capsys, tmp_path):
    text_j, text_p = _same_file(capsys, tmp_path, [
        "qr", "encode", "CLI ROUNDTRIP", "--ec-level", "q",
        "--module-size", "3", "-o", "{out}"], out="qr.png")
    assert text_p.replace("/port/", "/jax/") == text_j


# -- stdout equal ------------------------------------------------------------

@pytest.mark.parametrize("name", ["src.png", "src.jpg", "src.bmp",
                                  "src.gif"])
def test_info_stats_stdout_equals_jax(files, capsys, tmp_path, name):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(
        capsys, tmp_path, ["info", files[name], "--stats"])
    assert rc_j == rc_p == 0
    assert text_p == text_j and "mean=" in text_j


def test_diff_stdout_equals_jax(files, capsys, tmp_path):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(
        capsys, tmp_path, ["diff", files["src.png"], files["other.png"],
                           "--protocol", "sgr"])
    assert rc_j == rc_p == 0
    assert text_p == text_j and "differing pixels" in text_j


def test_qr_encode_to_the_terminal_and_decode_equal_jax(capsys, tmp_path):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(
        capsys, tmp_path, ["qr", "encode", "HELLO TERMINAL"])
    assert rc_j == rc_p == 0
    assert text_p == text_j and "█" in text_j
    code = str(tmp_path / "code.png")
    assert port_main(["--device", "cpu", "qr", "encode", "zignal torch",
                      "-o", code]) == 0
    capsys.readouterr()
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(capsys, tmp_path,
                                                 ["qr", "decode", code])
    assert rc_j == rc_p == 0
    assert text_p == text_j and "'zignal torch'" in text_j


@pytest.mark.parametrize("protocol,size", [
    ("sgr", []), ("sgr", ["--width", "20"]), ("braille", []),
    ("braille", ["--height", "16"])])
def test_display_stdout_equals_jax(files, capsys, tmp_path, protocol, size):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(
        capsys, tmp_path, ["display", files["src.png"], files["gray.png"],
                           "--protocol", protocol, *size])
    assert rc_j == rc_p == 0
    assert text_p == text_j and files["gray.png"] in text_j


def test_version_equals_jax_up_to_the_package_name(capsys, tmp_path):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(capsys, tmp_path,
                                                 ["version"])
    assert rc_j == rc_p == 0
    assert text_p == f"zignal {zp.__version__} (zignal_tpu_torch)\n"
    assert text_p.replace("zignal_tpu_torch", "zignal-tpu") == text_j


# -- metrics and fdm within their bounds -------------------------------------

def _numbers(text):
    return {k: float(v) for k, v in
            re.findall(r"^(\w+): (-?[\d.]+|inf)", text, re.MULTILINE)}


def test_metrics_within_bound_of_jax(files, capsys, tmp_path):
    (rc_j, text_j, _), (rc_p, text_p, _) = _both(
        capsys, tmp_path, ["metrics", files["src.png"], files["blurred.png"]])
    assert rc_j == rc_p == 0
    want, got = _numbers(text_j), _numbers(text_p)
    assert sorted(got) == sorted(want) == ["mean_pixel_error", "psnr",
                                           "ssim"]
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=REL), key


def test_fdm_within_bound_of_jax(files, capsys, tmp_path):
    (rc_j, _, out_j), (rc_p, _, out_p) = _both(
        capsys, tmp_path, ["fdm", files["src.png"], files["target.png"],
                           "{out}"], out="fdm.png")
    assert rc_j == rc_p == 0
    want = jz.Image.load(out_j).to_numpy().astype(np.int32)
    got = zp.Image.load(out_p, device="cpu").to_numpy().astype(np.int32)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d != 0).mean() <= FDM_SHARE


def test_resize_follows_jax_device_route_not_its_host_placement(files):
    from zignal_tpu.ops.interpolation import resize as jax_resize

    src = zp.Image.load(files["src.png"], device="cpu")
    want = np.asarray(jax_resize(src.to_numpy(), 14, 20,
                                 jz.Interpolation.BILINEAR))
    assert np.array_equal(src.resize((14, 20)).to_numpy(), want)


# -- error paths, the device and the module entry ----------------------------

def test_batch_incomplete_exit_code_equals_jax(files, capsys, tmp_path):
    (rc_j, _, d_j), (rc_p, _, d_p) = _both(
        capsys, tmp_path, ["resize", files["src.png"],
                           str(tmp_path / "missing.png"), "--scale", "0.5",
                           "-o", "{out}"], out="dir/")
    assert rc_j == rc_p == 1
    assert (Path(d_p) / "src_resized.png").read_bytes() == \
        (Path(d_j) / "src_resized.png").read_bytes()


@pytest.mark.parametrize("argv", [["info", "{missing}"],
                                  ["qr", "decode", "{missing}"],
                                  ["metrics", "{missing}", "{missing}"]])
def test_unknown_input_exit_code_equals_jax(capsys, tmp_path, argv):
    missing = str(tmp_path / "nope.png")
    (rc_j, _, _), (rc_p, _, _) = _both(
        capsys, tmp_path, [missing if a == "{missing}" else a for a in argv])
    assert rc_j == rc_p == 1


def test_default_device_without_a_card_fails_and_writes_nothing(
        files, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.png"
    assert port_main(["resize", files["src.png"], "--scale", "0.5", "-o",
                      str(out)]) == 1
    assert port_main(["qr", "encode", "text", "-o", str(out)]) == 1
    assert not out.exists()
    errors = [r.getMessage() for r in caplog.records
              if r.levelname == "ERROR"]
    assert errors == ["--device cuda: no CUDA device is available (pass "
                      "--device cpu to run on the CPU)"] * 2


def test_cli_runs_on_the_device_it_names(files, tmp_path, monkeypatch):
    seen = []
    load = zp.Image.load.__func__

    def spy(cls, path, *, device):
        img = load(cls, path, device=device)
        seen.append(img.device)
        return img

    monkeypatch.setattr(zp.Image, "load", classmethod(spy))
    assert port_main(["--device", "cpu", "blur", files["src.png"], "-o",
                      str(tmp_path / "b.png")]) == 0
    assert seen == [torch.device("cpu")]


def test_module_entry_runs_and_importing_it_runs_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "zignal_tpu_torch.cli", "--device", "cpu",
         "version"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == f"zignal {zp.__version__} (zignal_tpu_torch)\n"
    proc = subprocess.run(
        [sys.executable, "-c", "import zignal_tpu_torch.cli.__main__"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout == "", proc.stderr
