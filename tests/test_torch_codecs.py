"""The port's host codecs (zignal_tpu_torch.codecs on its own native
library) against zignal_tpu.codecs: encoded bytes equal and decoded
arrays equal, on seeded arrays. Both run the same C++ (copied byte for
byte) and the same Python, so any difference is a copying error."""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zignal_tpu import codecs as jc
from zignal_tpu.native import get_lib as jax_lib

from zignal_tpu_torch import codecs as pc
from zignal_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth(shape, seed):
    """Seeded gradients plus noise: data a lossy coder has to work on."""
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * (3 + k) + xx * (5 - k)) % 256 for k in range(c)],
                    -1)
    noise = np.random.default_rng(seed).integers(-12, 13, shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def test_native_sources_are_byte_identical_to_the_jax_package():
    for name in ("codec_core.cpp", "jpeg_core.cpp"):
        ours = (REPO / "zignal_tpu_torch/csrc/host" / name).read_bytes()
        theirs = (REPO / "zignal_tpu" / "native" / name).read_bytes()
        assert hashlib.sha256(ours).digest() == hashlib.sha256(theirs).digest()


def test_native_library_is_built_in_the_port_build_dir():
    lib = native.get_lib()
    assert lib is not None, "g++ could not build the port's codec library"
    path = Path(lib._name).resolve()
    assert path.parent.parent == REPO / "zignal_tpu_torch" / "_build"
    assert REPO / "zignal_tpu" not in path.parents
    assert not list((REPO / "zignal_tpu").rglob("libzt_host*"))
    assert native.BUILD_SECONDS is not None
    assert jax_lib() is not None


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("level", [0, 6, 9])
def test_png_bytes_and_decode_match_jax(c, level):
    arr = _smooth((37, 53, c), c + level)
    data = pc.png.encode(arr, compression_level=level)
    assert data == jc.png.encode(arr, compression_level=level)
    assert np.array_equal(pc.png.load_from_bytes(data),
                          jc.png.load_from_bytes(data))
    assert np.array_equal(pc.png.load_from_bytes(data), arr)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("subsampling", ["444", "422", "420"])
def test_jpeg_bytes_and_decode_match_jax(c, quality, subsampling):
    arr = _smooth((45, 67, c), 7 * c + quality)
    data = pc.jpeg.encode(arr, quality=quality, subsampling=subsampling)
    assert data == jc.jpeg.encode(arr, quality=quality,
                                  subsampling=subsampling)
    ours = pc.jpeg.load_from_bytes(data)
    assert ours.shape == arr.shape
    assert np.array_equal(ours, jc.jpeg.load_from_bytes(data))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_bmp_bytes_and_decode_match_jax(c):
    arr = _rand((19, 23, c), 40 + c)
    data = pc.bmp.encode(arr)
    assert data == jc.bmp.encode(arr)
    assert np.array_equal(pc.bmp.load_from_bytes(data),
                          jc.bmp.load_from_bytes(data))


@pytest.mark.parametrize("name", ["x.png", "x.jpg", "x.bmp"])
def test_save_and_load_array_match_jax(tmp_path, name):
    arr = _smooth((24, 31, 4), 11)
    ours, theirs = tmp_path / ("p_" + name), tmp_path / ("j_" + name)
    pc.save_array(str(ours), arr)
    jc.save_array(str(theirs), arr)
    assert ours.read_bytes() == theirs.read_bytes()
    assert np.array_equal(pc.load_array(str(ours)),
                          jc.load_array(str(theirs)))


def _value(fmt):
    return None if fmt is None else fmt.value


def test_detect_format_matches_jax():
    for data in (pc.png.encode(_rand((4, 4, 3), 1)),
                 pc.bmp.encode(_rand((4, 4, 3), 2)),
                 pc.jpeg.encode(_rand((8, 8, 3), 3)), b"GIF89a....",
                 b"garbage"):
        assert _value(pc.detect_format(data)) == \
            _value(jc.detect_format(data))
    for path in ("a.PNG", "b.jpeg", "c.dib", "d.gif", "e.txt"):
        assert _value(pc.detect_from_path(path)) == \
            _value(jc.detect_from_path(path))


def test_malformed_jpeg_streams_raise_as_jax_does():
    base = pc.jpeg.encode(_smooth((48, 64, 3), 5), quality=85,
                          subsampling="420")
    for t in range(2, 600, 7):
        outcome = []
        for mod in (pc.jpeg, jc.jpeg):
            try:
                outcome.append(mod.decode(base[:t])[0].tobytes())
            except ValueError as e:  # JpegError subclasses ValueError
                outcome.append(type(e).__name__ + str(e))
        assert outcome[0] == outcome[1], t


def test_pure_python_fallbacks_match_without_a_toolchain():
    """With no g++ the PNG and JPEG encoders fall back to Python, as the
    JAX package's do, and full JPEG decode raises."""
    code = (
        "import os, numpy as np\n"
        "os.environ['PATH'] = ''\n"
        "from zignal_tpu_torch import native\n"
        "native._BUILD_DIR = native._BUILD_DIR / 'none-here'\n"
        "from zignal_tpu_torch.codecs import png, jpeg\n"
        "assert native.get_lib() is None\n"
        "a = np.random.default_rng(0).integers(0, 256, (9, 11, 3), np.uint8)\n"
        "assert np.array_equal(png.load_from_bytes(png.encode(a)), a)\n"
        "jpeg.encode(a)\n"
        "try:\n"
        "    jpeg.load_from_bytes(jpeg.encode(a))\n"
        "except jpeg.JpegError:\n"
        "    print('raised')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_native_library_loads_once_under_many_threads():
    """The first get_lib from many threads at once: every caller gets the
    library (the JAX package's loader hands None to callers that arrive
    while another thread loads; see ROADMAP §3)."""
    code = (
        "import sys, threading\n"
        "sys.setswitchinterval(1e-6)\n"
        "from zignal_tpu_torch import native\n"
        "n = 32\n"
        "gate = threading.Barrier(n)\n"
        "got = []\n"
        "def call():\n"
        "    gate.wait(timeout=60)\n"
        "    got.append(native.get_lib() is not None)\n"
        "threads = [threading.Thread(target=call) for _ in range(n)]\n"
        "for t in threads:\n"
        "    t.start()\n"
        "for t in threads:\n"
        "    t.join(timeout=240)\n"
        "assert not any(t.is_alive() for t in threads)\n"
        "assert got == [True] * n, got\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
