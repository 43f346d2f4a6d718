"""The host codecs' native (C++) hot loops, built with g++ at first use and
loaded with ctypes.

The sources are byte-for-byte copies of the JAX package's
(``csrc/host/codec_core.cpp`` and ``csrc/host/jpeg_core.cpp``, from
zignal_tpu/native/), compiled with the same command as
zignal_tpu/native/__init__.py into ``zignal_tpu_torch/_build/host-<hash>/``,
keyed by a hash of the sources and flags. ``-march=native`` targets the
machine that builds, so the library is never committed. Nothing runs at
import. As in the JAX package, every codec entry has a pure-Python
fallback when no toolchain is present, except full JPEG decode, which
then raises; ``BUILD_SECONDS`` says how long the build took (``None``
until ``get_lib`` ran, 0 when the library was already built). ctypes
releases the interpreter lock around each call, so decodes and encodes on
a thread pool overlap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["get_lib", "BUILD_SECONDS"]

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "host" / "codec_core.cpp",
            _PKG / "csrc" / "host" / "jpeg_core.cpp")
_BUILD_DIR = _PKG / "_build"
# -fno-math-errno: no errno is read from libm, and it lets the vectorizer
# turn lrintf into one vcvtps2dq per vector
_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC",
          "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
BUILD_SECONDS = None

_P = ctypes.c_char_p
_N = ctypes.c_int64
_SIGNATURES = {  # name: (restype, argtypes)
    "zt_png_unfilter": (ctypes.c_int, [_P, _P, _N, _N, _N]),
    "zt_png_filter_msd": (_N, [_P, _N, _N, _N, _P]),
    "zt_zlib_rle_compress": (_N, [_P, _N, _P, _N]),
    "zt_jpeg_entropy_encode": (_N, [_P, _N, _P, _P, _P, _P, _P, _P, _P,
                                    _N]),
    "zt_jpeg_encode_scan": (_N, [_P, _N, _N, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                                 _P, _P, _P, _N]),
    "zt_gif_lzw_decode": (_N, [_P, _N, _P, _N, ctypes.c_int]),
    "zt_gif_lzw_encode": (_N, [_P, _N, _P, _N, ctypes.c_int]),
    "zt_median_cut": (_N, [_P, _N, _N, _P]),
    "zt_clt_build": (ctypes.c_int, [_P, _N, _P]),
    "zt_sixel_emit": (_N, [_P, _N, _N, _P, _N]),
    "zt_dither_error_diffusion": (ctypes.c_int, [_P, _N, _N, _P, ctypes.c_int,
                                                 _P, ctypes.c_int]),
}


def _build() -> Path | None:
    """The library's path, built if it is missing; None when g++ fails or
    is absent."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    out_dir = _BUILD_DIR / f"host-{digest.hexdigest()[:16]}"
    lib = out_dir / "libzt_host.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libzt_host.{os.getpid()}.so"
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def get_lib():
    """The loaded native library, or None when it cannot be built. Safe to
    call from many threads at once: ``_tried`` is set only once the attempt
    has ended, so no caller sees a library that is still loading as
    missing."""
    global _lib, _tried, BUILD_SECONDS
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            t0 = time.perf_counter()
            path = _build()
            BUILD_SECONDS = time.perf_counter() - t0
            lib = None if path is None else ctypes.CDLL(str(path))
        except OSError:
            lib = None
        if lib is not None:
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
        _lib = lib
        _tried = True
    return _lib
