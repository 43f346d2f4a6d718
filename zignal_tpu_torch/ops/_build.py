"""Build the package's CUDA kernels with nvcc at first use and load them
with ctypes.

The sources under ``csrc/`` are compiled for ``sm_90a`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library goes to ``zignal_tpu_torch/_build/<hash>/``, keyed
by a hash of the sources and flags, so an edited source builds anew.
Nothing here runs at import: ``load()`` is called by the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["load"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "fused_resize_blur_oklab.cu",)
_BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the Oklab epilogue needs IEEE powf/cbrtf
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    out_dir = _BUILD_DIR / digest.hexdigest()[:16]
    lib = out_dir / "libzt_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libzt_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def load():
    """The kernels' library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_compile()))
        fn = lib.zt_fused_resize_blur_oklab
        fn.argtypes = [_P, _P, _P, _P, _P, _P,            # src dst ty tx taps mix
                       _I, _I, _I, _I, _I, _I,            # B H W C OH OW
                       _I, _I, _I, _I, _P]                # r tile smem oklab stream
        fn.restype = _I
        lib.zt_error_string.argtypes = [_I]
        lib.zt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
