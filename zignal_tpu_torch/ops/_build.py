"""Build the package's CUDA kernels with nvcc at first use and load them
with ctypes.

The sources under ``csrc/`` are compiled for ``sm_90a`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds): one nvcc per source, all started together, then one link. The
library goes to ``zignal_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so an edited source builds anew. Nothing here runs at
import: ``load()`` is called by the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from torch.autograd import profiler as _autograd_profiler

from ..profiling import RECORDER

__all__ = ["load", "launch", "sm_count", "TILES", "SMEM_LIMIT",
           "COUNT_LOCK"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(_PKG / "csrc" / name for name in (
    "fused_resize_blur_oklab.cu", "fused_blur_sharpen_morph.cu",
    "separable_u8.cu", "fused_color_chain_u8.cu", "equalize_u8.cu"))
_HEADERS = (_PKG / "csrc" / "tile_staging.cuh",)
_BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the Oklab epilogue and the colour chain need IEEE
# powf/cbrtf
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

TILES = (32, 16, 8)     # output tile sides of K4's band kernel
SMEM_LIMIT = 232448     # bytes of shared memory a block may use on sm_90

_LIB = None
# held around every wrapper's ``LAUNCHES += n``: threads launch at once
# (the loader's decode threads letterbox through K1), and an unguarded +=
# after a ctypes call loses counts
COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def _compile() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        digest.update(src.read_bytes())
    out_dir = _BUILD_DIR / digest.hexdigest()[:16]
    lib = out_dir / "libzt_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_SOURCES, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        list(pool.map(_run, cmds))  # raises the first failure
    tmp = out_dir / f"libzt_kernels.{pid}.so"
    _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _declare(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = _I


def load():
    """The kernels' library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_compile()))
        _declare(lib, "zt_fused_resize_blur_oklab",
                 [_P, _P, _P, _P, _P, _P, _P,      # src dst ty tx sy sx lut
                  _P, _P])                         # params stream
        _declare(lib, "zt_resize_params_bytes", [])
        _declare(lib, "zt_fused_blur_sharpen_morph",
                 [_P, _P, _P, _P, _P, _P])         # src dst ty tx params
                                                   # stream
        _declare(lib, "zt_filter_params_bytes", [])
        _declare(lib, "zt_separable_conv_u8",
                 [_P, _P, _P, _P, _P, _P])         # src dst ty tx params
                                                   # stream
        _declare(lib, "zt_separable_u8",
                 [_P, _P, _P, _P, _P, _P, _P, _P,  # src dst ysrc yidx yw
                  _P, _P])                         # xsrc xidx xw params
                                                   # stream
        _declare(lib, "zt_conv_params_bytes", [])
        _declare(lib, "zt_band_params_bytes", [])
        _declare(lib, "zt_fused_color_chain_u8",
                 [_P, _P, _P, _P, _L, _I, _I, _P])  # src dst lut params n
                                                    # quantize vec stream
        _declare(lib, "zt_transcendentals_probe",
                 [_P, _P, _P, _L, _P])             # x y params n stream
        _declare(lib, "zt_color_chain_params_bytes", [])
        _declare(lib, "zt_histogram256_u8",
                 [_P, _P, _L, _L, _I, _P])         # src counts b n c stream
        _declare(lib, "zt_equalize_tables",
                 [_P, _I, _P, _L, _I, _L, _I, _P])  # hists wide luts b c
                                                    # total skip_alpha stream
        _declare(lib, "zt_lut_apply_u8",
                 [_P, _P, _P, _L, _L, _I, _P])     # src dst luts b n c
                                                   # stream
        lib.zt_error_string.argtypes = [_I]
        lib.zt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def sm_count(device) -> int:
    """SMs of the card that holds ``device``; 132, an H100 SXM's, for a
    CPU device, where the tile plans are only inspected."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(name: str, device, *args) -> None:
    """Call the library's entry ``name`` with ``args`` and the current
    stream of ``device``; raise if the launch was refused. The device is
    switched only when it is not the current one (a switch costs more
    host time than the launch). During a profiler session the call is
    the recorder's span ``launch``, a switch included."""
    import torch

    t0 = time.perf_counter_ns() if _autograd_profiler._is_profiler_enabled \
        else 0
    lib = _LIB or load()
    index = device.index
    current = torch.cuda.current_device()
    if index is not None and index != current:
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    else:
        stream = torch.cuda.current_stream(current).cuda_stream
        err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if t0:
        RECORDER.add("launch", t0)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.zt_error_string(err).decode()}")
