"""Build the package's CUDA kernels with nvcc at first use, load them with
ctypes, and launch them: the protocol every kernel wrapper follows.

The sources under ``csrc/`` are compiled for ``sm_90a`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds): one nvcc per source, all started together, then one link. The
library goes to ``zignal_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so an edited source builds anew. Nothing here runs at
import: ``load()`` is called by the first launch.

A wrapper checks its input, then plans, allocates, packs its parameter
struct and launches. What it plans is built once a key and kept
(``cached``); a tile is the first of the wrapper's candidates that fits
and fills the card (``choose_tile``); a plan packs its struct
(``Plan.buffer``: ``pack``, checked by ``check_layout`` against the
library's own size); ``launch`` calls the kernel on the current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..profiling import RECORDER, span_start

__all__ = ["load", "launch", "sm_count", "cached", "pack", "check_layout",
           "Plan", "choose_tile", "a16", "TILES", "SMEM_LIMIT",
           "MIN_BLOCKS_PER_SM", "ROWS", "COUNT_LOCK"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(_PKG / "csrc" / name for name in (
    "fused_resize_blur_oklab.cu", "fused_blur_sharpen_morph.cu",
    "separable_u8.cu", "fused_color_chain_u8.cu", "equalize_u8.cu",
    "orb_detect.cu", "hysteresis.cu", "canny_front.cu", "hough.cu",
    "orb_describe.cu"))
_HEADERS = (_PKG / "csrc" / "tile_staging.cuh",)
_BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the Oklab epilogue and the colour chain need IEEE
# powf/cbrtf
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

TILES = (32, 16, 8)     # output tile sides of K4's band kernel
SMEM_LIMIT = 232448     # bytes of shared memory a block may use on sm_90
# a grid of fewer blocks than this many an SM takes the next tile
MIN_BLOCKS_PER_SM = 4
ROWS = 8  # rows a thread of a tile kernel's height pass computes

_LIB = None
# held around every wrapper's ``LAUNCHES += n``: threads launch at once
# (the loader's decode threads letterbox through K1), and an unguarded +=
# after a ctypes call loses counts
COUNT_LOCK = threading.Lock()
# held around a build: threads that launch their first kernels at once
# (the loader's decode threads) would each compile into the same objects
_BUILD_LOCK = threading.Lock()

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
        with _BUILD_LOCK:
            path = _compile()
        lib = ctypes.CDLL(str(path))
        _declare(lib, "zt_fused_resize_blur_oklab",
                 [_P, _P, _P, _P, _P, _P, _P,      # src dst ty tx sy sx lut
                  _P, _P])                         # params stream
        _declare(lib, "zt_resize_params_bytes", [])
        _declare(lib, "zt_streamed_resize_blur_oklab",
                 [_P, _P, _P, _P, _P, _P, _P,      # src dst ty tx by bx lut
                  _P, _P])                         # params stream
        _declare(lib, "zt_resize_stream_params_bytes", [])
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
        _declare(lib, "zt_orb_detect",
                 [_P, _P, _I, _P, _P])             # src dst harris params
                                                   # stream
        _declare(lib, "zt_orb_detect_params_bytes", [])
        _declare(lib, "zt_orb_describe",
                 [_P, _P, _P, _P, _P, _P, _P,      # src resp idx table rows
                  _P, _P])                         # desc valid params stream
        _declare(lib, "zt_orb_describe_params_bytes", [])
        _declare(lib, "zt_hysteresis",
                 [_P, _P, _P, _P, _P, _I, _I, _I,  # cand mag out labels
                  ctypes.c_float, ctypes.c_float,  # flags b h w low high
                  _I, _P])                         # blocks stream
        _declare(lib, "zt_canny_front",
                 [_P, _P, _P, _P, _P])             # src mag mask params
                                                   # stream
        _declare(lib, "zt_canny_front_params_bytes", [])
        _declare(lib, "zt_hough_vote",
                 [_P, _P, _P, _P, _P, _P, _P, _P,  # edges rows cols cos sin
                  _P, _P])                         # list count acc params
                                                   # stream
        _declare(lib, "zt_hough_lines",
                 [_P, _P, _P, _P, _P, _P, _P])     # acc cand counts rows
                                                   # valid params stream
        _declare(lib, "zt_hough_params_bytes", [])
        lib.zt_error_string.argtypes = [_I]
        lib.zt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def a16(n: int) -> int:
    """``n`` rounded up to a multiple of 16 (bytes)."""
    return (n + 15) & ~15


# what the wrappers planned: key -> plan (a tile, tables, a packed struct)
PLANS: dict = {}


def cached(*key, span=None, build=None):
    """The plan ``key`` names, built on its first call and kept:
    ``key[0](*key[1:])``, or ``build()`` where the key names by a digest
    or a tag what the build takes. During a profiler session a build is
    the recorder's span ``span`` when one is given."""
    plan = PLANS.get(key)
    if plan is None:
        t0 = span_start() if span else 0
        plan = PLANS[key] = build() if build else key[0](*key[1:])
        if t0:
            RECORDER.add(span, t0)
    return plan


def pack(fields, values, tail=()):
    """A parameter struct as a host buffer the launch copies by value:
    the int32 ``values`` of ``fields`` in order, then the arrays of
    ``tail`` (int32 or f32)."""
    raw = np.array([values[f] for f in fields], np.int32).tobytes()
    raw += b"".join(np.ascontiguousarray(t).tobytes() for t in tail)
    return ctypes.create_string_buffer(raw, len(raw))


def check_layout(name: str, buf):
    """``buf``, once the library's ``name()`` (the size of the struct it
    packs) has been found equal to its length."""
    if getattr(load(), name)() != len(buf.raw):
        raise RuntimeError(f"the kernel's parameter layout ({name}) differs "
                           "from the wrapper's")
    return buf


class Plan:
    """A kernel's plan for one shape: the int32 ``fields`` of its
    parameter struct, named in the order of ``FIELDS``, and the arrays of
    ``tail`` after them; ``LAYOUT`` names the library's size of the
    struct. ``buffer(*variant)`` is the struct of one launch, packed and
    checked at its first use; a plan keeps 64 variants (a sweep over
    thresholds starts them anew)."""

    __slots__ = ("fields", "tail", "params")
    FIELDS: tuple = ()
    LAYOUT = ""

    def __init__(self, fields: dict, tail: tuple):
        self.fields, self.tail, self.params = fields, tail, {}

    def pack(self, vec_in):
        """The struct of a launch whose input rows are (or not) read in
        16-byte vectors."""
        return pack(self.FIELDS, dict(self.fields, vec_in=int(vec_in)),
                    self.tail)

    def buffer(self, *variant):
        buf = self.params.get(variant)
        if buf is None:
            if len(self.params) >= 64:
                self.params.clear()
            buf = self.params[variant] = check_layout(self.LAYOUT,
                                                      self.pack(*variant))
        return buf


def choose_tile(tiles, make, b: int, h: int, w: int, sms: int, need: str):
    """The tile of ``b`` outputs of ``h x w`` on a card of ``sms`` SMs:
    of the plans ``make(tile)`` of ``tiles``, in order of preference (None
    where a tile does not fit), the first that fits a block's shared
    memory and gives the grid at least ``MIN_BLOCKS_PER_SM`` blocks an SM,
    else the fitting one with the most blocks. Raises where none fits,
    with ``need`` (what needs the memory) in the message."""
    best = None
    for tile in tiles:
        plan = make(tile)
        if plan is None or plan.smem > SMEM_LIMIT:
            continue
        plan.blocks = b * -(-h // plan.th) * -(-w // plan.tw)
        if plan.blocks >= MIN_BLOCKS_PER_SM * sms:
            return plan
        if best is None or plan.blocks > best.blocks:
            best = plan
    if best is None:
        raise ValueError(f"{need} more shared memory than a block has")
    return best


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

    t0 = span_start()
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
