"""The fused u8 colour chain (BASELINE config 2) as one CUDA kernel, and its
transcendental probe: the counterpart of zignal_tpu/ops/pallas_color.py.

``fused_color_chain_u8`` takes ``[B, H, W, 3]`` u8, divides by 255, runs
``color.convert_chain`` over a chain that ``chain_supported`` accepts and
quantizes with ``clip(round(f * 255))``. On a CUDA tensor that is
``csrc/fused_color_chain_u8.cu``; on a CPU tensor it is
``fused_color_chain_u8_reference``, the plain ``convert_chain``. The host
turns the chain into a short list of step codes (``compile_chain``) that
the kernel's threads all run in turn.

Every chain the kernel accepts is the identity on u8 (the f32 values lie
within 0.14/255 of the input bytes), so a u8 comparison alone would pass a
kernel that copied its input: ``quantize=False`` returns the f32 values
before the quantization, and the tests and ``chip_smoke.py`` hold those
to the plain version too. The kernel reads the chain's first step, the
input gamma, from a table the wrapper computes with the plain version's
own ops (``gamma_table``), and takes its cube roots with the card's
``cbrtf`` where the plain version takes ``sign(x) * |x|^(1/3)``: its f32
values are within 1e-4 of the plain version's (``CHAIN_UNIT`` in the
tests), its u8 outputs equal.

``transcendentals_probe`` is K3p: the probe expression of the TPU's
``mosaic_transcendentals_ok`` through the same device helpers as K3. The
first K3 launch on a device runs it once and raises on a mismatch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..color import _array as A
from ..color._chain import _CYL_OF, _LINEAR_SPACES, convert_chain
from ..color._path import conversion_path
from ._build import COUNT_LOCK, launch, load

__all__ = ["chain_supported", "compile_chain", "fused_color_chain_u8",
           "fused_color_chain_u8_reference", "gamma_table",
           "transcendentals_probe", "transcendentals_probe_reference",
           "PROBE_TOL"]

# kernel launches since import, read as color_chain.LAUNCHES and
# color_chain.PROBE_LAUNCHES: a run shows with them that the main path
# went through the kernels
LAUNCHES = 0
PROBE_LAUNCHES = 0

# K3p's bound against its plain version: max relative error
PROBE_TOL = 1e-6

# the step codes, in the order of `enum Step` in the kernel's source
STEPS = (
    "GAMMA_TO_LINEAR", "LINEAR_TO_GAMMA",
    "LIN_TO_XYZ", "LIN_TO_LAB", "LIN_TO_OKLAB", "LIN_TO_XYB",
    "XYZ_TO_LIN", "LAB_TO_LIN", "OKLAB_TO_LIN", "XYB_TO_LIN",
    "SHADOW",
    "XYZ_TO_LAB", "LAB_TO_XYZ", "XYZ_TO_OKLAB", "OKLAB_TO_XYZ",
    "XYZ_TO_XYB", "XYB_TO_XYZ",
)
_CODE = {name: i for i, name in enumerate(STEPS)}
MAX_STEPS = 64

# the kernel's constants, in the order of `enum Matrix` and `enum Scalar`;
# each matrix is (in, out), as color/_array.py keeps it for _mix3
MATRICES = ("RGB2XYZ", "XYZ2RGB", "RGB2OKLMS", "OKLMS2LAB", "OKLAB2LMS",
            "OKLMS2RGB", "LINRGB2XYBMIX", "XYBMIX2LINRGB", "XYZ2OKLMS",
            "OKLMS2XYZ")
# INV_x is the reciprocal 1 / x rounded to f32: PyTorch divides a CUDA
# tensor by a Python scalar as a multiplication by it (measured on the
# H100: x / 1.055 equals x * f32(1 / 1.055) at each of 4M values, while
# f32(1) / f32(1.055) is an ulp away), and so does the kernel
SCALARS = ("SRGB_GAMMA_THRESHOLD", "SRGB_GAMMA_OFFSET", "SRGB_GAMMA_SCALE",
           "INV_SRGB_GAMMA_SCALE", "SRGB_LINEAR_SLOPE",
           "INV_SRGB_LINEAR_SLOPE", "SRGB_GAMMA_EXPONENT",
           "SRGB_INV_GAMMA_EXPONENT", "SRGB_LINEAR_THRESHOLD",
           "D65_X", "D65_Y", "D65_Z", "INV_D65_X", "INV_D65_Y", "INV_D65_Z",
           "LAB_EPSILON", "LAB_KAPPA_DIV_116", "INV_LAB_KAPPA_DIV_116",
           "LAB_DELTA", "XYB_BIAS", "XYB_CBRT_BIAS_ENCODE",
           "XYB_CBRT_BIAS_DECODE", "ONE_THIRD", "INV_255", "INV_100",
           "INV_116", "INV_500", "INV_200")

_TO_LIN = {"xyz": "XYZ_TO_LIN", "lab": "LAB_TO_LIN",
           "oklab": "OKLAB_TO_LIN", "xyb": "XYB_TO_LIN"}
_FROM_LIN = {"xyz": "LIN_TO_XYZ", "lab": "LIN_TO_LAB",
             "oklab": "LIN_TO_OKLAB", "xyb": "LIN_TO_XYB"}
# the stock edges a supported chain can take between two linear spaces
_EDGE = {("xyz", "lab"): "XYZ_TO_LAB", ("lab", "xyz"): "LAB_TO_XYZ",
         ("xyz", "oklab"): "XYZ_TO_OKLAB", ("oklab", "xyz"): "OKLAB_TO_XYZ",
         ("xyz", "xyb"): "XYZ_TO_XYB", ("xyb", "xyz"): "XYB_TO_XYZ"}


def chain_supported(spaces) -> bool:
    """True when the kernel runs the chain: it starts and ends on rgb,
    every space is rgb or in the linear family, and each cylindrical space
    is entered from rgb or its cartesian parent and left at once to one
    of them (so no atan2/sin/cos is needed). Op for op the gate
    ``_chain_supported`` of zignal_tpu/ops/pallas_color.py."""
    spaces = tuple(spaces)
    if len(spaces) < 2 or spaces[0] != "rgb" or spaces[-1] != "rgb":
        return False
    for s in spaces:
        if s != "rgb" and s not in _LINEAR_SPACES:
            return False
    for i, s in enumerate(spaces):
        if s in _CYL_OF:
            prev = spaces[i - 1]
            nxt = spaces[i + 1] if i + 1 < len(spaces) else None
            if prev not in ("rgb", _CYL_OF[s]):
                return False
            if nxt not in ("rgb", _CYL_OF[s]) or nxt is None:
                return False
    return True


_COMPILED: dict = {}


def compile_chain(spaces) -> tuple:
    """The kernel's step codes for a supported chain: the state machine of
    ``convert_chain`` walked on the host. An rgb state is either gamma
    (the input) or linear (after a hop back from a linear space); a
    cylindrical space holds its cartesian shadow. Cached per chain."""
    spaces = tuple(spaces)
    codes = _COMPILED.get(spaces)
    if codes is not None:
        return codes
    if not chain_supported(spaces):
        raise ValueError(f"the colour-chain kernel does not run {spaces}")
    steps = []
    space, linear = "rgb", False
    for dst in spaces[1:]:
        src = space
        if src == dst:
            continue
        if _CYL_OF.get(dst) == src:             # lab->lch / oklab->oklch
            steps.append("SHADOW")
        elif _CYL_OF.get(src) == dst:           # back out of the shadow
            pass
        elif src == "rgb":
            if not linear:
                steps.append("GAMMA_TO_LINEAR")
            steps.append(_FROM_LIN[_CYL_OF.get(dst, dst)])
            if dst in _CYL_OF:
                steps.append("SHADOW")
        elif dst == "rgb":
            steps.append(_TO_LIN[_CYL_OF.get(src, src)])
            linear = True
        else:                                   # stock per-step conversion
            steps.extend(_EDGE[e] for e in conversion_path(src, dst))
        space = dst
    if linear:
        steps.append("LINEAR_TO_GAMMA")
    if len(steps) > MAX_STEPS:
        raise ValueError(f"the chain needs {len(steps)} steps; one kernel "
                         f"launch runs at most {MAX_STEPS}")
    codes = _COMPILED[spaces] = tuple(_CODE[s] for s in steps)
    return codes


def _scalar(name: str) -> np.float32:
    if name == "SRGB_INV_GAMMA_EXPONENT":
        return np.float32(1.0 / A.SRGB_GAMMA_EXPONENT)
    if name == "ONE_THIRD":
        return np.float32(1.0 / 3.0)
    if name.startswith("INV_"):
        base = name[4:]
        value = float(base) if base.isdigit() else getattr(A, base)
        return np.float32(1.0 / value)
    return np.float32(getattr(A, name))


def constants() -> np.ndarray:
    """The kernel's f32 constants: the matrices of color/_array.py, then
    the scalars, each rounded to f32 as the plain version rounds them."""
    mats = [np.asarray(getattr(A, "_" + name), np.float64).ravel()
            .astype(np.float32) for name in MATRICES]
    return np.concatenate(mats + [np.array([_scalar(n) for n in SCALARS],
                                           np.float32)])


_PARAMS: dict = {}


def params_bytes(codes) -> bytes:
    """The kernel's `struct ChainParams`: the step count, the codes padded
    to MAX_STEPS, then the constants (all 4-byte fields, no padding)."""
    ints = np.zeros(1 + MAX_STEPS, np.int32)
    ints[0] = len(codes)
    ints[1:1 + len(codes)] = codes
    return ints.tobytes() + constants().tobytes()


def _params(codes) -> ctypes.Array:
    """``params_bytes`` in a host buffer that the launch copies by value;
    cached per chain."""
    buf = _PARAMS.get(codes)
    if buf is None:
        raw = params_bytes(codes)
        if load().zt_color_chain_params_bytes() != len(raw):
            raise RuntimeError("the kernel's ChainParams layout differs "
                               "from the wrapper's")
        buf = _PARAMS[codes] = ctypes.create_string_buffer(raw, len(raw))
    return buf


def _check(batch):
    if not isinstance(batch, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if batch.dtype != torch.uint8 or batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError("expected a uint8 [B, H, W, 3] tensor")


def _quantize(f):
    return torch.clamp(torch.round(f * 255.0), 0, 255).to(torch.uint8)


def fused_color_chain_u8_reference(batch, spaces, quantize: bool = True):
    """Plain PyTorch version, on any device: ``convert_chain(x / 255)``,
    then ``clip(round(f * 255))`` as u8, or the f32 values when not
    ``quantize``. The TPU kernel's math with its exact profile
    (``_chain_planar_u8`` with ``_EXACT``)."""
    _check(batch)
    spaces = tuple(spaces)
    if not chain_supported(spaces):
        raise ValueError(f"the colour-chain kernel does not run {spaces}")
    f = convert_chain(batch.to(torch.int32).to(torch.float32) / 255.0,
                      spaces)
    return _quantize(f) if quantize else f


_GAMMA: dict = {}


def gamma_table(device):
    """The 256 f32 values of a chain's first step, the input gamma, on the
    bytes 0..255: the plain version's own expression
    (``gamma_to_linear(x.to(int32).to(float32) / 255.0)``) computed once a
    device with PyTorch's ops there, so the kernel's table lookup equals
    the plain version's first step bit for bit."""
    table = _GAMMA.get(device)
    if table is None:
        x = torch.arange(256, dtype=torch.int32, device=device)
        table = _GAMMA[device] = A.gamma_to_linear(
            x.to(torch.float32) / 255.0).contiguous()
    return table


_PROBED: set = set()


def _probe_once(device) -> None:
    """K3p once per device before K3's first launch there: the probe on an
    (8, 128) tile of [0, 2] against its plain version on the card."""
    if device in _PROBED:
        return
    x = torch.linspace(0.0, 2.0, 8 * 128, device=device).reshape(8, 128)
    err = probe_error(transcendentals_probe(x),
                      transcendentals_probe_reference(x))
    if not err <= PROBE_TOL:
        raise RuntimeError(f"the colour-chain kernel's transcendentals "
                           f"disagree with PyTorch's on {device}: max "
                           f"relative error {err} > {PROBE_TOL}")
    _PROBED.add(device)


def fused_color_chain_u8(batch, spaces, quantize: bool = True):
    """[B, H, W, 3] u8 through the chain ``spaces`` -> u8 of the same
    shape, or the f32 values before the quantization when not
    ``quantize``. A CUDA tensor runs the kernel (or raises); a CPU tensor
    runs the plain version."""
    global LAUNCHES
    _check(batch)
    spaces = tuple(spaces)
    if batch.device.type == "cpu":
        return fused_color_chain_u8_reference(batch, spaces, quantize)
    if batch.device.type != "cuda":
        raise ValueError(f"no kernel for device {batch.device}")
    if not batch.is_contiguous():
        raise ValueError("the kernel needs a contiguous batch")
    codes = compile_chain(spaces)
    params = _params(codes)
    _probe_once(batch.device)
    out = torch.empty(batch.shape, device=batch.device,
                      dtype=torch.uint8 if quantize else torch.float32)
    n = batch.numel() // 3
    lut = gamma_table(batch.device).data_ptr() \
        if codes and codes[0] == _CODE["GAMMA_TO_LINEAR"] else None
    vec = batch.data_ptr() % 4 == 0 and out.data_ptr() % 16 == 0
    launch("zt_fused_color_chain_u8", batch.device, batch.data_ptr(),
           out.data_ptr(), lut, params, n, int(quantize), int(vec))
    with COUNT_LOCK:
        LAUNCHES += 1
    return out


def transcendentals_probe_reference(x):
    """The probe expression of the TPU's ``mosaic_transcendentals_ok``,
    ``where(x > 0.5, cbrt(x) + x^2.4, x^(1/2.4) + x^3)``, in PyTorch."""
    p = A.SRGB_GAMMA_EXPONENT
    return torch.where(x > 0.5, A._cbrt(x) + x ** p,
                       x ** (1.0 / p) + x ** 3)


def probe_error(got, want) -> float:
    """Max relative error of the probe (0 where both are 0)."""
    den = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / den).max())


def transcendentals_probe(x):
    """K3p on a float32 tensor of any shape (values >= 0): a CUDA tensor
    runs the kernel, a CPU tensor the plain version."""
    global PROBE_LAUNCHES
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise ValueError("expected a float32 tensor")
    if x.device.type == "cpu":
        return transcendentals_probe_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    launch("zt_transcendentals_probe", x.device, x.data_ptr(),
           out.data_ptr(), _params(()), x.numel())
    with COUNT_LOCK:
        PROBE_LAUNCHES += 1
    return out
