"""Fused multi-step colour conversion: ``convert_chain``, the counterpart of
zignal_tpu/color/_chain.py.

A chain of ``convert_array`` calls re-encodes and re-decodes at every
``rgb`` junction (linear -> gamma, then gamma -> linear again) and pays
atan2/sin/cos for an in-chain cart -> cyl -> cart round trip. A small
state machine carries linear RGB across rgb junctions (clipping commutes
with the monotone gamma curve) and a cartesian shadow across cylindrical
hops, so only exact inverse pairs are skipped: every conversion's own math
still runs, in the JAX package's order of f32 ops.
"""

from __future__ import annotations

import torch

from . import _array as A

__all__ = ["convert_chain"]

# spaces with a linear-RGB entry/exit edge (everything else takes the
# stock per-step conversion)
_LINEAR_SPACES = ("lab", "lch", "oklab", "oklch", "xyb", "xyz")
_CYL_OF = {"lch": "lab", "oklch": "oklab"}


class _State:
    __slots__ = ("space", "arr", "linear", "cart")

    def __init__(self, space, arr=None, linear=None, cart=None):
        self.space = space
        self.arr = arr          # nominal values in `space`
        self.linear = linear    # linear RGB (space == 'rgb' only)
        self.cart = cart        # cartesian pre-image (cyl spaces only)


def _gamma_arr(st):
    if st.arr is None:
        st.arr = torch.clamp(A.linear_to_gamma(st.linear), 0.0, 1.0)
    return st.arr


def _linear_rgb(st):
    if st.linear is None:
        st.linear = A.gamma_to_linear(st.arr)
    return st.linear


def _from_linear(lin, dst):
    """linear rgb -> dst (dst in _LINEAR_SPACES); returns (arr, cart)."""
    if dst == "xyz":
        return A._mix3(lin, A._RGB2XYZ) * 100.0, None
    if dst == "lab":
        return A.xyz_to_lab(A._mix3(lin, A._RGB2XYZ) * 100.0), None
    if dst == "lch":
        lab = A.xyz_to_lab(A._mix3(lin, A._RGB2XYZ) * 100.0)
        return A.lab_to_lch(lab), lab
    if dst in ("oklab", "oklch"):
        lms = A._mix3(lin, A._RGB2OKLMS)
        oklab = A._mix3(A._cbrt(lms), A._OKLMS2LAB)
        if dst == "oklab":
            return oklab, None
        return A.oklab_to_oklch(oklab), oklab
    if dst == "xyb":
        return A._linrgb_to_xyb(lin), None
    raise AssertionError(dst)


def _to_linear(st):
    """state in a _LINEAR_SPACES space -> linear rgb (clipped to [0,1])."""
    space, arr = st.space, st.arr
    if space in _CYL_OF:
        arr = st.cart if st.cart is not None else (
            A.lch_to_lab(arr) if space == "lch" else A.oklch_to_oklab(arr))
        space = _CYL_OF[space]
    if space == "xyz":
        lin = A._mix3(arr / 100.0, A._XYZ2RGB)
    elif space == "lab":
        lin = A._mix3(A.lab_to_xyz(arr) / 100.0, A._XYZ2RGB)
    elif space == "oklab":
        lms = A._mix3(arr, A._OKLAB2LMS)
        lin = A._mix3(lms ** 3, A._OKLMS2RGB)
    elif space == "xyb":
        lin = A._xyb_to_linrgb(arr)
    else:
        raise AssertionError(space)
    return torch.clamp(lin, 0.0, 1.0)


def _step(st, dst):
    src = st.space
    if src == dst:
        return st
    # cylindrical hops with an exact cartesian shadow
    if _CYL_OF.get(dst) == src:  # lab->lch / oklab->oklch
        cyl = A.lab_to_lch(st.arr) if dst == "lch" \
            else A.oklab_to_oklch(st.arr)
        return _State(dst, cyl, cart=st.arr)
    if _CYL_OF.get(src) == dst and st.cart is not None:
        return _State(dst, st.cart)
    if src == "rgb" and dst in _LINEAR_SPACES:
        arr, cart = _from_linear(_linear_rgb(st), dst)
        return _State(dst, arr, cart=cart)
    if dst == "rgb" and src in _LINEAR_SPACES:
        return _State("rgb", linear=_to_linear(st))
    # anything else: stock pathwise conversion on the nominal values
    arr = _gamma_arr(st) if src == "rgb" else st.arr
    return _State(dst, A.convert_array(arr, src, dst))


def convert_chain(arr, spaces):
    """Convert ``arr`` through ``spaces`` = (src, s1, ..., dst) and return
    the final space's float32 values, on the input's device.

    Equivalent to folding ``convert_array`` over consecutive pairs, but
    exact inverse pairs at junctions (sRGB gamma round trips, in-chain
    cylindrical round trips, the xyz */100 hop) are skipped. ``spaces`` is
    a sequence of at least 2 space names."""
    spaces = tuple(spaces)
    if len(spaces) < 2:
        raise ValueError("convert_chain needs at least (src, dst)")
    A._check_channels(arr, spaces[0], spaces[-1])
    st = _State(spaces[0], arr.to(torch.float32))
    for dst in spaces[1:]:
        st = _step(st, dst)
    if st.space == "rgb":
        return _gamma_arr(st)
    return st.arr
