"""The least time an H100 could take for a request's work: the larger of
the bytes it must move over the card's memory rate and its operations over
the card's f32 rate. A frozen copy of the port's ``_bounds.py`` (peaks,
``bound``, ``k1_bound``, ``k2_bound``), kept here so that a change to the
program cannot move the yardstick.

Each ``k*_bound`` returns ``(ms, "bytes" or "operations")``.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet at 700 W: HBM bytes/s, and f32 FLOP/s
# outside the tensor cores (a multiply-add counts 2)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# a cube root's cost in those f32 ops, measured once with every SM busy
# (NVIDIA H100 80GB HBM3, 700 W: 0.75207 ps a call); it does not decide
# k1_bound at the north star's shapes, where bytes bound
CBRTF_OPS = 50.4


def bound(nbytes: float, ops: float):
    """(ms, resource): the larger of the HBM time and the op time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(b: int, n: int, o: int):
    """Resize -> blur -> Oklab of ``b`` images of n^2 RGB to o^2: u8 in,
    f32 Oklab out; per output value 4 resize and 26 blur multiply-adds (2
    ops each); per pixel 3 cube roots and two 3x3 mixes (36 ops)."""
    values = b * o * o * 3
    return bound(b * n * n * 3 + 4 * values, values * 2 * 30
                 + b * o * o * (3 * CBRTF_OPS + 36))


def k2_bound(b: int, n: int):
    """Blur -> sharpen -> threshold -> dilate -> erode of ``b`` n^2
    planes: u8 in and out; per pixel 26 blur multiply-adds (2 ops each)
    and 19 other ops (box sums 4, sharpen 6, threshold 1, dilate and erode
    8)."""
    return bound(2 * b * n * n, b * n * n * (2 * 26 + 19))
