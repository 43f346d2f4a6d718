"""Multiply-adds rounded as the JAX package's compiled programs round them.

XLA's CPU backend lets LLVM contract ``x * y + z`` into one fused
multiply-add, which PyTorch's eager ops never do. ``fma`` computes it in
f64, where the product of two f32 values is exact, and rounds once to the
operands' dtype: the contracted answer, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

__all__ = ["fma", "fma_sum"]


def fma(a, b, c):
    """``a * b + c`` with one rounding, on the operands' own device."""
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                c.dtype)
    return (a.double() * b.double() + c.double()).to(dtype)


def fma_sum(terms):
    """``sum(a * b for a, b in terms)`` accumulated left to right as XLA
    contracts ``total = total + a * b``: the first two products join as
    ``fma(a0, b0, a1 * b1)``, every later one as ``fma(a, b, total)``.
    ``terms`` is consumed lazily and must not be empty."""
    it = iter(terms)
    a0, b0 = next(it)
    second = next(it, None)
    if second is None:
        return a0 * b0
    total = fma(a0, b0, second[0] * second[1])
    for a, b in it:
        total = fma(a, b, total)
    return total
