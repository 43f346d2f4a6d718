"""Batched color conversion on torch tensors (rgb -> oklab so far)."""

from ._array import convert_array

__all__ = ["convert_array"]
