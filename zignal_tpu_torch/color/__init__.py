"""Batched colour conversion on torch tensors: the float conversion graph,
the exact u8 edges and the fused chain."""

from ._array import NUM_CHANNELS, convert_array, convert_u8_array
from ._chain import convert_chain
from ._path import SPACES, conversion_path

__all__ = ["convert_array", "convert_u8_array", "convert_chain",
           "conversion_path", "NUM_CHANNELS", "SPACES"]
