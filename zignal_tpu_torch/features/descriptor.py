"""256-bit binary descriptor (reference: src/features/BinaryDescriptor.zig).

Copied from zignal_tpu/features/descriptor.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BinaryDescriptor"]


class BinaryDescriptor:
    """256-bit descriptor stored as 32 bytes; Hamming distance metric."""

    __slots__ = ("bits",)

    def __init__(self, bits=None):
        self.bits = (np.zeros(32, dtype=np.uint8) if bits is None
                     else np.asarray(bits, dtype=np.uint8))

    def set_bit(self, index: int):
        self.bits[index // 8] |= 1 << (index % 8)

    def get_bit(self, index: int) -> bool:
        return bool((self.bits[index // 8] >> (index % 8)) & 1)

    def hamming_distance(self, other: "BinaryDescriptor") -> int:
        return int(np.unpackbits(self.bits ^ other.bits).sum())

    def __eq__(self, other):
        if isinstance(other, BinaryDescriptor):
            return np.array_equal(self.bits, other.bits)
        return NotImplemented

    def __repr__(self):
        return f"BinaryDescriptor({self.bits[:4].tolist()}...)"


def stack_descriptors(descriptors) -> np.ndarray:
    """[N, 32] u8 matrix from a list of BinaryDescriptors."""
    if len(descriptors) == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    return np.stack([d.bits for d in descriptors])
