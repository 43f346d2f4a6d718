"""QR spec constants (ISO/IEC 18004): EC block structures, alignment
pattern positions, BCH format/version info (reference: src/qrcode/tables.zig).

Copied from zignal_tpu/qrcode/tables.py.
"""

from __future__ import annotations

import enum

__all__ = ["EcLevel", "ec_blocks", "alignment_positions", "dimension",
           "FORMAT_INFO", "VERSION_INFO", "EcBlocks"]


class EcLevel(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    QUARTILE = 2
    HIGH = 3

    @property
    def format_bits(self) -> int:
        return {0: 0b01, 1: 0b00, 2: 0b11, 3: 0b10}[int(self)]

    @classmethod
    def from_format_bits(cls, bits: int) -> "EcLevel":
        return {0b01: cls.LOW, 0b00: cls.MEDIUM,
                0b11: cls.QUARTILE, 0b10: cls.HIGH}[bits]


def dimension(version: int) -> int:
    return 4 * version + 17


class EcBlocks:
    """(ec_per_block, g1_blocks, g1_data, g2_blocks); group-2 blocks carry
    one extra data codeword."""

    __slots__ = ("ec_per_block", "g1_blocks", "g1_data", "g2_blocks")

    def __init__(self, ec, g1b, g1d, g2b):
        self.ec_per_block = ec
        self.g1_blocks = g1b
        self.g1_data = g1d
        self.g2_blocks = g2b

    @property
    def g2_data(self):
        return self.g1_data + 1

    @property
    def total_blocks(self):
        return self.g1_blocks + self.g2_blocks

    @property
    def data_codewords(self):
        return self.g1_blocks * self.g1_data + self.g2_blocks * self.g2_data

    @property
    def total_codewords(self):
        return self.data_codewords + self.total_blocks * self.ec_per_block

    def block_lengths(self):
        return ([self.g1_data] * self.g1_blocks
                + [self.g2_data] * self.g2_blocks)


# ISO/IEC 18004 Table 9, indexed [version-1][L, M, Q, H]
_EC_TABLE = [
    [(7, 1, 19, 0), (10, 1, 16, 0), (13, 1, 13, 0), (17, 1, 9, 0)],
    [(10, 1, 34, 0), (16, 1, 28, 0), (22, 1, 22, 0), (28, 1, 16, 0)],
    [(15, 1, 55, 0), (26, 1, 44, 0), (18, 2, 17, 0), (22, 2, 13, 0)],
    [(20, 1, 80, 0), (18, 2, 32, 0), (26, 2, 24, 0), (16, 4, 9, 0)],
    [(26, 1, 108, 0), (24, 2, 43, 0), (18, 2, 15, 2), (22, 2, 11, 2)],
    [(18, 2, 68, 0), (16, 4, 27, 0), (24, 4, 19, 0), (28, 4, 15, 0)],
    [(20, 2, 78, 0), (18, 4, 31, 0), (18, 2, 14, 4), (26, 4, 13, 1)],
    [(24, 2, 97, 0), (22, 2, 38, 2), (22, 4, 18, 2), (26, 4, 14, 2)],
    [(30, 2, 116, 0), (22, 3, 36, 2), (20, 4, 16, 4), (24, 4, 12, 4)],
    [(18, 2, 68, 2), (26, 4, 43, 1), (24, 6, 19, 2), (28, 6, 15, 2)],
    [(20, 4, 81, 0), (30, 1, 50, 4), (28, 4, 22, 4), (24, 3, 12, 8)],
    [(24, 2, 92, 2), (22, 6, 36, 2), (26, 4, 20, 6), (28, 7, 14, 4)],
    [(26, 4, 107, 0), (22, 8, 37, 1), (24, 8, 20, 4), (22, 12, 11, 4)],
    [(30, 3, 115, 1), (24, 4, 40, 5), (20, 11, 16, 5), (24, 11, 12, 5)],
    [(22, 5, 87, 1), (24, 5, 41, 5), (30, 5, 24, 7), (24, 11, 12, 7)],
    [(24, 5, 98, 1), (28, 7, 45, 3), (24, 15, 19, 2), (30, 3, 15, 13)],
    [(28, 1, 107, 5), (28, 10, 46, 1), (28, 1, 22, 15), (28, 2, 14, 17)],
    [(30, 5, 120, 1), (26, 9, 43, 4), (28, 17, 22, 1), (28, 2, 14, 19)],
    [(28, 3, 113, 4), (26, 3, 44, 11), (26, 17, 21, 4), (26, 9, 13, 16)],
    [(28, 3, 107, 5), (26, 3, 41, 13), (30, 15, 24, 5), (28, 15, 15, 10)],
    [(28, 4, 116, 4), (26, 17, 42, 0), (28, 17, 22, 6), (30, 19, 16, 6)],
    [(28, 2, 111, 7), (28, 17, 46, 0), (30, 7, 24, 16), (24, 34, 13, 0)],
    [(30, 4, 121, 5), (28, 4, 47, 14), (30, 11, 24, 14), (30, 16, 15, 14)],
    [(30, 6, 117, 4), (28, 6, 45, 14), (30, 11, 24, 16), (30, 30, 16, 2)],
    [(26, 8, 106, 4), (28, 8, 47, 13), (30, 7, 24, 22), (30, 22, 15, 13)],
    [(28, 10, 114, 2), (28, 19, 46, 4), (28, 28, 22, 6), (30, 33, 16, 4)],
    [(30, 8, 122, 4), (28, 22, 45, 3), (30, 8, 23, 26), (30, 12, 15, 28)],
    [(30, 3, 117, 10), (28, 3, 45, 23), (30, 4, 24, 31), (30, 11, 15, 31)],
    [(30, 7, 116, 7), (28, 21, 45, 7), (30, 1, 23, 37), (30, 19, 15, 26)],
    [(30, 5, 115, 10), (28, 19, 47, 10), (30, 15, 24, 25), (30, 23, 15, 25)],
    [(30, 13, 115, 3), (28, 2, 46, 29), (30, 42, 24, 1), (30, 23, 15, 28)],
    [(30, 17, 115, 0), (28, 10, 46, 23), (30, 10, 24, 35), (30, 19, 15, 35)],
    [(30, 17, 115, 1), (28, 14, 46, 21), (30, 29, 24, 19), (30, 11, 15, 46)],
    [(30, 13, 115, 6), (28, 14, 46, 23), (30, 44, 24, 7), (30, 59, 16, 1)],
    [(30, 12, 121, 7), (28, 12, 47, 26), (30, 39, 24, 14), (30, 22, 15, 41)],
    [(30, 6, 121, 14), (28, 6, 47, 34), (30, 46, 24, 10), (30, 2, 15, 64)],
    [(30, 17, 122, 4), (28, 29, 46, 14), (30, 49, 24, 10), (30, 24, 15, 46)],
    [(30, 4, 122, 18), (28, 13, 46, 32), (30, 48, 24, 14), (30, 42, 15, 32)],
    [(30, 20, 117, 4), (28, 40, 47, 7), (30, 43, 24, 22), (30, 10, 15, 67)],
    [(30, 19, 118, 6), (28, 18, 47, 31), (30, 34, 24, 34), (30, 20, 15, 61)],
]

# ISO/IEC 18004 Annex E
_ALIGNMENT = [
    [], [6, 18], [6, 22], [6, 26], [6, 30], [6, 34],
    [6, 22, 38], [6, 24, 42], [6, 26, 46], [6, 28, 50], [6, 30, 54],
    [6, 32, 58], [6, 34, 62], [6, 26, 46, 66], [6, 26, 48, 70],
    [6, 26, 50, 74], [6, 30, 54, 78], [6, 30, 56, 82], [6, 30, 58, 86],
    [6, 34, 62, 90], [6, 28, 50, 72, 94], [6, 26, 50, 74, 98],
    [6, 30, 54, 78, 102], [6, 28, 54, 80, 106], [6, 32, 58, 84, 110],
    [6, 30, 58, 86, 114], [6, 34, 62, 90, 118], [6, 26, 50, 74, 98, 122],
    [6, 30, 54, 78, 102, 126], [6, 26, 52, 78, 104, 130],
    [6, 30, 56, 82, 108, 134], [6, 34, 60, 86, 112, 138],
    [6, 30, 58, 86, 114, 142], [6, 34, 62, 90, 118, 146],
    [6, 30, 54, 78, 102, 126, 150], [6, 24, 50, 76, 102, 128, 154],
    [6, 28, 54, 80, 106, 132, 158], [6, 32, 58, 84, 110, 136, 162],
    [6, 26, 54, 82, 110, 138, 166], [6, 30, 58, 86, 114, 142, 170],
]


def ec_blocks(version: int, level: EcLevel) -> EcBlocks:
    return EcBlocks(*_EC_TABLE[version - 1][int(level)])


def alignment_positions(version: int):
    return _ALIGNMENT[version - 1]


def _bch_remainder(data: int, gen: int, total_bits: int, data_bits: int) -> int:
    gen_degree = total_bits - data_bits
    rem = data << gen_degree
    for bit in range(total_bits - 1, gen_degree - 1, -1):
        if (rem >> bit) & 1:
            rem ^= gen << (bit - gen_degree)
    return rem


def _format_info():
    out = []
    for value in range(32):
        bch = _bch_remainder(value, 0b10100110111, 15, 5)
        out.append(((value << 10) | bch) ^ 0x5412)
    return out


def _version_info():
    out = {}
    for version in range(7, 41):
        bch = _bch_remainder(version, 0b1111100100101, 18, 6)
        out[version] = (version << 12) | bch
    return out


FORMAT_INFO = _format_info()        # index = (ec_bits << 3) | mask
VERSION_INFO = _version_info()      # version -> 18-bit codeword
