"""GF(256) arithmetic and Reed-Solomon codec for QR codes
(reference: src/qrcode/galois.zig, reed_solomon.zig). Polynomial 0x11D.

Copied from zignal_tpu/qrcode/galois.py.
"""

from __future__ import annotations

__all__ = ["gf_mul", "rs_encode", "rs_decode", "RSError"]

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


class RSError(ValueError):
    pass


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _gf_div(a: int, b: int) -> int:
    if b == 0:
        raise RSError("division by zero in GF(256)")
    if a == 0:
        return 0
    return _EXP[(_LOG[a] - _LOG[b]) % 255]


def _poly_mul(p, q):
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a == 0:
            continue
        for j, b in enumerate(q):
            out[i + j] ^= gf_mul(a, b)
    return out


def _generator(necc: int):
    g = [1]
    for i in range(necc):
        g = _poly_mul(g, [1, _EXP[i]])
    return g


_GEN_CACHE = {}


def rs_encode(data: bytes, necc: int) -> bytes:
    """Error-correction codewords for `data` (systematic RS)."""
    if necc not in _GEN_CACHE:
        _GEN_CACHE[necc] = _generator(necc)
    gen = _GEN_CACHE[necc]
    rem = [0] * necc
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            for i in range(necc):
                rem[i] ^= gf_mul(gen[i + 1], factor)
    return bytes(rem)


def rs_decode(block: bytearray, necc: int) -> int:
    """Correct up to necc//2 errors in `block` (data+ecc) in place.
    Returns the number of corrected errors (reference:
    reed_solomon.zig:67 — syndromes + Berlekamp-Massey + Chien/Forney)."""
    n = len(block)
    syndromes = []
    has_error = False
    for i in range(necc):
        s = 0
        for byte in block:
            s = gf_mul(s, _EXP[i]) ^ byte
        syndromes.append(s)
        if s:
            has_error = True
    if not has_error:
        return 0

    # Berlekamp-Massey: error locator polynomial sigma
    sigma = [1]
    prev = [1]
    m = 1
    b = 1
    for i in range(necc):
        d = syndromes[i]
        for j in range(1, len(sigma)):
            d ^= gf_mul(sigma[j], syndromes[i - j])
        if d == 0:
            m += 1
        elif 2 * (len(sigma) - 1) <= i:
            t = sigma[:]
            coef = _gf_div(d, b)
            shifted = [0] * m + [gf_mul(c, coef) for c in prev]
            sigma = [a ^ bb for a, bb in
                     zip(sigma + [0] * (len(shifted) - len(sigma)),
                         shifted + [0] * (len(sigma) - len(shifted)))]
            prev = t
            b = d
            m = 1
        else:
            coef = _gf_div(d, b)
            shifted = [0] * m + [gf_mul(c, coef) for c in prev]
            sigma = [a ^ bb for a, bb in
                     zip(sigma + [0] * (len(shifted) - len(sigma)),
                         shifted + [0] * (len(sigma) - len(shifted)))]
            m += 1

    nerr = len(sigma) - 1
    if nerr == 0 or nerr > necc // 2:
        raise RSError("too many errors to correct")

    # Chien search: roots of sigma -> error positions
    positions = []
    for pos in range(n):
        x_inv = _EXP[(255 - (n - 1 - pos)) % 255]
        val = 0
        for c in reversed(sigma):
            val = gf_mul(val, x_inv) ^ c
        if val == 0:
            positions.append(pos)
    if len(positions) != nerr:
        raise RSError("error locator does not factor")

    # Forney: omega(x) = S(x) * sigma(x) mod x^necc, ascending powers
    # (sigma is already ascending: sigma[j] is the coefficient of x^j)
    om = [0] * necc
    for i, a in enumerate(syndromes):
        if a == 0:
            continue
        for j, bb in enumerate(sigma):
            if i + j < necc:
                om[i + j] ^= gf_mul(a, bb)

    for pos in positions:
        x = _EXP[(n - 1 - pos) % 255]        # error locator X
        x_inv = _EXP[(255 - (n - 1 - pos)) % 255]
        om_val = 0
        for c in reversed(om):
            om_val = gf_mul(om_val, x_inv) ^ c
        # formal derivative: sigma'(x) keeps odd-power coefficients
        deriv = 0
        for j in range(1, len(sigma), 2):
            xv = 1
            for _ in range(j - 1):
                xv = gf_mul(xv, x_inv)
            deriv ^= gf_mul(sigma[j], xv)
        if deriv == 0:
            raise RSError("Forney derivative is zero")
        # generator roots start at alpha^0 (b=0): e = X * omega(X^-1)/sigma'(X^-1)
        magnitude = gf_mul(x, _gf_div(om_val, deriv))
        block[pos] ^= magnitude

    # verify
    for i in range(necc):
        s = 0
        for byte in block:
            s = gf_mul(s, _EXP[i]) ^ byte
        if s:
            raise RSError("correction failed verification")
    return nerr
