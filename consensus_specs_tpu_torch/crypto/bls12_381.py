"""BLS12-381 host bignum arithmetic: the part the port's staging needs.

The port's own copy of consensus_specs_tpu/crypto/bls12_381.py, cut to
what the device path and its staging use: the curve constants, Fq2, the
affine group law, point (de)compression (zkcrypto flags: c = compressed,
b = infinity, a = the larger y), the Fq2 square root and the 2019
try-and-increment hash to G2. The pairing oracle is left out: the tests
take it from the reference package.

Fq elements are Python ints mod q; G1 points are (x, y) int tuples, G2
points (Fq2, Fq2) tuples, None is the point at infinity.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
r = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 0xD201000000010000  # |x|; the BLS parameter is -x
G2_COFACTOR = int(
    "30550233393126834420099975319312150421446601925418814266766403298226"
    "76041829718840265074273592599778478322728390416166612858038233783720"
    "96355777062779109")

G1_GEN = (
    3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
)


class Fq2:
    """c0 + c1 u with u^2 = -1."""
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % q
        self.c1 = c1 % q

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def inv(self):
        inv_norm = pow(self.c0 * self.c0 + self.c1 * self.c1, -1, q)
        return Fq2(self.c0 * inv_norm, -self.c1 * inv_norm)

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        result = FQ2_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0:#x}, {self.c1:#x})"


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(1, 1)          # v^3 = xi = 1 + u
G2_B = Fq2(4, 4)        # E': y^2 = x^3 + 4(1 + u)


# ---------------------------------------------------------------------------
# Affine group law over Fq (ints) and Fq2
# ---------------------------------------------------------------------------

def _is_int(x) -> bool:
    return isinstance(x, int)


def _f_inv(x):
    return pow(x, -1, q) if _is_int(x) else x.inv()


def ec_double(pt):
    if pt is None:
        return None
    x, y = pt
    xx = x * x
    lam = (xx + xx + xx) * _f_inv(y + y)
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    if _is_int(x):
        return (x3 % q, y3 % q)
    return (x3, y3)


def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return ec_double(p1)
        return None
    lam = (y2 - y1) * _f_inv(x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    if _is_int(x1):
        return (x3 % q, y3 % q)
    return (x3, y3)


def ec_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % q if _is_int(y) else -y)


def ec_mul(pt, n: int):
    result = None
    addend = pt
    while n > 0:
        if n & 1:
            result = ec_add(result, addend)
        addend = ec_double(addend)
        n >>= 1
    return result


# ---------------------------------------------------------------------------
# Compression (48-byte G1, 96-byte G2, big-endian, flags in the top bits)
# ---------------------------------------------------------------------------

_POW_381 = 1 << 381
_FLAG_A = 1 << 381
_FLAG_B = 1 << 382
_FLAG_C = 1 << 383


def compress_g1(pt) -> bytes:
    if pt is None:
        return (_FLAG_C | _FLAG_B).to_bytes(48, "big")
    x, y = pt
    a_flag = (y * 2) // q
    return (x | _FLAG_C | (a_flag * _FLAG_A)).to_bytes(48, "big")


def decompress_g1(data: bytes):
    """Raises AssertionError on any malformed encoding."""
    assert len(data) == 48, "G1 point must be 48 bytes"
    z = int.from_bytes(data, "big")
    c_flag = (z >> 383) & 1
    b_flag = (z >> 382) & 1
    a_flag = (z >> 381) & 1
    x = z % _POW_381
    assert c_flag == 1, "c_flag must be set"
    if b_flag == 1:
        assert a_flag == 0 and x == 0, "invalid infinity encoding"
        return None
    assert x < q, "x out of range"
    y2 = (x * x * x + 4) % q
    y = pow(y2, (q + 1) // 4, q)  # q = 3 mod 4
    assert (y * y) % q == y2, "x not on curve"
    if (y * 2) // q != a_flag:
        y = q - y
    return (x, y)


def compress_g2(pt) -> bytes:
    if pt is None:
        return (_FLAG_C | _FLAG_B).to_bytes(48, "big") + b"\x00" * 48
    x, y = pt
    a_flag1 = (y.c1 * 2) // q
    z1 = x.c1 | _FLAG_C | (a_flag1 * _FLAG_A)
    return z1.to_bytes(48, "big") + x.c0.to_bytes(48, "big")


def decompress_g2(data: bytes):
    """Raises AssertionError on any malformed encoding."""
    assert len(data) == 96, "G2 point must be 96 bytes"
    z1 = int.from_bytes(data[:48], "big")
    z2 = int.from_bytes(data[48:], "big")
    c_flag1 = (z1 >> 383) & 1
    b_flag1 = (z1 >> 382) & 1
    a_flag1 = (z1 >> 381) & 1
    x1 = z1 % _POW_381
    assert z2 >> 381 == 0, "z2 flag bits must be clear"
    assert c_flag1 == 1, "c_flag must be set"
    if b_flag1 == 1:
        assert a_flag1 == 0 and x1 == 0 and z2 == 0, "invalid infinity encoding"
        return None
    assert x1 < q and z2 < q, "x out of range"
    x = Fq2(z2, x1)
    y = modular_squareroot(x * x * x + G2_B)
    assert y is not None, "x not on curve"
    if (y.c1 * 2) // q != a_flag1:
        y = -y
    return (x, y)


# ---------------------------------------------------------------------------
# Fq2 square root and hash_to_G2 (2019 try-and-increment)
# ---------------------------------------------------------------------------

_FQ2_ORDER = q ** 2 - 1
EIGHTH_ROOTS = [XI ** ((_FQ2_ORDER * k) // 8) for k in range(8)]


def modular_squareroot(value: Fq2) -> Optional[Fq2]:
    """Fq2 square root favoring the higher-imaginary (then higher-real) root."""
    candidate = value ** ((_FQ2_ORDER + 8) // 16)
    check = candidate.square() / value
    if check in EIGHTH_ROOTS[::2]:
        x1 = candidate / EIGHTH_ROOTS[EIGHTH_ROOTS.index(check) // 2]
        x2 = -x1
        if (x1.c1, x1.c0) > (x2.c1, x2.c0):
            return x1
        return x2
    return None


def hash_to_g2_candidate(message_hash: bytes, domain: int) -> Tuple[Fq2, Fq2]:
    """The try-and-increment curve point before the cofactor multiply."""
    domain_bytes = int(domain).to_bytes(8, "big")
    x_re = int.from_bytes(
        hashlib.sha256(message_hash + domain_bytes + b"\x01").digest(), "big")
    x_im = int.from_bytes(
        hashlib.sha256(message_hash + domain_bytes + b"\x02").digest(), "big")
    x = Fq2(x_re, x_im)
    while True:
        y = modular_squareroot(x * x * x + G2_B)
        if y is not None:
            return (x, y)
        x = x + FQ2_ONE


def hash_to_g2(message_hash: bytes, domain: int) -> Tuple[Fq2, Fq2]:
    return ec_mul(hash_to_g2_candidate(message_hash, domain), G2_COFACTOR)


def privtopub(privkey: int) -> bytes:
    return compress_g1(ec_mul(G1_GEN, privkey % r))


def sign(message_hash: bytes, privkey: int, domain: int) -> bytes:
    return compress_g2(ec_mul(hash_to_g2(message_hash, domain), privkey % r))
