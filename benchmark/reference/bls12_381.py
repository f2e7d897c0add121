"""BLS12-381 host bignum arithmetic for the benchmark's reference: a frozen
copy of consensus_specs_tpu_torch/crypto/bls12_381.py (itself a copy of
the JAX package's), taken so that later changes to the program cannot move
the yardstick. It imports nothing but the standard library.

The curve constants, the field tower Fq2 = Fq[u]/(u^2+1), Fq6 =
Fq2[v]/(v^3 - (u+1)), Fq12 = Fq6[w]/(w^2 - v), the affine group law,
point (de)compression (zkcrypto flags: c = compressed, b = infinity, a =
the larger y), the Fq2 square root and the 2019 try-and-increment hash to
G2; and the pairing (optimal ate: Miller loop over the untwisted G2 point
with affine line functions, one shared final exponentiation per check)
with the scheme-level verify. One verify takes about
a second on a host core.

Fq elements are Python ints mod q; G1 points are (x, y) int tuples, G2
points (Fq2, Fq2) tuples, None is the point at infinity.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

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

FINAL_EXPONENT = (q ** 12 - 1) // r


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

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __repr__(self):
        return f"Fq2({self.c0:#x}, {self.c1:#x})"


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(1, 1)          # v^3 = xi = 1 + u
G2_B = Fq2(4, 4)        # E': y^2 = x^3 + 4(1 + u)

G2_GEN = (
    Fq2(
        int("352701069587466618187139116011060144890029952792775240219"
            "908644239793785735715026873347600343865175952761926303160"),
        int("305914434424421370997125981475378163698647032547664755865"
            "9373206291635324768958432433509563104347017837885763365758"),
    ),
    Fq2(
        int("198515060228729193556805452117717163830086897821565573085"
            "9378665066344726373823718423869104263333984641494340347905"),
        int("927553665492332455747201965776037880757740193453592970025"
            "027978793976877002675564980949289727957565575433344219582"),
    ),
)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        # Karatsuba-style schoolbook with v^3 = xi reduction
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_v(self):
        # (c0 + c1 v + c2 v^2) * v = c2 xi + c0 v + c1 v^2
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def square(self):
        return self * self

    def inv(self):
        # cubic-extension inversion through the adjoint matrix
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - b * c * XI
        t1 = c.square() * XI - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1 + b * t2) * XI
        inv_d = denom.inv()
        return Fq6(t0 * inv_d, t1 * inv_d, t2 * inv_d)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # w^2 = v
        return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        return self * self

    def inv(self):
        # (a + bw)^-1 = (a - bw) / (a^2 - b^2 v)
        denom = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()
        inv_d = denom.inv()
        return Fq12(self.c0 * inv_d, -(self.c1 * inv_d))

    def __pow__(self, e: int):
        result = FQ12_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


def fq12_from_fq(x: int) -> Fq12:
    return Fq12(Fq6(Fq2(x, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq12_from_fq2(x: Fq2) -> Fq12:
    return Fq12(Fq6(x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w and its inverse powers, for the untwist map
FQ12_W = Fq12(FQ6_ZERO, FQ6_ONE)
_W2_INV = (FQ12_W * FQ12_W).inv()
_W3_INV = (FQ12_W * FQ12_W * FQ12_W).inv()


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


# ---------------------------------------------------------------------------
# Pairing: untwist + Miller loop + final exponentiation
# ---------------------------------------------------------------------------

def untwist(pt):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x / w^2, y / w^3)."""
    if pt is None:
        return None
    x, y = pt
    return (fq12_from_fq2(x) * _W2_INV, fq12_from_fq2(y) * _W3_INV)


def embed_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (fq12_from_fq(x), fq12_from_fq(y))


def _line(r1, r2, p):
    """Evaluation at p of the line through r1, r2 (or tangent if r1 == r2)."""
    x1, y1 = r1
    x2, y2 = r2
    xp, yp = p
    if x1 == x2 and y1 == y2:
        lam = ((x1 * x1) * fq12_from_fq(3)) * (y1 + y1).inv()
        return yp - y1 - lam * (xp - x1)
    if x1 == x2:
        return xp - x1  # vertical line
    lam = (y2 - y1) * (x2 - x1).inv()
    return yp - y1 - lam * (xp - x1)


def miller_loop(q_pt, p_pt) -> Fq12:
    """f_{|x|, Q}(P) with the negative-x inversion folded in; no final exp."""
    if q_pt is None or p_pt is None:
        return FQ12_ONE
    R = q_pt
    f = FQ12_ONE
    for bit in bin(BLS_X)[3:]:
        f = f * f * _line(R, R, p_pt)
        R = ec_add(R, R)
        if bit == "1":
            f = f * _line(R, q_pt, p_pt)
            R = ec_add(R, q_pt)
    return f.inv()  # the BLS parameter is negative


def final_exponentiation(f: Fq12) -> Fq12:
    return f ** FINAL_EXPONENT


def pairing(g1_pt, g2_pt) -> Fq12:
    """e(P in G1, Q in G2), affine inputs (ints, Fq2)."""
    return final_exponentiation(miller_loop(untwist(g2_pt), embed_g1(g1_pt)))


def multi_pairing_is_one(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(P_i, Q_i) == 1, with ONE shared final exponentiation."""
    f = FQ12_ONE
    for g1_pt, g2_pt in pairs:
        f = f * miller_loop(untwist(g2_pt), embed_g1(g1_pt))
    return final_exponentiation(f) == FQ12_ONE


def privtopub(privkey: int) -> bytes:
    return compress_g1(ec_mul(G1_GEN, privkey % r))


def verify(pubkey: bytes, message_hash: bytes, signature: bytes, domain: int) -> bool:
    try:
        pub_pt = decompress_g1(pubkey)
        sig_pt = decompress_g2(signature)
        # e(pk, H(m)) == e(g, sig)  <=>  e(-g, sig) * e(pk, H(m)) == 1
        return multi_pairing_is_one([
            (ec_neg(G1_GEN), sig_pt),
            (pub_pt, hash_to_g2(message_hash, domain)),
        ])
    except AssertionError:
        return False
