"""Fast bignum point arithmetic for making a pool: Jacobian coordinates over
Fq (ints) and Fq2 ((c0, c1) int pairs), and one batched inversion to bring
a run of points back to affine.

The reference's group law (benchmark/reference/bls12_381.py) is affine
and inverts at every step, which makes a pool of tens of thousands of
signatures cost tens of seconds. The points here are the same points:
`benchmark/tests/test_portbench_reference.py` holds scalar products,
progressions and hashes to G2 equal to the reference's.
"""
from __future__ import annotations

from typing import List, Sequence

from ..reference import bls12_381 as bls

q = bls.q


class _Fq:
    @staticmethod
    def mul(a, b):
        return a * b % q

    @staticmethod
    def sqr(a):
        return a * a % q

    @staticmethod
    def add(a, b):
        return (a + b) % q

    @staticmethod
    def sub(a, b):
        return (a - b) % q

    @staticmethod
    def small(a, k):
        return a * k % q

    @staticmethod
    def inv(a):
        return pow(a, -1, q)

    one = 1
    zero = 0


class _Fq2:
    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % q)

    @staticmethod
    def sqr(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % q, 2 * a[0] * a[1] % q)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % q, (a[1] + b[1]) % q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % q, (a[1] - b[1]) % q)

    @staticmethod
    def small(a, k):
        return (a[0] * k % q, a[1] * k % q)

    @staticmethod
    def inv(a):
        n = pow(a[0] * a[0] + a[1] * a[1], -1, q)
        return (a[0] * n % q, -a[1] * n % q)

    one = (1, 0)
    zero = (0, 0)


def _double(F, P):
    X, Y, Z = P
    A, B = F.sqr(X), F.sqr(Y)
    C = F.sqr(B)
    D = F.small(F.sub(F.sub(F.sqr(F.add(X, B)), A), C), 2)
    E = F.small(A, 3)
    X3 = F.sub(F.sqr(E), F.small(D, 2))
    return X3, F.sub(F.mul(E, F.sub(D, X3)), F.small(C, 8)), F.small(F.mul(Y, Z), 2)


def _add_affine(F, P, x2, y2):
    """P (Jacobian) + (x2, y2) (affine); P and the sum are never infinity
    and P != +-(x2, y2) on the paths that call it."""
    X1, Y1, Z1 = P
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    if H == F.zero:
        raise ArithmeticError("the progression met its own addend")
    HH = F.sqr(H)
    I = F.small(HH, 4)
    J = F.mul(H, I)
    r = F.small(F.sub(S2, Y1), 2)
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.small(V, 2))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.small(F.mul(Y1, J), 2))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    return X3, Y3, Z3


def _to_affine(F, pts: Sequence[tuple]) -> List[tuple]:
    """Jacobian points -> affine, with one field inversion in all."""
    prefix, acc = [], F.one
    for _, _, z in pts:
        prefix.append(acc)
        acc = F.mul(acc, z)
    inv = F.inv(acc)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        x, y, z = pts[i]
        zi = F.mul(inv, prefix[i])
        inv = F.mul(inv, z)
        zi2 = F.sqr(zi)
        out[i] = (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))
    return out


def _field(pt):
    return _Fq if isinstance(pt[0], int) else _Fq2


def _tuple(pt):
    x, y = pt
    return pt if isinstance(x, int) else ((x.c0, x.c1), (y.c0, y.c1))


def _point(F, pt):
    """Back to the reference's point type (ints, or its Fq2)."""
    if F is _Fq:
        return pt
    (x0, x1), (y0, y1) = pt
    return (bls.Fq2(x0, x1), bls.Fq2(y0, y1))


def mul(pt, k: int):
    """k * pt for k >= 1 and pt of prime order above k, or a point of any
    order for the cofactor: the reference's ec_mul(pt, k)."""
    F = _field(_tuple(pt))
    x, y = _tuple(pt)
    acc = (x, y, F.one)
    for bit in bin(k)[3:]:
        acc = _double(F, acc)
        if bit == "1":
            acc = _add_affine(F, acc, x, y)
    return _point(F, _to_affine(F, [acc])[0])


def progression(start, step, n: int) -> list:
    """[start + j * step for j in range(n)] as affine points."""
    F = _field(_tuple(start))
    sx, sy = _tuple(start)
    dx, dy = _tuple(step)
    acc = (sx, sy, F.one)
    pts = [acc]
    for _ in range(n - 1):
        acc = _add_affine(F, acc, dx, dy)
        pts.append(acc)
    return [_point(F, p) for p in _to_affine(F, pts)]


def hash_to_g2(message_hash: bytes, domain: int):
    """The reference's hash_to_g2: its try-and-increment candidate times
    the G2 cofactor."""
    return mul(bls.hash_to_g2_candidate(message_hash, domain), bls.G2_COFACTOR)
