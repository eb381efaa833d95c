"""Host arithmetic of BLS12-377's G1 (and the little of G2 the SRS needs).

Plain Python integers. Affine points are (x, y) tuples with None for the
identity; scalar multiplication runs in Jacobian coordinates. `to_bytes` /
`from_bytes` read and write the program's 48-byte compressed form: x little
endian, the top byte's bit 7 the identity and bit 6 "y is the larger root".
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .field import FQ2_NONRESIDUE, G1_B, G1_GEN, G2_B, G2_GEN, Q, R, sqrt_q

Point = Optional[Tuple[int, int]]

_INF, _YSIGN = 0x80, 0x40


def generator() -> Point:
    return G1_GEN


def on_curve(p: Point) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - G1_B) % Q == 0


def neg(p: Point) -> Point:
    return None if p is None else (p[0], (Q - p[1]) % Q)


def add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def sub(p: Point, q: Point) -> Point:
    return add(p, neg(q))


# Jacobian (X, Y, Z), Z = 0 for the identity


def _jdouble(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return (x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q)


def _jadd_affine(p, a: Point):
    if a is None:
        return p
    x1, y1, z1 = p
    if z1 == 0:
        return (a[0], a[1], 1)
    z1z1 = z1 * z1 % Q
    u2 = a[0] * z1z1 % Q
    s2 = a[1] * z1 % Q * z1z1 % Q
    if u2 == x1:
        return _jdouble(p) if s2 == y1 else (1, 1, 0)
    h = (u2 - x1) % Q
    hh = h * h % Q
    i = 4 * hh % Q
    j = h * i % Q
    rr = 2 * (s2 - y1) % Q
    v = x1 * i % Q
    x3 = (rr * rr - j - 2 * v) % Q
    y3 = (rr * (v - x3) - 2 * y1 * j) % Q
    z3 = ((z1 + h) ** 2 - z1z1 - hh) % Q
    return (x3, y3, z3)


def _to_affine(p) -> Point:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, Q)
    zi2 = zi * zi % Q
    return (x * zi2 % Q, y * zi2 % Q * zi % Q)


def mul(k: int, p: Point) -> Point:
    """[k] p by double-and-add (k reduced mod r: p lies in the r-torsion)."""
    k %= R
    if p is None or k == 0:
        return None
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jdouble(acc)
        if bit == "1":
            acc = _jadd_affine(acc, p)
    return _to_affine(acc)


def lincomb(scalars: List[int], points: List[Point]) -> Point:
    """sum_i scalars[i] * points[i], one scalar multiplication at a time."""
    acc = None
    for s, p in zip(scalars, points):
        acc = add(acc, mul(s, p))
    return acc


def to_bytes(p: Point) -> bytes:
    if p is None:
        return bytes(47) + bytes([_INF])
    buf = bytearray(p[0].to_bytes(48, "little"))
    if p[1] > Q - p[1]:
        buf[47] |= _YSIGN
    return bytes(buf)


def from_bytes(b: bytes) -> Point:
    """Raises ValueError on a malformed encoding or an x off the curve."""
    if len(b) != 48:
        raise ValueError("a G1 point takes 48 bytes")
    if b[47] & _INF:
        return None
    buf = bytearray(b)
    larger = bool(buf[47] & _YSIGN)
    buf[47] &= 0x3F
    x = int.from_bytes(bytes(buf), "little")
    if x >= Q:
        raise ValueError("x out of range")
    y = sqrt_q(x * x * x + G1_B)
    if (y > Q - y) != larger:
        y = (Q - y) % Q
    return (x, y)


# G2 over Fq2 = Fq[u] / (u^2 - FQ2_NONRESIDUE): only what the SRS's [tau]H needs


def _f2_mul(a, b):
    return ((a[0] * b[0] + FQ2_NONRESIDUE * a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def _f2_inv(a):
    t = pow((a[0] * a[0] - FQ2_NONRESIDUE * a[1] * a[1]) % Q, -1, Q)
    return (a[0] * t % Q, (Q - a[1]) * t % Q)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def g2_on_curve(p) -> bool:
    x, y = p
    rhs = _f2_mul(_f2_mul(x, x), x)
    return _f2_sub(_f2_mul(y, y), ((rhs[0] + G2_B[0]) % Q, (rhs[1] + G2_B[1]) % Q)) == (0, 0)


def _g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if ((y1[0] + y2[0]) % Q, (y1[1] + y2[1]) % Q) == (0, 0):
            return None
        x1sq = _f2_mul(x1, x1)
        lam = _f2_mul((3 * x1sq[0] % Q, 3 * x1sq[1] % Q), _f2_inv((2 * y1[0] % Q, 2 * y1[1] % Q)))
    else:
        lam = _f2_mul(_f2_sub(y2, y1), _f2_inv(_f2_sub(x2, x1)))
    x3 = _f2_sub(_f2_sub(_f2_mul(lam, lam), x1), x2)
    return (x3, _f2_sub(_f2_mul(lam, _f2_sub(x1, x3)), y1))


def g2_generator():
    return G2_GEN


def g2_mul(k: int, p):
    acc = None
    for bit in bin(k % R)[2:]:
        acc = _g2_add(acc, acc)
        if bit == "1":
            acc = _g2_add(acc, p)
    return acc
