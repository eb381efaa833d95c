"""Host-side BLS12-377 group operations and the ate pairing (oracle + verifier).

G1 point ops mirror the role of `snarkvm-curves` in the reference stack
(SURVEY.md §2.8 item 2); the pairing backs KZG verification in the host
verifier. Points are affine tuples (x, y) with None as the identity, or
Jacobian tuples internally for speed.
"""

from __future__ import annotations

from .. import params
from .field import FQ
from .tower import Fq2, Fq6, Fq12, XI

Q = params.Q
R = params.R


# ---------------------------------------------------------------------------
# Generic short-Weierstrass arithmetic over a field object (Fq via PrimeField
# duck-typing, or Fq2 via operator overloading wrapped below).
# ---------------------------------------------------------------------------


class G1:
    """E(Fq): y^2 = x^3 + 1. Affine (x, y) ints; None = identity."""

    B = params.G1_B

    @staticmethod
    def is_on_curve(P):
        if P is None:
            return True
        x, y = P
        return (y * y - (x * x * x + G1.B)) % Q == 0

    @staticmethod
    def neg(P):
        if P is None:
            return None
        return (P[0], (Q - P[1]) % Q)

    @staticmethod
    def add(P, Pp):
        if P is None:
            return Pp
        if Pp is None:
            return P
        x1, y1 = P
        x2, y2 = Pp
        if x1 == x2:
            if (y1 + y2) % Q == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, -1, Q) % Q
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
        x3 = (lam * lam - x1 - x2) % Q
        y3 = (lam * (x1 - x3) - y1) % Q
        return (x3, y3)

    @staticmethod
    def double(P):
        return G1.add(P, P)

    @staticmethod
    def mul(k: int, P):
        k %= R  # scalar field order (valid on the r-torsion)
        acc = None
        while k:
            if k & 1:
                acc = G1.add(acc, P)
            P = G1.add(P, P)
            k >>= 1
        return acc

    @staticmethod
    def mul_full(k: int, P):
        """Scalar mul without reducing mod r (for cofactor clearing)."""
        acc = None
        while k:
            if k & 1:
                acc = G1.add(acc, P)
            P = G1.add(P, P)
            k >>= 1
        return acc

    @staticmethod
    def generator():
        return (params.G1_GEN_X, params.G1_GEN_Y)

    @staticmethod
    def rand(rng):
        return G1.mul(rng.randrange(1, R), G1.generator())


class G2:
    """E'(Fq2): y^2 = x^3 + b' (D-twist, b' = 1/u). Affine (Fq2, Fq2); None = id."""

    B = Fq2(params.G2_B_C0, params.G2_B_C1)

    @staticmethod
    def is_on_curve(P):
        if P is None:
            return True
        x, y = P
        return (y * y) == (x * x * x + G2.B)

    @staticmethod
    def neg(P):
        if P is None:
            return None
        return (P[0], -P[1])

    @staticmethod
    def add(P, Pp):
        if P is None:
            return Pp
        if Pp is None:
            return P
        x1, y1 = P
        x2, y2 = Pp
        if x1 == x2:
            if (y1 + y2).is_zero():
                return None
            lam = (x1.sq() * 3) * (y1 * 2).inv()
        else:
            lam = (y2 - y1) * (x2 - x1).inv()
        x3 = lam.sq() - x1 - x2
        y3 = lam * (x1 - x3) - y1
        return (x3, y3)

    @staticmethod
    def mul(k: int, P):
        acc = None
        while k:
            if k & 1:
                acc = G2.add(acc, P)
            P = G2.add(P, P)
            k >>= 1
        return acc

    @staticmethod
    def generator():
        return (
            Fq2(params.G2_GEN_X_C0, params.G2_GEN_X_C1),
            Fq2(params.G2_GEN_Y_C0, params.G2_GEN_Y_C1),
        )


# ---------------------------------------------------------------------------
# Ate pairing (BLS12 Miller loop over the BLS parameter x).
# ---------------------------------------------------------------------------
# D-type twist untwisting:  (x', y') on E'(Fq2)  ->  (x' w^2, y' w^3) on E(Fq12),
# where w is the Fq12 generator (w^2 = v, w^6 = u). Line functions are
# evaluated directly in Fq12.


def _fq12_from_fq2_w2(a: Fq2) -> Fq12:
    """a * w^2 = a * v   (w^2 = v): Fq6 coeff c1 slot of the even part."""
    return Fq12(Fq6(Fq2.zero(), a, Fq2.zero()), Fq6.zero())


def _fq12_from_fq2_w3(a: Fq2) -> Fq12:
    """a * w^3 = (a*v) * w: Fq6 coeff c1 slot of the odd part."""
    return Fq12(Fq6.zero(), Fq6(Fq2.zero(), a, Fq2.zero()))


def _fq12_scalar(a: int) -> Fq12:
    return Fq12(Fq6(Fq2(a), Fq2.zero(), Fq2.zero()), Fq6.zero())


def _untwist(P2):
    x, y = P2
    return (_fq12_from_fq2_w2(x), _fq12_from_fq2_w3(y))


def _line(T, P_, Pev) -> Fq12:
    """Evaluate the line through T and P_ (Fq12 points) at Pev=(xe, ye) in Fq."""
    (x1, y1), (x2, y2) = T, P_
    xe, ye = Pev
    if T is not P_ and not (x1 == x2 and y1 == y2):
        if x1 == x2:
            # vertical line x = x1
            return _fq12_scalar(xe) - x1
        lam = (y2 - y1) * (x2 - x1).inv()
    else:
        lam = (x1 * x1 * _fq12_scalar(3)) * (y1 * _fq12_scalar(2)).inv()
    # l(x, y) = (y - y1) - lam (x - x1)
    return _fq12_scalar(ye) - y1 - lam * (_fq12_scalar(xe) - x1)


def _fq12_add(a: Fq12, b: Fq12) -> Fq12:
    return Fq12(a.c0 + b.c0, a.c1 + b.c1)


def _fq12_sub(a: Fq12, b: Fq12) -> Fq12:
    return Fq12(a.c0 - b.c0, a.c1 - b.c1)


# Patch minimal operator support used above.
Fq12.__add__ = _fq12_add
Fq12.__sub__ = _fq12_sub


def _ec12_add(P, Pp):
    if P is None:
        return Pp
    if Pp is None:
        return P
    x1, y1 = P
    x2, y2 = Pp
    if x1 == x2:
        if (y1 + y2) == Fq12(Fq6.zero(), Fq6.zero()):
            return None
        lam = (x1 * x1 * _fq12_scalar(3)) * (y1 * _fq12_scalar(2)).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(P1, P2) -> Fq12:
    """f_{x,Q}(P) with Q = untwist(P2), P = P1 in G1 affine."""
    if P1 is None or P2 is None:
        return Fq12.one()
    Qw = _untwist(P2)
    T = Qw
    f = Fq12.one()
    x = params.BLS_X
    bits = bin(x)[3:]  # skip leading 1
    for b in bits:
        f = f.sq() * _line(T, T, P1)
        T = _ec12_add(T, T)
        if b == "1":
            f = f * _line(T, Qw, P1)
            T = _ec12_add(T, Qw)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def pairing(P1, P2) -> Fq12:
    """Full ate pairing e: G1 x G2 -> GT (Fq12 r-th roots of unity)."""
    f = miller_loop(P1, P2)
    # Easy part: f^(q^6 - 1)(q^2 + 1); hard part folded into a plain pow for
    # host-side simplicity (verification is not a hot path).
    f = f.conj() * f.inv()          # f^(q^6 - 1)
    f = f.frobenius(2) * f          # ^(q^2 + 1)
    hard = (Q**4 - Q**2 + 1) // R
    return f.pow(hard)


def pairing_check(pairs) -> bool:
    """Return True iff prod e(P_i, Q_i) == 1."""
    acc = Fq12.one()
    for P1, P2 in pairs:
        acc = acc * miller_loop(P1, P2)
    acc = acc.conj() * acc.inv()
    acc = acc.frobenius(2) * acc
    acc = acc.pow((Q**4 - Q**2 + 1) // R)
    return acc.is_one()
