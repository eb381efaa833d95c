"""Extension-field tower Fq2 -> Fq6 -> Fq12 for BLS12-377 (host-side).

Used only by the host verifier's pairing check (KZG verification is not a
hot path — the reference likewise verifies on CPU, cf. snarkvm's verifier
behind `Trace::verify_execution_proof`, surfaced at
`upstream:rust/src/program/helpers/offline.rs:71-78`).

Tower construction (matching the standard BLS12-377 tower):
    Fq2  = Fq [u] / (u^2 + 5)          (nonresidue -5)
    Fq6  = Fq2[v] / (v^3 - u)
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from .. import params

Q = params.Q
# u^2 = NR in Fq2
NR = params.FQ2_NONRESIDUE  # -5 mod q


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    @staticmethod
    def zero():
        return Fq2(0, 0)

    @staticmethod
    def one():
        return Fq2(1, 0)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        return Fq2(a * c + NR * b * d, a * d + b * c)

    __rmul__ = __mul__

    def sq(self):
        return self * self

    def conj(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        # (a + bu)^-1 = (a - bu) / (a^2 - NR b^2)
        norm = (self.c0 * self.c0 - NR * self.c1 * self.c1) % Q
        ninv = pow(norm, -1, Q)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def pow(self, e: int):
        r, b = Fq2.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def is_square(self):
        # norm map N(a) = a^(q+1) = a * a^q lands in Fq; a is a square in Fq2
        # iff N(a) is a square in Fq.
        norm = (self.c0 * self.c0 - NR * self.c1 * self.c1) % Q
        return norm == 0 or pow(norm, (Q - 1) // 2, Q) == 1

    def sqrt(self):
        """Square root in Fq2 (complex method); raises if non-square."""
        from .field import FQ

        if self.is_zero():
            return Fq2.zero()
        if self.c1 == 0:
            if FQ.is_square(self.c0):
                return Fq2(FQ.sqrt(self.c0), 0)
            # sqrt(c0) = x*u with  NR*x^2 = c0
            x2 = FQ.div(self.c0, NR % Q)
            return Fq2(0, FQ.sqrt(x2))
        norm = (self.c0 * self.c0 - NR * self.c1 * self.c1) % Q
        if pow(norm, (Q - 1) // 2, Q) != 1:
            raise ValueError("not a square in Fq2")
        n = FQ.sqrt(norm)
        # a = x^2 with x = x0 + x1 u:  x0^2 = (c0 + n)/2 or (c0 - n)/2
        for cand in (n, Q - n):
            x0sq = FQ.div((self.c0 + cand) % Q, 2)
            if FQ.is_square(x0sq):
                x0 = FQ.sqrt(x0sq)
                if x0 == 0:
                    continue
                x1 = FQ.div(self.c1, (2 * x0) % Q)
                r = Fq2(x0, x1)
                if r * r == self:
                    return r
        raise ValueError("sqrt failed in Fq2")

    def frobenius(self):
        """a -> a^q  (conjugation, since u^q = -u)."""
        return self.conj()

    def __repr__(self):
        return f"Fq2({self.c0:#x}, {self.c1:#x})"


# v^3 = XI in Fq6, with XI = u
XI = Fq2(0, 1)

# Frobenius coefficients: v^(q^i) = FROB6_C1[i] * v ; (v^2)^(q^i) = FROB6_C2[i] v^2
# v^q = v^(q-1) * v = XI^((q-1)/3) * v.
_FROB6_C1 = [XI.pow(((Q**i) - 1) // 3) for i in range(6)]
_FROB6_C2 = [XI.pow((2 * ((Q**i) - 1)) // 3) for i in range(6)]
# w^q = w^(q-1) * w = XI^((q-1)/6) * w  (w^2 = v, w^6 = u... w^6 = v^3 = u = XI)
_FROB12_C1 = [XI.pow(((Q**i) - 1) // 6) for i in range(12)]


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a0 * b1 + a1 * b0
        t2 = a0 * b2 + a1 * b1 + a2 * b0
        t3 = a1 * b2 + a2 * b1
        t4 = a2 * b2
        # reduce v^3 -> XI, v^4 -> XI v
        return Fq6(t0 + t3 * XI, t1 + t4 * XI, t2)

    def mul_by_v(self):
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.sq() - (b * c) * XI
        t1 = (c.sq()) * XI - a * b
        t2 = b.sq() - a * c
        d = a * t0 + (c * t1 + b * t2) * XI
        dinv = d.inv()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def frobenius(self, power: int = 1):
        c0, c1, c2 = self.c0, self.c1, self.c2
        for _ in range(power):
            c0 = c0.frobenius()
            c1 = c1.frobenius()
            c2 = c2.frobenius()
        return Fq6(c0, c1 * _FROB6_C1[power % 6], c2 * _FROB6_C2[power % 6])


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self):
        return self.c0 == Fq6.one() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # w^2 = v
        return Fq12(t0 + t1.mul_by_v(), a0 * b1 + a1 * b0)

    def sq(self):
        return self * self

    def conj(self):
        return Fq12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v())
        tinv = t.inv()
        return Fq12(self.c0 * tinv, -(self.c1 * tinv))

    def pow(self, e: int):
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.sq()
            e >>= 1
        return r

    def frobenius(self, power: int = 1):
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power)
        coeff = _FROB12_C1[power % 12]
        return Fq12(c0, Fq6(c1.c0 * coeff, c1.c1 * coeff, c1.c2 * coeff))
