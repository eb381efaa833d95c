"""Exact big-integer prime-field arithmetic (the bit-exactness oracle).

Python integers are arbitrary precision, so this module is trivially correct;
it serves as the oracle every device kernel is tested against bit-for-bit
(mirroring the reference's strategy of using the unmodified Rust stack as the
test oracle — SURVEY.md §4). It is also used on the host for non-hot-path
work: verifier algebra, parameter derivation, serialization.
"""

from __future__ import annotations

from .. import params


class PrimeField:
    """Arithmetic mod a prime p, on plain ints in [0, p)."""

    def __init__(self, p: int, two_adicity: int = 0, two_adic_root: int = 0):
        self.p = p
        self.two_adicity = two_adicity
        self.two_adic_root = two_adic_root
        self._nonresidue = None

    def add(self, a, b):
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a, b):
        c = a - b
        return c + self.p if c < 0 else c

    def neg(self, a):
        return 0 if a == 0 else self.p - a

    def mul(self, a, b):
        return (a * b) % self.p

    def sq(self, a):
        return (a * a) % self.p

    def inv(self, a):
        if a == 0:
            raise ZeroDivisionError("field inverse of 0")
        return pow(a, -1, self.p)

    def div(self, a, b):
        return (a * self.inv(b)) % self.p

    def pow(self, a, e):
        return pow(a, e, self.p)

    def is_square(self, a):
        return a == 0 or pow(a, (self.p - 1) // 2, self.p) == 1

    def nonresidue(self):
        if self._nonresidue is None:
            n = 2
            while self.is_square(n):
                n += 1
            self._nonresidue = n
        return self._nonresidue

    def sqrt(self, a):
        """Tonelli-Shanks; returns the even root representative or raises."""
        p = self.p
        if a == 0:
            return 0
        if not self.is_square(a):
            raise ValueError("not a quadratic residue")
        if p % 4 == 3:
            r = pow(a, (p + 1) // 4, p)
        else:
            q, s = p - 1, 0
            while q % 2 == 0:
                q //= 2
                s += 1
            z = pow(self.nonresidue(), q, p)
            m, c, t, r = s, z, pow(a, q, p), pow(a, (q + 1) // 2, p)
            while t != 1:
                t2, i = t, 0
                while t2 != 1:
                    t2 = (t2 * t2) % p
                    i += 1
                b = pow(c, 1 << (m - i - 1), p)
                m, c = i, (b * b) % p
                t = (t * c) % p
                r = (r * b) % p
        return min(r, p - r)

    def rand(self, rng):
        return rng.randrange(self.p)


FQ = PrimeField(params.Q, params.FQ_TWO_ADICITY)
FR = PrimeField(params.R, params.FR_TWO_ADICITY, params.FR_TWO_ADIC_ROOT)


def fr_root_of_unity(order: int) -> int:
    """Primitive root of unity of the given power-of-two order in Fr."""
    assert order & (order - 1) == 0 and order > 0
    log = order.bit_length() - 1
    assert log <= params.FR_TWO_ADICITY
    return pow(params.FR_TWO_ADIC_ROOT, 1 << (params.FR_TWO_ADICITY - log), params.R)
