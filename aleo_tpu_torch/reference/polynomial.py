"""Host-side polynomial algebra over Fr: NTT, interpolation, division.

Oracle for the TPU NTT kernels (`aleo_tpu_torch/ntt`) and the workhorse of the
host verifier. Polynomials are lists of coefficients, low degree first.
"""

from __future__ import annotations

from typing import List

from .. import params
from .field import fr_root_of_unity

R = params.R


def ntt(values: List[int], invert: bool = False) -> List[int]:
    """In-place radix-2 Cooley-Tukey NTT over Fr. len must be a power of two."""
    a = [v % R for v in values]
    n = len(a)
    assert n & (n - 1) == 0
    if n == 1:
        return a
    w_n = fr_root_of_unity(n)
    if invert:
        w_n = pow(w_n, -1, R)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(w_n, n // length, R)
        for i in range(0, n, length):
            w = 1
            for k in range(i, i + length // 2):
                u, v = a[k], a[k + length // 2] * w % R
                a[k] = (u + v) % R
                a[k + length // 2] = (u - v) % R
                w = w * wlen % R
        length <<= 1
    if invert:
        n_inv = pow(n, -1, R)
        a = [x * n_inv % R for x in a]
    return a


def coset_ntt(coeffs: List[int], shift: int) -> List[int]:
    """Evaluate on the coset shift * H."""
    n = len(coeffs)
    scaled = [c * pow(shift, i, R) % R for i, c in enumerate(coeffs)]
    return ntt(scaled)


def coset_intt(evals: List[int], shift: int) -> List[int]:
    coeffs = ntt(evals, invert=True)
    sinv = pow(shift, -1, R)
    return [c * pow(sinv, i, R) % R for i, c in enumerate(coeffs)]


def evaluate(coeffs: List[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_mul(a: List[int], b: List[int]) -> List[int]:
    if not a or not b:
        return []
    n = 1
    while n < len(a) + len(b) - 1:
        n <<= 1
    fa = ntt(a + [0] * (n - len(a)))
    fb = ntt(b + [0] * (n - len(b)))
    fc = [x * y % R for x, y in zip(fa, fb)]
    return ntt(fc, invert=True)[: len(a) + len(b) - 1]


def poly_add(a: List[int], b: List[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R for i in range(n)]


def poly_sub(a: List[int], b: List[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % R for i in range(n)]


def poly_scale(a: List[int], s: int) -> List[int]:
    return [c * s % R for c in a]


def poly_trim(a: List[int]) -> List[int]:
    i = len(a)
    while i > 0 and a[i - 1] == 0:
        i -= 1
    return a[:i]


def divide_by_vanishing(a: List[int], n: int):
    """Divide by v_H(X) = X^n - 1; returns (quotient, remainder)."""
    rem = list(a)
    quo = [0] * max(0, len(a) - n)
    for i in range(len(a) - 1, n - 1, -1):
        c = rem[i]
        if c:
            quo[i - n] = c
            rem[i] = 0
            rem[i - n] = (rem[i - n] + c) % R
    return poly_trim(quo), poly_trim(rem)


def divide_by_linear(a: List[int], z: int):
    """Divide by (X - z): returns (quotient, remainder=a(z)). Synthetic division."""
    if not a:
        return [], 0
    quo = [0] * (len(a) - 1)
    carry = 0
    for i in range(len(a) - 1, 0, -1):
        carry = (carry * z + a[i]) % R
        quo[i - 1] = carry
    rem = (carry * z + a[0]) % R
    return quo, rem


def interpolate_on_domain(evals: List[int]) -> List[int]:
    """Coefficients of the unique poly of deg < n matching evals on H."""
    return ntt(evals, invert=True)


def lagrange_coeffs_at(n: int, x: int) -> List[int]:
    """[L_h(x)] for the size-n subgroup H: L_h(x) = h (x^n - 1) / (n (x - h))."""
    w = fr_root_of_unity(n)
    vx = (pow(x, n, R) - 1) % R
    out = []
    h = 1
    ninv = pow(n, -1, R)
    for _ in range(n):
        if x % R == h:
            out.append(1)
        elif vx == 0:
            out.append(0)
        else:
            out.append(h * vx % R * pow((x - h) % R, -1, R) % R * ninv % R)
        h = h * w % R
    return out
