"""Twisted Edwards curve over Fr (account curve, host-side oracle).

Mirrors the role of snarkVM's `edwards_bls12` curve used for account keys,
signatures and record encryption in the reference
(`upstream:rust/src/account/encryptor.rs`, `wasm/src/account/*`).

Curve: a x^2 + y^2 = 1 + d x^2 y^2 over Fr, a = -1, d = 3021.
Points are affine tuples (x, y); the identity is (0, 1). Twisted Edwards
addition with a = -1 is complete (no exceptional cases).
"""

from __future__ import annotations

import functools

from .. import params

R = params.R
A = params.EDWARDS_A
D = params.EDWARDS_D
ORDER = params.EDWARDS_ORDER
COFACTOR = params.EDWARDS_COFACTOR

IDENTITY = (0, 1)


def is_on_curve(P) -> bool:
    x, y = P
    return (A * x * x + y * y - 1 - D * x * x * y * y) % R == 0


def add(P, Pp):
    x1, y1 = P
    x2, y2 = Pp
    dxy = D * x1 * x2 * y1 * y2 % R
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, R) % R
    y3 = (y1 * y2 - A * x1 * x2) * pow(1 - dxy, -1, R) % R
    return (x3, y3)


def neg(P):
    return ((R - P[0]) % R, P[1])


def double(P):
    return add(P, P)


def mul(k: int, P):
    acc, base = IDENTITY, P
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


@functools.lru_cache(maxsize=1)
def generator():
    """Deterministic subgroup generator: smallest y >= 2 giving a valid point,
    cofactor-cleared into the prime-order subgroup."""
    from .field import FR

    y = 2
    while True:
        num = (1 - y * y) % R
        den = (A - D * y * y) % R
        if den != 0:
            x2 = num * pow(den, -1, R) % R
            if FR.is_square(x2):
                x = FR.sqrt(x2)
                P = (x, y % R)
                if is_on_curve(P):
                    G = mul(COFACTOR, P)
                    if G != IDENTITY and mul(ORDER, G) == IDENTITY:
                        return G
        y += 1


def rand(rng):
    return mul(rng.randrange(1, ORDER), generator())
