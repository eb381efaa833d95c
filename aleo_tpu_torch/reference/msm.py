"""Host-side multi-scalar multiplication oracle (naive + Pippenger).

Oracle for `aleo_tpu_torch/msm` TPU kernels (SURVEY.md §2.8 item 3 — the
`snarkvm-algorithms` MSM the reference delegates to).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .curve import G1


def msm_naive(scalars: List[int], points: List) -> Optional[Tuple[int, int]]:
    acc = None
    for k, P in zip(scalars, points):
        if k and P is not None:
            acc = G1.add(acc, G1.mul(k, P))
    return acc


# ---------------------------------------------------------------------------
# Jacobian-coordinate host MSM: the fast host path (used as the CPU-backend
# fallback for KZG commitments in tests — python bigints beat XLA:CPU on the
# bigint group law by a wide margin). Jacobian (X, Y, Z), affine = (X/Z^2,
# Y/Z^3), None = identity; ~8M per mixed add / ~12M per full add, no modinv
# until the final affine conversion.
# ---------------------------------------------------------------------------

from .. import params as _params

_Q = _params.Q


def _jdouble(P):
    if P is None:
        return None
    X, Y, Z = P
    if Y == 0:
        return None
    A = X * X % _Q
    B = Y * Y % _Q
    C = B * B % _Q
    D = 2 * ((X + B) * (X + B) - A - C) % _Q
    E = 3 * A % _Q
    F = E * E % _Q
    X3 = (F - 2 * D) % _Q
    Y3 = (E * (D - X3) - 8 * C) % _Q
    Z3 = 2 * Y * Z % _Q
    return (X3, Y3, Z3)


def _jadd(P, Qp):
    if P is None:
        return Qp
    if Qp is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Qp
    Z1Z1 = Z1 * Z1 % _Q
    Z2Z2 = Z2 * Z2 % _Q
    U1 = X1 * Z2Z2 % _Q
    U2 = X2 * Z1Z1 % _Q
    S1 = Y1 * Z2 * Z2Z2 % _Q
    S2 = Y2 * Z1 * Z1Z1 % _Q
    if U1 == U2:
        if S1 != S2:
            return None
        return _jdouble(P)
    H = (U2 - U1) % _Q
    I = 4 * H * H % _Q
    J = H * I % _Q
    r = 2 * (S2 - S1) % _Q
    V = U1 * I % _Q
    X3 = (r * r - J - 2 * V) % _Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % _Q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % _Q * H % _Q
    return (X3, Y3, Z3)


def _jadd_affine(P, A):
    """P jacobian + A affine (madd-2007-bl)."""
    if A is None:
        return P
    X2, Y2 = A
    if P is None:
        return (X2, Y2, 1)
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % _Q
    U2 = X2 * Z1Z1 % _Q
    S2 = Y2 * Z1 * Z1Z1 % _Q
    if U2 == X1:
        if S2 != Y1:
            return None
        return _jdouble(P)
    H = (U2 - X1) % _Q
    HH = H * H % _Q
    I = 4 * HH % _Q
    J = H * I % _Q
    r = 2 * (S2 - Y1) % _Q
    V = X1 * I % _Q
    X3 = (r * r - J - 2 * V) % _Q
    Y3 = (r * (V - X3) - 2 * Y1 * J) % _Q
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % _Q
    return (X3, Y3, Z3)


def _jac_to_affine(P):
    if P is None or P[2] % _Q == 0:
        return None
    X, Y, Z = P
    zi = pow(Z, -1, _Q)
    zi2 = zi * zi % _Q
    return (X * zi2 % _Q, Y * zi2 % _Q * zi % _Q)


def msm_pippenger_jac(scalars: List[int], points: List, c: int = 8):
    """Windowed bucket MSM over host bigints in Jacobian coordinates.

    points: affine (x, y) | None. Returns affine (x, y) | None.
    """
    from .. import params

    nbits = params.R.bit_length()
    windows = (nbits + c - 1) // c
    mask = (1 << c) - 1
    result = None
    for w in range(windows - 1, -1, -1):
        if result is not None:
            for _ in range(c):
                result = _jdouble(result)
        buckets = [None] * (1 << c)
        for k, P in zip(scalars, points):
            digit = (k >> (w * c)) & mask
            if digit and P is not None:
                buckets[digit] = _jadd_affine(buckets[digit], P)
        running, acc = None, None
        for b in range(len(buckets) - 1, 0, -1):
            if buckets[b] is not None:
                running = _jadd(running, buckets[b])
            if running is not None:
                acc = _jadd(acc, running)
        result = _jadd(result, acc)
    return _jac_to_affine(result)


def msm_pippenger(scalars: List[int], points: List, c: int = 8):
    """Windowed bucket method — structurally mirrors the device formulation."""
    from .. import params

    nbits = params.R.bit_length()
    windows = (nbits + c - 1) // c
    result = None
    for w in range(windows - 1, -1, -1):
        if result is not None:
            for _ in range(c):
                result = G1.add(result, result)
        buckets = [None] * (1 << c)
        for k, P in zip(scalars, points):
            digit = (k >> (w * c)) & ((1 << c) - 1)
            if digit and P is not None:
                buckets[digit] = G1.add(buckets[digit], P)
        running, acc = None, None
        for b in range(len(buckets) - 1, 0, -1):
            running = G1.add(running, buckets[b])
            acc = G1.add(acc, running)
        result = G1.add(result, acc)
    return result
