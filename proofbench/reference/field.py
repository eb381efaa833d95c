"""BLS12-377 constants and field helpers for the benchmark's plain reference.

A frozen copy of the published parameters (the curve's scalar field Fr, base
field Fq, the G1 and G2 generators and the two-adic root of Fr), so that the
reference shares no code with the program it judges.
"""

from __future__ import annotations

from typing import List

Q = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001

FR_TWO_ADICITY = 47
FR_GENERATOR = 22
FR_TWO_ADIC_ROOT = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

G1_B = 1
G1_GEN = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)
FQ2_NONRESIDUE = Q - 5
G2_B = (0, Q - pow(5, Q - 2, Q))
G2_GEN = (
    (233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
     140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118),
    (63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
     149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491),
)


def root_of_unity(order: int) -> int:
    """Primitive root of unity of a power-of-two order in Fr."""
    log = order.bit_length() - 1
    assert order == 1 << log and log <= FR_TWO_ADICITY
    return pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log), R)


def batch_inverse(xs: List[int], p: int = R) -> List[int]:
    """Inverses of nonzero field elements with one exponentiation."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % p
    inv = pow(acc, p - 2, p)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * xs[i] % p
    return out


def _nonresidue(p: int) -> int:
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return z


_Q_NONRESIDUE = _nonresidue(Q)


def sqrt_q(a: int) -> int:
    """A square root of a in Fq (Tonelli-Shanks); raises where there is none."""
    a %= Q
    if a == 0:
        return 0
    if pow(a, (Q - 1) // 2, Q) != 1:
        raise ValueError("not a square in Fq")
    odd, s = Q - 1, 0
    while odd % 2 == 0:
        odd //= 2
        s += 1
    m, c = s, pow(_Q_NONRESIDUE, odd, Q)
    t, r = pow(a, odd, Q), pow(a, (odd + 1) // 2, Q)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % Q
            i += 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        t, r = t * c % Q, r * b % Q
    return r
