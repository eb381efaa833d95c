"""Poseidon over Fr (rates 2, 4, 8; alpha 17, 8 full and 31 partial rounds),
with constants from the Grain LFSR of arkworks' `find_poseidon_ark_and_mds`.

A frozen copy of the host algorithm, so that the reference shares no code with
the program: the sponge starts at zero and absorbs [domain, length] ++ inputs
into its rate section (capacity at index 0), as snarkVM's `hash_many` does.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from .field import R


ALPHA = 17
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 31
PRIME_BITS = R.bit_length()  # 253


class _GrainLFSR:
    """The 80-bit Grain LFSR of arkworks' `PoseidonGrainLFSR`.

    Seeding layout and update rule follow the arkworks implementation
    (ark-crypto-primitives `poseidon/grain_lfsr.rs`, a port of the Poseidon
    paper's generate_parameters_grain.sage) bit-for-bit: seeded big-endian
    with 0b01, 0b0000, the prime's bits (12), t (12), R_F (10), R_P (10) and
    30 ones; 160 updates discarded; output bits von-Neumann filtered.
    """

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int,
                 sbox_inverse: bool = False):
        bits = []

        def push(value: int, width: int):
            for i in range(width - 1, -1, -1):
                bits.append((value >> i) & 1)

        push(1, 2)                    # prime field marker (0b01)
        push(1 if sbox_inverse else 0, 4)
        push(field_bits, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        push((1 << 30) - 1, 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_bit_raw()

    def _next_bit_raw(self) -> int:
        s = self.state
        b = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [b]
        return b

    def next_bit(self) -> int:
        # von Neumann filtering: emit the second bit of a pair iff the
        # first is 1 (arkworks get_bits)
        while True:
            b1 = self._next_bit_raw()
            b2 = self._next_bit_raw()
            if b1 == 1:
                return b2

    def _raw_element(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.next_bit()   # MSB-first
        return v

    def field_element_rejection(self, modulus: int, nbits: int) -> int:
        """arkworks get_field_elements_rejection_sampling (ARK rows)."""
        while True:
            v = self._raw_element(nbits)
            if v < modulus:
                return v

    def field_element_mod_p(self, modulus: int, nbits: int) -> int:
        """arkworks get_field_elements_mod_p (MDS xs/ys)."""
        return self._raw_element(nbits) % modulus


def find_poseidon_ark_and_mds(
    prime_bits: int, rate: int, r_f: int, r_p: int, skip_matrices: int = 0,
    modulus: int = R,
) -> Tuple[List[List[int]], List[List[int]]]:
    """Exact twin of arkworks `find_poseidon_ark_and_mds` (the generator
    snarkVM's Poseidon constants come from). capacity = 1, t = rate + 1."""
    t = rate + 1
    lfsr = _GrainLFSR(prime_bits, t, r_f, r_p)
    ark = [
        [lfsr.field_element_rejection(modulus, prime_bits) for _ in range(t)]
        for _ in range(r_f + r_p)
    ]
    for _ in range(skip_matrices):
        for _ in range(2 * t):
            lfsr.field_element_mod_p(modulus, prime_bits)
    xs = [lfsr.field_element_mod_p(modulus, prime_bits) for _ in range(t)]
    ys = [lfsr.field_element_mod_p(modulus, prime_bits) for _ in range(t)]
    mds = [
        [pow((xs[i] + ys[j]) % modulus, -1, modulus) for j in range(t)]
        for i in range(t)
    ]
    return ark, mds


class PoseidonParams:
    def __init__(self, rate: int, ark: List[List[int]], mds: List[List[int]]):
        self.rate = rate
        self.t = rate + 1
        self.alpha = ALPHA
        self.full_rounds = FULL_ROUNDS
        self.partial_rounds = PARTIAL_ROUNDS
        self.ark = ark  # (R_F + R_P) x t round constants
        self.mds = mds  # t x t MDS matrix

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def standard(rate: int) -> "PoseidonParams":
        ark, mds = find_poseidon_ark_and_mds(
            PRIME_BITS, rate, FULL_ROUNDS, PARTIAL_ROUNDS, skip_matrices=0
        )
        return PoseidonParams(rate, ark, mds)


def permute(state: List[int], p: PoseidonParams) -> List[int]:
    """ARK -> S-box (all lanes in full rounds, lane 0 in partial) -> MDS,
    with new[i] = sum_j mds[i][j] * s[j] (arkworks apply_mds orientation)."""
    t = p.t
    assert len(state) == t
    s = [x % R for x in state]
    half = p.full_rounds // 2
    total = p.full_rounds + p.partial_rounds
    for rnd in range(total):
        s = [(s[i] + p.ark[rnd][i]) % R for i in range(t)]
        if rnd < half or rnd >= half + p.partial_rounds:
            s = [pow(x, ALPHA, R) for x in s]
        else:
            s[0] = pow(s[0], ALPHA, R)
        s = [sum(p.mds[i][j] * s[j] for j in range(t)) % R for i in range(t)]
    return s


def domain_fe(domain: str) -> int:
    """Map a domain-separator string to an Fr element (little-endian bytes —
    snarkVM's Field::new_domain_separator convention)."""
    return int.from_bytes(domain.encode()[:31], "little") % R


class PoseidonSponge:
    """Additive duplex sponge, capacity 1 at state index 0.

    snarkVM convention: the state starts at zero; domain separation happens
    by absorbing the domain element as the first rate element (hash_psd
    below), not by writing the capacity slot.
    """

    def __init__(self, rate: int, domain: str = ""):
        self.p = PoseidonParams.standard(rate)
        self.rate = rate
        self.state = [0] * self.p.t
        self.pos = 0          # next absorb slot within the rate section
        self.squeeze_pos = rate  # force permutation on first squeeze
        if domain:
            self.absorb([domain_fe(domain)])

    def absorb(self, elements) -> None:
        for e in elements:
            if self.pos == self.rate:
                self.state = permute(self.state, self.p)
                self.pos = 0
            self.state[1 + self.pos] = (self.state[1 + self.pos] + e) % R
            self.pos += 1
        self.squeeze_pos = self.rate  # invalidate pending squeeze output

    def squeeze(self, n: int) -> List[int]:
        out = []
        for _ in range(n):
            if self.squeeze_pos == self.rate:
                self.state = permute(self.state, self.p)
                self.pos = 0
                self.squeeze_pos = 0
            out.append(self.state[1 + self.squeeze_pos])
            self.squeeze_pos += 1
        return out


def hash_psd(rate: int, inputs: List[int], domain: str = "AleoPoseidon") -> int:
    """hash_psd{2,4,8} analogue: absorb [domain, len] ++ inputs into a
    zero-initialized sponge, squeeze one element.

    snarkVM's hash_many prepends the setup domain and the input length to
    the absorbed preimage.
    """
    sp = PoseidonSponge(rate)
    sp.absorb([domain_fe(f"{domain}{rate}"), len(inputs)])
    sp.absorb(inputs)
    return sp.squeeze(1)[0]
