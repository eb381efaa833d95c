"""The Fiat-Shamir transcript of the proofs under judgement: a rate-2 Poseidon
sponge in the domain "aleo-tpu-fs/<name>". An Fq coordinate is absorbed as two
Fr elements (its low 188 bits, then the rest); a G1 point as x, y and a 0, the
identity as (0, 0, 1)."""

from __future__ import annotations

from .field import R
from .poseidon import PoseidonSponge

_SPLIT = 188


class Transcript:
    def __init__(self, domain: str):
        self.sponge = PoseidonSponge(2, domain=f"aleo-tpu-fs/{domain}")

    def absorb_fr(self, *vals: int) -> None:
        self.sponge.absorb([v % R for v in vals])

    def absorb_point(self, p) -> None:
        if p is None:
            self.absorb_fr(0, 0, 1)
            return
        for c in p:
            self.sponge.absorb([c & ((1 << _SPLIT) - 1), c >> _SPLIT])
        self.absorb_fr(0)

    def challenges(self, k: int):
        return self.sponge.squeeze(k)

    def challenge(self) -> int:
        return self.sponge.squeeze(1)[0]
