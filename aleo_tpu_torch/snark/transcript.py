"""Poseidon-based Fiat-Shamir transcript (host side).

Mirrors the role of snarkVM's Poseidon-sponge Fiat-Shamir inside the Varuna
prover (SURVEY.md §2.8 item 6, "hard parts" item 3). The transcript runs on
the host between device rounds: absorbed data are commitments (G1 affine
points over Fq) and Fr elements; Fq coordinates are absorbed as two Fr
elements (low/high 188/189-bit split) so the sponge stays native to Fr.
"""

from __future__ import annotations

from .. import params
from ..reference.poseidon import PoseidonSponge

R = params.R
_SPLIT = 188  # bits per low chunk when packing Fq coords into Fr


class Transcript:
    def __init__(self, domain: str):
        self.sponge = PoseidonSponge(2, domain=f"aleo-tpu-fs/{domain}")

    def absorb_fr(self, *vals: int) -> None:
        self.sponge.absorb([v % R for v in vals])

    def absorb_fq(self, v: int) -> None:
        self.sponge.absorb([v & ((1 << _SPLIT) - 1), v >> _SPLIT])

    def absorb_point(self, p) -> None:
        """Absorb a host affine G1 point (None = identity)."""
        if p is None:
            self.absorb_fr(0, 0, 1)
        else:
            self.absorb_fq(p[0])
            self.absorb_fq(p[1])
            self.absorb_fr(0)

    def absorb_points(self, pts) -> None:
        for p in pts:
            self.absorb_point(p)

    def challenge(self) -> int:
        return self.sponge.squeeze(1)[0]

    def challenges(self, k: int):
        return self.sponge.squeeze(k)
