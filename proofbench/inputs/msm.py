"""Inputs of the ZPrize-shaped MSM: fixed bases and seeded scalar sets.

Bases: the first `distinct` powers of the benchmark's SRS, [tau^j] G, with
base 3 replaced by the identity, tiled until there are `points` of them, as
ZPrize's harness doubles its set of 2^11 random points (point 3 at infinity)
until it is long enough. Their
discrete logarithms are known to the benchmark, which is what its reference
uses. Scalars: 16-bit limbs drawn on the device with a `torch.Generator`
seeded from `--seed`, uniform below r (a draw below 2^253 is kept where it is
below r and drawn again where it is not).
"""

from __future__ import annotations

import torch

from ..reference.field import R

FR_LIMBS = 16
IDENTITY_BASE = 3
_TOP_BITS = R.bit_length() - 16 * (FR_LIMBS - 1)      # 13 bits in the top limb


def _r_limbs(device) -> torch.Tensor:
    return torch.tensor([(R >> (16 * i)) & 0xFFFF for i in range(FR_LIMBS)],
                        dtype=torch.int32, device=device)


def _draw(gen: torch.Generator, rows: int, device) -> torch.Tensor:
    x = torch.randint(0, 1 << 16, (rows, FR_LIMBS), generator=gen, device=device,
                      dtype=torch.int32)
    x[:, -1] &= (1 << _TOP_BITS) - 1
    return x


def _at_least_r(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rows of x (as 16-bit limbs, lowest first) that are >= r."""
    sign = torch.sign(x.to(torch.int64) - r.to(torch.int64))
    weight = 3 ** torch.arange(FR_LIMBS, dtype=torch.int64, device=x.device)
    return (sign * weight).sum(dim=1) >= 0


def scalar_sets(seed: int, sets: int, points: int, device) -> torch.Tensor:
    """(sets, points, 16) int32 limbs, each value uniform in [0, r); drawn a
    set at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    r = _r_limbs(device)
    out = torch.empty((sets, points, FR_LIMBS), dtype=torch.int32, device=device)
    for s in range(sets):
        x = _draw(gen, points, device)
        bad = torch.nonzero(_at_least_r(x, r)).flatten()
        while bad.numel():
            fresh = _draw(gen, bad.numel(), device)
            x[bad] = fresh
            bad = bad[_at_least_r(fresh, r)]
        out[s] = x
    return out
