"""The expected result of an MSM whose bases have known discrete logarithms.

With base i = [b_i] G, sum_i s_i [b_i] G = [sum_i s_i b_i mod r] G: one
scalar multiplication on the host after a dot product of integers. The bases
are `distinct` points tiled, so the scalars of all copies of base j are summed
first (limb sums in int64, exact below 2^31 copies), in plain PyTorch.
"""

from __future__ import annotations

from typing import List

import torch

from . import curve
from .field import R


def class_sums(scalars: torch.Tensor, distinct: int) -> List[List[int]]:
    """(sets, points, 16) limbs -> per set, per base j < distinct, the sum of
    the scalars that multiply a copy of base j."""
    sets, points, limbs = scalars.shape
    sums = scalars.reshape(sets, points // distinct, distinct, limbs).to(torch.int64).sum(1)
    return [[sum(v << (16 * i) for i, v in enumerate(row)) for row in per_set]
            for per_set in sums.cpu().tolist()]


def expected(sums: List[int], logs: List[int]):
    """[sum_j sums[j] * logs[j] mod r] G as an affine host point."""
    return curve.mul(sum(s * b for s, b in zip(sums, logs)) % R, curve.generator())
