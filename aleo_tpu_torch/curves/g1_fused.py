"""Limbs-first projective G1 batches, as far as this slice needs.

Counterpart of the JAX package's `curves/g1_fused.py` for its container and
converters: `G1LF` is what the MSM hands to the host window combine. The
projective add/double kernels of that module belong to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import params
from ..fields import limb_kernels as lk
from ..fields import limbs


class G1LF(NamedTuple):
    """Projective G1 batch, limbs-first: three (24, M) int32 tensors of
    Montgomery limbs (lazy < 2p allowed); z = 0 marks the identity."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def from_points(p) -> G1LF:
    """curves.g1.G1Points (N, 24) limbs-last -> G1LF (24, N)."""
    return G1LF(p.x.T, p.y.T, p.z.T)


def decode_lf(p: G1LF):
    """Device batch (possibly lazy) -> host affine [(x, y) | None]. The
    three coordinate planes come back in one device->host transfer."""
    Q = params.Q
    ring = lk.get_fq()
    L = p.x.shape[0]
    all3 = limbs.to_numpy(
        torch.cat([lk.normalize(ring, c.contiguous()) for c in p], dim=0)
    )
    xs = limbs.from_mont_host(all3[:L].T, Q)
    ys = limbs.from_mont_host(all3[L : 2 * L].T, Q)
    zs = limbs.from_mont_host(all3[2 * L :].T, Q)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out
