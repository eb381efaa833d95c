"""Batched G1 (BLS12-377) points on the device, as far as this slice needs.

Counterpart of the JAX package's `curves/g1.py`: the container and the host
encoding that the SRS and the MSM table use. Points are (X, Y, Z) projective
with coordinates as Montgomery limb tensors of shape (N, 24), limbs last;
the identity is (0, 1, 0). The projective group law itself is not part of
this slice (the MSM accumulates in affine form, curves/g1_affine.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import params
from ..fields import limbs


class G1Points(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


def encode_points(pts: Sequence, device=None) -> G1Points:
    """Host affine points [(x, y) | None] -> device batch (z in {0, 1})."""
    device = limbs.resolve_device(device)
    xs, ys, zs = [], [], []
    for p in pts:
        if p is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            zs.append(1)
    Q, L = params.Q, params.FQ_LIMBS
    return G1Points(*(
        limbs.to_tensor(limbs.to_mont_host(v, Q, L), device) for v in (xs, ys, zs)
    ))
