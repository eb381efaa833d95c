"""Batched G1 (BLS12-377) group arithmetic on limbs-last point batches.

Counterpart of the JAX package's `curves/g1.py`. Points are (X, Y, Z)
projective with coordinates as Montgomery limb tensors of shape (..., 24),
limbs last; the identity is (0, 1, 0). The SRS and the MSM table are held in
this form.

The group law is the complete one of Renes-Costello-Batina 2016. The port has
one implementation of it, the limbs-first functions of `curves/g1_fused.py`
(CUDA kernels on the card, their plain versions on the CPU): `add` and
`double` here are limbs-last adapters over `add_lf` / `double_lf` that end in
`normalize_lf`, so they return canonical limbs (< p) as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import params
from ..fields import limb_kernels as lk
from ..fields import limbs
from ..fields.limbs import STORE
from . import g1_affine as ga
from . import g1_fused as gf


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


def identity(shape=(), device=None) -> G1Points:
    device = limbs.resolve_device(device)
    shape = tuple(shape) + (params.FQ_LIMBS,)
    one = lk.get_fq().consts(device)["one"].to(STORE).reshape(-1)
    zero = torch.zeros(shape, dtype=STORE, device=device)
    return G1Points(zero, one.expand(shape).contiguous(), zero.clone())


def _to_lf(p: G1Points) -> gf.G1LF:
    """(..., 24) limbs-last -> (24, N) limbs-first, batch flattened."""
    L = params.FQ_LIMBS
    return gf.G1LF(*(c.reshape(-1, L).T.contiguous() for c in p))


def _from_lf(p: gf.G1LF, batch_shape) -> G1Points:
    L = params.FQ_LIMBS
    return G1Points(*(c.T.reshape(tuple(batch_shape) + (L,)) for c in p))


def add(p: G1Points, q: G1Points) -> G1Points:
    """Complete projective addition (RCB16 Algorithm 7, a=0, b3=3) of two
    batches of one shape; canonical limbs out."""
    r = gf.normalize_lf(gf.add_lf(_to_lf(p), _to_lf(q)))
    return _from_lf(r, p.batch_shape)


def double(p: G1Points) -> G1Points:
    """Complete doubling (RCB16 Algorithm 9, a=0, b3=3); canonical limbs
    out."""
    return _from_lf(gf.normalize_lf(gf.double_lf(_to_lf(p))), p.batch_shape)


def neg(p: G1Points) -> G1Points:
    ring = lk.get_fq()
    y = lk.normalize(ring, lk.neg(ring, p.y.movedim(-1, 0))).movedim(0, -1)
    return G1Points(p.x, y, p.z)


def select(cond, p: G1Points, q: G1Points) -> G1Points:
    """Elementwise select: cond ? p : q, cond shape = batch shape."""
    c = torch.as_tensor(cond, device=p.x.device)[..., None]
    return G1Points(
        torch.where(c, p.x, q.x), torch.where(c, p.y, q.y), torch.where(c, p.z, q.z)
    )


def is_identity(p: G1Points) -> torch.Tensor:
    """Batch-shaped bool: z == 0 (mod p), on lazy or canonical limbs."""
    z = p.z.reshape(-1, params.FQ_LIMBS).T
    return lk.is_zero_mod_p(lk.get_fq(), z).reshape(p.batch_shape)


def scale(k_bits, p: G1Points) -> G1Points:
    """Scalar multiplication by double-and-add; k_bits: MSB-first bits of one
    scalar applied to a batch of points, a host sequence (`scalar_bits`), so
    the loop launches an addition only where a bit is set."""
    acc = identity(p.batch_shape, device=p.x.device)
    for bit in k_bits:
        acc = double(acc)
        if int(bit):
            acc = add(acc, p)
    return acc


def scalar_bits(k: int, nbits: int | None = None) -> list:
    """Host scalar -> MSB-first bit list for scale()."""
    nbits = nbits or params.R.bit_length()
    return [(k >> (nbits - 1 - i)) & 1 for i in range(nbits)]


def decode_points(p: G1Points):
    """Device batch -> host affine [(x, y) | None], batch flattened."""
    return gf.decode_lf(_to_lf(p))


def to_affine(p: G1Points) -> G1Points:
    """Normalize Z to 1 on device (identity maps to (0, 1, 0))."""
    ring = lk.get_fq()
    lf = _to_lf(p)
    ident = lk.is_zero_mod_p(ring, lf.z)                       # (1, N)
    one = ring.consts(lf.z.device)["one"].to(STORE).expand_as(lf.z)
    zero = torch.zeros_like(lf.z)
    zinv = ga.batch_inv_lf(torch.where(ident, one, lf.z)).contiguous()
    x = ga.fq_mul(lf.x, zinv)
    y = ga.fq_mul(lf.y, zinv)
    r = gf.normalize_lf(gf.G1LF(
        torch.where(ident, zero, x), torch.where(ident, one, y),
        torch.where(ident, zero, one),
    ))
    return _from_lf(r, p.batch_shape)
