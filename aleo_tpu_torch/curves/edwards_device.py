"""Batched Edwards-BLS12 ops on the device (record-scan acceleration).

Counterpart of the JAX package's `curves/edwards_device.py`. The view-key
record scan (`is_owner_with_address_x_coordinate`,
`upstream:rust/src/api/blocking.rs:275`) is one ECDH per ciphertext:
shared_i = view_scalar * eph_i over Edwards-BLS12. Coordinates live in Fr,
so the group law runs on the limbs-first Fr arithmetic (`fields/fr_lf.py`):
batched unified twisted-Edwards addition (a = -1), and one double-and-add
ladder over the scalar's bits for the whole ciphertext batch at once.

The ladder is a host loop over the bits, MSB first; each step doubles, adds
the point and keeps the sum under a select on the bit (a device tensor), so
the loop does the same work for every bit, as the reference's `lax.scan`
does. Each unified addition inverts its two denominators with
`fr_lf.batch_inv`, one host readback each. The host oracle
(`reference/edwards.py`) stays the correctness reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import params
from ..fields import fr_lf as lf
from ..fields import limbs
from ..reference import edwards

D = params.EDWARDS_D


def encode_points(pts, device=None) -> tuple:
    """Host affine [(x, y)] -> ((L, N), (L, N)) Montgomery limbs-first."""
    device = limbs.resolve_device(device)
    xs = lf.encode([p[0] for p in pts], device=device)
    ys = lf.encode([p[1] for p in pts], device=device)
    return xs, ys


def decode_points(xy) -> list:
    xs = lf.decode(xy[0])
    ys = lf.decode(xy[1])
    return [(int(x), int(y)) for x, y in zip(xs, ys)]


def _unified_add(P, Q):
    """Unified twisted-Edwards addition (complete for a = -1, d non-square):
    x3 = (x1 y2 + y1 x2) / (1 + d x1 x2 y1 y2),
    y3 = (y1 y2 + x1 x2) / (1 - d x1 x2 y1 y2)   [a = -1]."""
    x1, y1 = P
    x2, y2 = Q
    x1x2 = lf.mul(x1, x2)
    y1y2 = lf.mul(y1, y2)
    x1y2 = lf.mul(x1, y2)
    y1x2 = lf.mul(y1, x2)
    t = lf.mul(x1x2, y1y2)
    n, dev = t.shape[1], t.device
    dt = lf.mul(t, lf.const(D, n, device=dev))
    one = lf.one(n, device=dev)
    inv_x = lf.batch_inv(lf.add(one, dt))
    inv_y = lf.batch_inv(lf.sub(one, dt))
    x3 = lf.mul(lf.add(x1y2, y1x2), inv_x)
    y3 = lf.mul(lf.add(y1y2, x1x2), inv_y)
    return (x3, y3)


def scalar_mul_batch(scalar_bits: Sequence[int], xs: torch.Tensor, ys: torch.Tensor):
    """[k]P_i for one shared scalar over a point batch, canonical out.

    scalar_bits: the scalar's bits, MSB first (a host sequence); xs/ys:
    (L, N) Montgomery, on any device.
    """
    n, dev = xs.shape[1], xs.device
    bits = torch.as_tensor([bool(b) for b in scalar_bits], device=dev)
    acc = (lf.zero(n, device=dev), lf.one(n, device=dev))
    for i in range(bits.shape[0]):
        acc = _unified_add(acc, acc)                      # double
        with_add = _unified_add(acc, (xs, ys))
        acc = (torch.where(bits[i], with_add[0], acc[0]),
               torch.where(bits[i], with_add[1], acc[1]))
    return lf.normalize(acc[0]), lf.normalize(acc[1])


def shared_secrets(view_scalar: int, eph_points, device=None) -> list:
    """ECDH batch: [(x, y)] host ephemeral points -> [(x, y)] shared points.

    The device path for RecordCiphertext.is_owner/decrypt over many records
    (the reverse-scan hot loop, blocking.rs:261-318).

    Only points on the curve go into the ladder: there the law is complete,
    so no denominator of `_unified_add` is zero. A point off the curve (a
    ciphertext's `eph` arrives unchecked) can make one zero, and
    `fr_lf.batch_inv` would then zero the whole row, every lane of the
    batch. Each such lane gets the host `reference.edwards.mul` instead, the
    value the per-record host scan gives it, so lane for lane the result
    equals the host path.
    """
    device = limbs.resolve_device(device)
    out, on = [], []
    for i, p in enumerate(eph_points):
        if edwards.is_on_curve(p):
            on.append(i)
            out.append(None)
        else:
            out.append(edwards.mul(view_scalar, p))
    if on:
        nbits = max(1, view_scalar.bit_length())
        bits = [(view_scalar >> (nbits - 1 - i)) & 1 for i in range(nbits)]
        xs, ys = encode_points([eph_points[i] for i in on], device=device)
        for i, pt in zip(on, decode_points(scalar_mul_batch(bits, xs, ys))):
            out[i] = pt
    return out
