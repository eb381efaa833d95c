"""Limbs-last Montgomery arithmetic mod a fixed prime: the `ModRing` API.

Counterpart of the JAX package's `fields/modring.py`, with the same public
surface and the same values. A field element is a little-endian vector of
16-bit limbs, shape (..., L) with the limbs LAST (Fq: L = 24, Fr: L = 16),
stored as int32 (the reference stores uint32; limbs are < 2^16, so only the
dtype differs), in Montgomery form with the radix 2^(16 L).

The port has one limb arithmetic, the limbs-first functions of
`fields/limb_kernels.py`; every op here is an adapter over them, as
`curves/g1.py` adapts `add_lf`: the operands are broadcast, the limb axis is
moved to the front, the op runs, and the axis is moved back. The limb
products there are lazy (< 2p), so every public op ends in a normalize and
returns canonical limbs (< p), bit for bit the reference's on canonical
inputs. Ops run on whichever device their operands lie; constants follow
the operand's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import params
from . import limb_kernels as lk
from . import limbs
from .limbs import LIMB_BITS


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Host int -> (L,) int32 limbs."""
    return limbs.int_to_limbs(x, n_limbs)


def ints_to_limbs(xs: Sequence[int], n_limbs: int) -> np.ndarray:
    """List of ints -> (N, L) int32 limbs."""
    return limbs.ints_to_limbs(xs, n_limbs)


def limbs_to_ints(a) -> np.ndarray:
    """(..., L) host limbs -> object array of python ints, shape (...)."""
    a = np.asarray(a)
    out = np.empty(int(np.prod(a.shape[:-1], dtype=np.int64)), dtype=object)
    out[:] = limbs.limbs_to_ints(a.reshape(-1, a.shape[-1]))
    return out.reshape(a.shape[:-1])


class ModRing:
    """Montgomery arithmetic mod a fixed prime on (..., L) limbs-last
    tensors, broadcasting over the leading axes."""

    def __init__(self, p: int, n_limbs: int, name: str):
        self.p = p
        self.L = n_limbs
        self.name = name
        self.R_mont = 1 << (LIMB_BITS * n_limbs)
        self.R_mod = self.R_mont % p
        self.R2 = (self.R_mont * self.R_mont) % p
        self.nprime = (-pow(p, -1, self.R_mont)) % self.R_mont
        self.limb_ring = lk.LimbRing(p, n_limbs, name)

        # host constants, (L,) int32; `_dev` holds their copies per device
        self.p_limbs = int_to_limbs(p, n_limbs)
        self.np_limbs = int_to_limbs(self.nprime, n_limbs)
        self.r2_limbs = int_to_limbs(self.R2, n_limbs)
        self.one_mont = int_to_limbs(self.R_mod, n_limbs)
        self.zero = np.zeros(n_limbs, dtype=np.int32)
        self._one_raw = int_to_limbs(1, n_limbs)
        # bits of p - 2, MSB first, for Fermat inversion
        self._inv_exp_bits = [int(b) for b in bin(p - 2)[2:]]
        self._dev = {}

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = limbs.to_tensor(getattr(self, name), device)
        return self._dev[key]

    # -- host <-> device ----------------------------------------------------

    def to_mont_host(self, xs: Sequence[int]) -> np.ndarray:
        return limbs.to_mont_host([int(x) for x in xs], self.p, self.L)

    def from_mont_host(self, a):
        """(..., L) canonical Montgomery limbs -> object array of ints of
        shape (...), or one int for an (L,) array."""
        a = np.asarray(a)
        rinv = pow(self.R_mod, -1, self.p)
        ints = limbs_to_ints(a)
        out = np.empty(ints.size, dtype=object)
        out[:] = [v * rinv % self.p for v in ints.reshape(-1)]
        return out.reshape(ints.shape) if ints.ndim else out[0]

    def encode(self, xs: Sequence[int], device=None) -> torch.Tensor:
        """Host ints -> (N, L) Montgomery limbs on `device`."""
        device = limbs.resolve_device(device)
        return limbs.to_tensor(self.to_mont_host(xs), device)

    def decode(self, a):
        """Montgomery limbs -> host ints: an (N, L) tensor gives an object
        array of N ints, an (L,) tensor one int."""
        return self.from_mont_host(limbs.to_numpy(a))

    def const(self, x: int, device=None) -> torch.Tensor:
        """One constant in Montgomery form, shape (L,)."""
        device = limbs.resolve_device(device)
        return limbs.to_tensor(self.to_mont_host([x])[0], device)

    # -- the adapter --------------------------------------------------------

    def _apply(self, fn, *xs):
        """Broadcast, move the limb axis to the front, run the limbs-first
        op, normalize, move the axis back."""
        xs = torch.broadcast_tensors(*xs) if len(xs) > 1 else xs
        ring = self.limb_ring
        out = lk.normalize(ring, fn(ring, *(x.movedim(-1, 0) for x in xs)))
        return out.movedim(0, -1).contiguous()

    # -- ring ops -------------------------------------------------------------

    def add(self, a, b):
        return self._apply(lk.add, a, b)

    def sub(self, a, b):
        return self._apply(lk.sub, a, b)

    def neg(self, a):
        return self._apply(lk.neg, a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod p (Montgomery in and out)."""
        return self._apply(lk.mont_mul, a, b)

    def sq(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        """Multiply by a small host constant by repeated addition."""
        acc = torch.zeros_like(a)
        base = a
        while k:
            if k & 1:
                acc = self.add(acc, base)
            k >>= 1
            if k:
                base = self.add(base, base)
        return acc

    def pow_fixed(self, a, e: int):
        """a^e for a host exponent (square-and-multiply, MSB first)."""
        assert e >= 1
        acc = a
        for bit in bin(e)[3:]:
            acc = self.sq(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inversion a^(p-2) on the device: a fixed square-and-multiply
        over the bits of p - 2, MSB first, on every lane at once. inv(0) = 0."""
        acc = self._const("one_mont", a.device).expand_as(a)
        for bit in self._inv_exp_bits:
            acc = self.sq(acc)
            if bit:
                acc = self.mul(acc, a)
        return acc

    def scan_mul(self, a, reverse: bool = False):
        """Inclusive prefix product along axis 0 (Hillis-Steele); suffix
        products with reverse."""
        n = a.shape[0]
        o = 1
        while o < n:
            if reverse:
                a = torch.cat([self.mul(a[: n - o], a[o:]), a[n - o :]], dim=0)
            else:
                a = torch.cat([a[:o], self.mul(a[o:], a[: n - o])], dim=0)
            o *= 2
        return a

    def batch_inv(self, a):
        """Batched inversion along axis 0: prefix and suffix products and one
        Fermat inversion of the total. A zero entry makes every output zero,
        as in the reference."""
        if a.shape[0] == 1:
            return self.inv(a)
        pre = self.scan_mul(a)
        suf = self.scan_mul(a, reverse=True)
        total_inv = self.inv(pre[-1:])
        one = self._const("one_mont", a.device).expand_as(a[:1])
        pre_shift = torch.cat([one, pre[:-1]], dim=0)
        suf_shift = torch.cat([suf[1:], one], dim=0)
        return self.mul(self.mul(pre_shift, suf_shift), total_inv)

    # -- form conversions on the device ---------------------------------------

    def to_mont(self, a_raw):
        return self.mul(a_raw, self._const("r2_limbs", a_raw.device))

    def from_mont(self, a):
        return self.mul(a, self._const("_one_raw", a.device))

    def eq(self, a, b):
        return torch.all(a == b, dim=-1)

    def is_zero(self, a):
        return torch.all(a == 0, dim=-1)

    def select(self, cond, a, b):
        """cond: (...,) bool; a, b: (..., L)."""
        return torch.where(cond[..., None], a, b)


FQ_RING = ModRing(params.Q, params.FQ_LIMBS, "Fq")
FR_RING = ModRing(params.R, params.FR_LIMBS, "Fr")
