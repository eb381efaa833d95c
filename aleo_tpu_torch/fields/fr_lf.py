"""Limbs-first Fr field ops: the device API of the prover pipeline.

Layout: a field-element batch is an (L, N) int32 tensor of 16-bit limbs,
little-endian on axis 0, Montgomery form (radix 2^256). Every op here is
plain PyTorch on the plain limb arithmetic of `fields.limb_kernels`, on
whichever device the operands lie. Values between ops are lazy (< 2r);
`normalize`/`decode` give canonical values.

Batch axes. Every op also takes (L, ..., N) tensors: axis 0 is the limbs,
the LAST axis is the lanes, and any axes between are batch axes (the proof
axis of the batch prover, `snark/batch.py`, which holds k proofs as
(L, k, N)). The elementwise ops are lane-wise and broadcast over them; the
ops that run ALONG the lanes (`scan_mul`, `batch_inv`, `tree_sum`, `powers`)
index the last axis, so each batch row is scanned, inverted, summed or
raised on its own, in the same launches as a single row. This is where the
reference lifts its functions with `jax.vmap`.

Counterpart of the JAX package's `fields/fr_lf.py` (plain XLA there, plain
torch here); functions that create tensors take an explicit `device`.
"""

from __future__ import annotations

import torch

from .. import params
from . import limb_kernels as lk
from . import limbs
from .limbs import STORE

R = params.R
L = params.FR_LIMBS


def _ring():
    return lk.get_fr()


# -- core ring ops -----------------------------------------------------------


def mul(a, b):
    return lk.mont_mul(_ring(), a, b)


def sq(a):
    return mul(a, a)


def add(a, b):
    return lk.add(_ring(), a, b)


def sub(a, b):
    return lk.sub(_ring(), a, b)


def neg(a):
    return lk.neg(_ring(), a)


def normalize(a):
    """Reduce lazy (< 2r) values to canonical (< r)."""
    return lk.normalize(_ring(), a)


def select(cond, a, b):
    """cond: (N,) bool -> per-lane select."""
    return torch.where(cond, a, b)


def from_mont(a):
    """Montgomery -> standard-form limbs (for MSM scalar digits).

    May return lazy (< 2r) values; safe for MSM scalars because the G1 group
    order is r (k + r acts as k) and the digit decomposition covers 254 bits.
    """
    one_raw = torch.zeros((L, 1), dtype=STORE, device=a.device)
    one_raw[0, 0] = 1
    return mul(a, one_raw)


# -- composites ----------------------------------------------------------------


def scan_mul(a, reverse: bool = False):
    """Inclusive prefix product along the lane axis (Hillis-Steele)."""
    n = a.shape[-1]
    o = 1
    while o < n:
        if reverse:
            head = mul(a[..., : n - o], a[..., o:])
            a = torch.cat([head, a[..., n - o :]], dim=-1)
        else:
            tail = mul(a[..., o:], a[..., : n - o])
            a = torch.cat([a[..., :o], tail], dim=-1)
        o *= 2
    return a


def inv(a):
    """Elementwise inverse, inv(0) = 0. The reference runs a 253-step Fermat
    scan on the device; the value is its a^(r-2), which is taken here on host
    integers (this is only ever called on a handful of lanes)."""
    xs = decode(a.reshape(L, -1))
    return encode([pow(int(x), R - 2, R) for x in xs], device=a.device).reshape(a.shape)


def batch_inv(a):
    """Batched inversion along lanes (prefix/suffix products + one
    inversion for each batch row, all rows' totals inverted after one
    readback). A zero entry makes its whole row zero, as in the
    reference."""
    n = a.shape[-1]
    if n == 1:
        return inv(a)
    pre = scan_mul(a)
    suf = scan_mul(a, reverse=True)
    total_inv = inv(pre[..., -1:])
    o = one(1, device=a.device).reshape((L,) + (1,) * (a.dim() - 1)).expand(a.shape[:-1] + (1,))
    pre_shift = torch.cat([o, pre[..., :-1]], dim=-1)
    suf_shift = torch.cat([suf[..., 1:], o], dim=-1)
    return mul(mul(pre_shift, suf_shift), total_inv)


def tree_sum(x):
    """Field-add reduction along lanes -> (L, ..., 1)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        s = add(x[..., :half], x[..., half : 2 * half])
        x = torch.cat([s, x[..., 2 * half :]], dim=-1) if n % 2 else s
    return x


def powers(z, n: int):
    """[z^0 .. z^(n-1)] as (L, ..., n); z: (L, ..., 1)."""
    out = one(1, device=z.device).reshape((L,) + (1,) * (z.dim() - 1)).expand(z.shape)
    zp = z
    while out.shape[-1] < n:
        # out holds z^0..z^(k-1) and zp = z^k: append zp * out
        out = torch.cat([out, mul(out, zp)], dim=-1)
        zp = sq(zp)
    return out[..., :n].contiguous()


# -- host <-> device -----------------------------------------------------------


def const(x: int, n: int = 1, device=None):
    """Host int -> (L, n) Montgomery limbs."""
    device = limbs.resolve_device(device)
    row = limbs.to_mont_host([x % R], R, L)[0]
    return limbs.to_tensor(row[:, None], device).expand(L, n)


def encode(xs, device=None) -> torch.Tensor:
    """Host ints -> (L, N) Montgomery limbs."""
    device = limbs.resolve_device(device)
    return limbs.to_tensor(limbs.to_mont_host(list(xs), R, L).T, device)


def decode(a) -> list:
    """(L, N) device limbs (lazy ok) -> host ints (exact, canonical)."""
    arr = limbs.to_numpy(normalize(a)).T
    return limbs.from_mont_host(arr, R)


def one(n: int, device=None) -> torch.Tensor:
    device = limbs.resolve_device(device)
    return limbs.to_tensor(_ring().one_mont[:, None], device).expand(L, n)


def zero(n: int, device=None) -> torch.Tensor:
    device = limbs.resolve_device(device)
    return torch.zeros((L, n), dtype=STORE, device=device)


# Layout converters at module boundaries.


def from_ll(a: torch.Tensor) -> torch.Tensor:
    """(N, L) limbs-last -> (L, N) limbs-first."""
    return a.T


def to_ll(a: torch.Tensor) -> torch.Tensor:
    """(L, N) limbs-first -> (N, L) limbs-last."""
    return a.T
