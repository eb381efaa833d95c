"""Limbs-first modular arithmetic in plain PyTorch, for Fq and Fr.

Counterpart of the JAX package's `fields/limb_kernels.py`: the same
functions with the same lazy-reduction discipline, written directly for
int64 tensors instead of through shift/concatenate blocks.

Numeric discipline ("lazy reduction"):
  * canonical inputs are < p; values between ops are kept < 2p,
  * Montgomery mul accepts operands < 2p and returns < 2p (valid because
    4 p^2 <= R p for BLS12-377 Fq (R = 2^384) and Fr (R = 2^256)),
  * add/sub renormalize to < 2p with one conditional subtract of 2p,
  * `normalize` produces canonical < p values at batch boundaries.

Every public function takes and returns STORE (int32) tensors of shape
(L, ...) on any device; constants follow the operand's device. Operands
broadcast with the limb axis held in place: (L, n) against (L, k, n) is read
as (L, 1, n). Inside, the
work is int64 on a flattened (rows, M) view:

  * a product's columns are accumulated without carries (terms < 2^32, a
    column sums at most L of them); the two constant products of the
    Montgomery reduction are float64 matmuls against Toeplitz matrices of
    N' and p (sums stay < 2^53, so float64 is exact);
  * carries are resolved without a loop over limbs: the generate and
    propagate bits of a lane are packed into one int64 each and a single
    integer addition ripples them (K <= 48 rows fit the word).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import params
from .limbs import LIMB_BITS, MASK, STORE, WORK, int_to_limbs


@dataclasses.dataclass(frozen=True)
class LimbRing:
    """Constants of one prime, in limbs-first form, cached per device."""

    p: int
    L: int
    name: str

    def __post_init__(self):
        L, p = self.L, self.p
        R = 1 << (LIMB_BITS * L)
        assert 4 * p <= R, "lazy-reduction bound needs 4p <= R"
        object.__setattr__(self, "R", R)
        object.__setattr__(self, "nprime", (-pow(p, -1, R)) % R)
        first = (np.arange(L) == 0).astype(np.int64)
        p_l = int_to_limbs(p, L).astype(np.int64)
        p2_l = int_to_limbs(2 * p, L).astype(np.int64)
        rows = {
            "p": p_l,
            # borrow-free complement rows: adding `comp2p - b` limbwise
            # computes 2p - b + R (the +R exits as the dropped carry).
            "comp2p": p2_l + MASK + first,
            # v + compR2p = v - 2p + R: carry-out at the top <=> v >= 2p.
            "compR2p": (MASK - p2_l) + first,
            "compRp": (MASK - p_l) + first,
        }
        object.__setattr__(self, "rows", rows)
        object.__setattr__(self, "one_mont", int_to_limbs(R % p, L))
        object.__setattr__(self, "_dev", {})

    def consts(self, device) -> dict:
        """Constant tensors on `device` (made once per device)."""
        key = str(device)
        if key not in self._dev:
            L = self.L
            c = {
                k: torch.from_numpy(v.reshape(L, 1)).to(device)
                for k, v in self.rows.items()
            }
            np_l = int_to_limbs(self.nprime, L).astype(np.float64)
            p_l = self.rows["p"].astype(np.float64)
            t_np = np.zeros((L, L))          # (t * N') mod R: low L columns
            t_p = np.zeros((2 * L, L))       # m * p: all 2L columns
            for i in range(L):
                for j in range(L):
                    if i + j < L:
                        t_np[i + j, j] = np_l[i]
                    t_p[i + j, j] = p_l[i]
            c["toep_np"] = torch.from_numpy(t_np).to(device)
            c["toep_p"] = torch.from_numpy(t_p).to(device)
            c["shifts"] = torch.arange(2 * L + 1, dtype=WORK, device=device)[:, None]
            c["weights"] = torch.ones_like(c["shifts"]) << c["shifts"]
            c["one"] = torch.from_numpy(self.one_mont.reshape(L, 1)).to(device)
            self._dev[key] = c
        return self._dev[key]


@functools.lru_cache(maxsize=None)
def get_fq() -> LimbRing:
    return LimbRing(params.Q, params.FQ_LIMBS, "Fq")


@functools.lru_cache(maxsize=None)
def get_fr() -> LimbRing:
    return LimbRing(params.R, params.FR_LIMBS, "Fr")


# ---------------------------------------------------------------------------
# int64 internals on (rows, M) views
# ---------------------------------------------------------------------------


def _carry(c, cols, carry_out: bool = False):
    """Column values (K, M), each in [0, 2^47), -> 16-bit limbs.

    The carry out of the top row is dropped (callers rely on this for mod-R
    semantics) unless carry_out, which returns (limbs, (1, M) carry in
    {0, 1}) and needs cols < 2^17.
    """
    K = cols.shape[0]
    if not carry_out:
        # fold once so that every column is < 2^32 (hi parts <= 2^16)
        hi = cols >> LIMB_BITS
        cols = cols & MASK
        cols[1:] += hi[: K - 1]
    lo = cols & MASK
    hi = cols >> LIMB_BITS
    lo[1:] += hi[: K - 1]
    d = lo & MASK
    g = lo >> LIMB_BITS                       # generate, in {0, 1}
    sh = c["shifts"][:K]
    G = (g << sh).sum(dim=0)
    P = ((d == MASK) * c["weights"][:K]).sum(dim=0)  # propagate
    # one integer add ripples every lane's carries: bit i of `cin` is the
    # carry into row i (G and P are disjoint, so (P|G) + G adds g and p bits)
    cin = ((P | G) + G) ^ P
    out = (d + ((cin[None, :] >> sh) & 1)) & MASK
    if carry_out:
        top = ((cin >> K) & 1)[None, :] | hi[K - 1 : K]
        return out, top
    return out


def _conv(c, a, b):
    """Schoolbook columns of a*b: (L, M) x (L, M) -> (2L, M), each < 2^37."""
    L, M = a.shape
    out = torch.zeros((2 * L, M), dtype=WORK, device=a.device)
    for i in range(L):
        out[i : i + L] += a[i : i + 1] * b
    return out


def _mont_mul(c, a, b):
    L = a.shape[0]
    t_cols = _conv(c, a, b)
    t_lo = _carry(c, t_cols[:L])                       # t mod R
    m = _carry(c, (c["toep_np"] @ t_lo.double()).to(WORK))     # (t N') mod R
    u_cols = (c["toep_p"] @ m.double()).to(WORK) + t_cols
    return _carry(c, u_cols)[L:]


def _cond_sub(c, v, comp):
    d, carry = _carry(c, v + comp, carry_out=True)
    return torch.where(carry != 0, d, v)


def _cond_sub_2p(c, v):
    return _cond_sub(c, v, c["compR2p"])


def _cond_sub_p(c, v):
    return _cond_sub(c, v, c["compRp"])


def _add(c, a, b):
    return _cond_sub_2p(c, _carry(c, a + b))


def _sub(c, a, b):
    return _cond_sub_2p(c, _carry(c, (a + c["comp2p"]) - b))


def _neg(c, a):
    return _carry(c, c["comp2p"] - a)


def _mul3(c, a):
    return _cond_sub_2p(c, _cond_sub_2p(c, _carry(c, a * 3)))


def _normalize(c, v):
    return _cond_sub_p(c, _cond_sub_2p(c, v))


# ---------------------------------------------------------------------------
# public ops on STORE tensors of shape (L, ...)
# ---------------------------------------------------------------------------


def _lift(fn, nargs):
    def op(ring: LimbRing, *xs):
        assert len(xs) == nargs
        if nargs > 1:
            # axis 0 is the limbs and the last axis the lanes: an operand of
            # lower rank (a shared (L, n) table or an (L, 1) constant against
            # (L, k, n) batch rows) gets its missing batch axes after axis 0
            nd = max(x.dim() for x in xs)
            xs = [x.reshape(x.shape[:1] + (1,) * (nd - x.dim()) + x.shape[1:]) for x in xs]
            xs = torch.broadcast_tensors(*xs)
        shape = xs[0].shape
        assert shape[0] == ring.L, f"{ring.name}: expected {ring.L} limb rows"
        c = ring.consts(xs[0].device)
        flat = [x.reshape(ring.L, -1).to(WORK) for x in xs]
        return fn(c, *flat).to(STORE).reshape(shape)

    return op


mont_mul = _lift(_mont_mul, 2)
mont_mul.__doc__ = "Montgomery product a*b*R^-1. Operands < 2p, result < 2p."
add = _lift(_add, 2)
add.__doc__ = "a, b < 2p -> a+b mod'2p' (< 2p)."
sub = _lift(_sub, 2)
sub.__doc__ = "a, b < 2p -> a-b mod'2p' (< 2p). Borrow-free complement form."
neg = _lift(_neg, 1)
neg.__doc__ = "a < 2p -> 2p - a (<= 2p; == -a mod p)."
mul3 = _lift(_mul3, 1)
mul3.__doc__ = "3a mod'2p' (the b3 constant of BLS12-377, b = 1)."
cond_sub_2p = _lift(_cond_sub_2p, 1)
cond_sub_2p.__doc__ = "v < 4p -> subtract 2p once if v >= 2p."
cond_sub_p = _lift(_cond_sub_p, 1)
cond_sub_p.__doc__ = "v < 2p -> canonical v mod p."
normalize = _lift(_normalize, 1)
normalize.__doc__ = "v <= 2p -> canonical < p (at batch boundaries)."


def mont_sq(ring: LimbRing, a):
    return mont_mul(ring, a, a)


def is_zero_mod_p(ring: LimbRing, v) -> torch.Tensor:
    """(L, M) lazy < 2p value -> (1, M) bool: v == 0 (mod p). Such a value
    has the two representatives {0, p} of zero; both patterns are tested."""
    c = ring.consts(v.device)
    v = v.to(WORK)
    eq0 = v.amax(dim=0, keepdim=True) == 0
    eqp = (v ^ c["p"]).amax(dim=0, keepdim=True) == 0
    return eq0 | eqp
