"""NTT/iNTT over Fr: the entry points and the radix-2 butterfly network.

Counterpart of the JAX package's `ntt/ntt.py`. The prover evaluates and
interpolates polynomials over two-adic subgroups of Fr (2-adicity 47) and
their cosets. Two paths, chosen by size alone (`_use_matntt`): a
power-of-two transform of `config.MATNTT_MIN_N` (2^14) lanes and more runs
as MatNTT (`ntt/matntt.py`: int8 matrix products and one fused reduction
kernel per stage), a smaller one runs the butterfly network below, in
plain PyTorch. The reference takes MatNTT only on its accelerator; the
port takes it on every device, so the CPU tests run the path the GPU runs,
with the kernels' plain versions. MatNTT's output is lazy (< 1.1p), the
butterfly's < 2p; callers accept either.

The butterfly: iterative Cooley-Tukey DIT. One bit-reversal gather, then
log2(n) stages; each stage views the lanes as (blocks, 2, half), multiplies
the upper halves by the stage's twiddles (n/2 field muls, no partner
gathers, no selects) and writes lo +- t.

Domain tables (root powers, bit-reversal permutation, coset scalings) are
host-precomputed per size and cached; device copies are made once per
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config, params
from ..fields import fr_lf as lf
from ..fields import limbs
from ..reference.field import fr_root_of_unity
from . import matntt

R = params.R
L = lf.L


def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(logn):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def _power_table(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] as (n, L) Montgomery limbs (limbs last)."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * base % R
    return limbs.to_mont_host(out, R, L)


class _DeviceTables:
    """Host numpy tables `<name>_np` with lazy per-device tensor copies."""

    def _device(self, name: str, device, limbs_first: bool = False):
        key = (name, str(device), limbs_first)
        if key not in self._dev:
            a = getattr(self, name + "_np")
            if limbs_first:
                a = a.T
            if a.dtype == np.int64:
                t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            else:
                t = limbs.to_tensor(a, device)
            self._dev[key] = t
        return self._dev[key]


class Domain(_DeviceTables):
    """Radix-2 evaluation domain of size n over Fr, with cached tables."""

    def __init__(self, n: int):
        assert n & (n - 1) == 0 and n >= 1
        self.n = n
        self.logn = n.bit_length() - 1
        self.w = fr_root_of_unity(n) if n > 1 else 1
        self.w_inv = pow(self.w, -1, R)
        self.n_inv = pow(n, -1, R)
        # Powers W^k, k in [0, n), Montgomery form, (n, L) limbs last.
        self.wpow_np = _power_table(self.w, n)
        self.wpow_inv_np = _power_table(self.w_inv, n)
        self.bitrev_np = _bitrev_perm(n)
        self.n_inv_mont_np = limbs.to_mont_host([self.n_inv], R, L)[0]
        self._dev = {}

    def wpow_lf(self, device, inverse: bool = False):
        """(L, n) limbs-first power table on `device`."""
        return self._device("wpow_inv" if inverse else "wpow", device, True)

    def bitrev(self, device):
        return self._device("bitrev", device)

    def n_inv_mont(self, device):
        return self._device("n_inv_mont", device)[:, None]

    def elements(self):
        """Host list of the domain points [W^0, ..., W^(n-1)]."""
        out, acc = [], 1
        for _ in range(self.n):
            out.append(acc)
            acc = acc * self.w % R
        return out


@functools.lru_cache(maxsize=64)
def domain(n: int) -> Domain:
    return Domain(n)


def _transform_lf(x: torch.Tensor, wpow: torch.Tensor, bitrev) -> torch.Tensor:
    """Core DIT butterfly network, limbs-first. x: (L, ..., n), lazy < 2p in
    and out (axes between limbs and lanes are batch rows, transformed side
    by side in the same launches); wpow: (L, n) power table; bitrev: (n,)
    int64 permutation."""
    n = x.shape[-1]
    if n == 1:
        return x
    lead = x.shape[:-1]
    logn = n.bit_length() - 1
    x = x[..., bitrev]
    for s in range(logn):
        half = 1 << s
        nblk = n // (2 * half)
        xr = x.reshape(lead + (nblk, 2, half))
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        tw = wpow[:, :: n >> (s + 1)][:, :half]             # (L, half)
        tw = tw.reshape((L,) + (1,) * len(lead) + (half,))
        t = lf.mul(tw, hi)
        x = torch.stack([lf.add(lo, t), lf.sub(lo, t)], dim=-2).reshape(lead + (n,))
    return x


def _run_lf(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(L, ..., n) limbs-first transform, lazy in/out."""
    d = domain(x.shape[-1])
    return _transform_lf(x, d.wpow_lf(x.device, inverse), d.bitrev(x.device))


# -- limbs-last (n, L) API (the indexer's interpolation) -----------------------


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations over the size-n subgroup.
    x: (n, L) Montgomery limbs, natural order in and out (canonical)."""
    return lf.normalize(ntt_lf(x.T)).T.contiguous()


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients (canonical)."""
    return lf.normalize(intt_lf(x.T)).T.contiguous()


# -- MatNTT dispatch -------------------------------------------------------------


def _use_matntt(n: int) -> bool:
    return n >= config.MATNTT_MIN_N and n & (n - 1) == 0


# -- limbs-first API (prover pipeline) ------------------------------------------


def ntt_lf(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT on (L, n) limbs-first tensors, or (L, k, n) for k
    transforms side by side; lazy in/out."""
    if _use_matntt(x.shape[-1]):
        return matntt.ntt_lf16(x)
    return _run_lf(x, False)


def intt_lf(x: torch.Tensor) -> torch.Tensor:
    if _use_matntt(x.shape[-1]):
        return matntt.intt_lf16(x)
    d = domain(x.shape[-1])
    return lf.mul(_run_lf(x, True), d.n_inv_mont(x.device))


class Coset(_DeviceTables):
    """Multiplicative coset shift*H with cached scaling vectors."""

    def __init__(self, n: int, shift: int):
        self.shift = shift
        self.shift_pows_np = _power_table(shift, n)
        self.shift_pows_inv_np = _power_table(pow(shift, -1, R), n)
        self._dev = {}

    def shift_pows_lf(self, device, inverse: bool = False):
        return self._device(
            "shift_pows_inv" if inverse else "shift_pows", device, True
        )


@functools.lru_cache(maxsize=64)
def coset(n: int, shift: int) -> Coset:
    return Coset(n, shift)


def coset_ntt_lf(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate (L, n) coefficients on the coset shift*H; lazy in/out."""
    if _use_matntt(x.shape[-1]):
        return matntt.coset_ntt_lf16(x, shift)
    c = coset(x.shape[-1], shift)
    return _run_lf(lf.mul(x, c.shift_pows_lf(x.device)), False)


def coset_intt_lf(x: torch.Tensor, shift: int) -> torch.Tensor:
    if _use_matntt(x.shape[-1]):
        return matntt.coset_intt_lf16(x, shift)
    c = coset(x.shape[-1], shift)
    d = domain(x.shape[-1])
    y = lf.mul(_run_lf(x, True), d.n_inv_mont(x.device))
    return lf.mul(y, c.shift_pows_lf(x.device, True))


# -- limbs-last (n, L) coset API ------------------------------------------------


def coset_ntt(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate coefficients on the coset shift*H. x: (n, L), canonical out."""
    return lf.normalize(coset_ntt_lf(x.T, shift)).T.contiguous()


def coset_intt(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Coset evaluations -> coefficients; x: (n, L), canonical out."""
    return lf.normalize(coset_intt_lf(x.T, shift)).T.contiguous()
