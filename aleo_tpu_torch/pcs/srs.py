"""Structured reference string (powers-of-tau) generation and caching.

Counterpart of the JAX package's `pcs/srs.py`. The SRS is generated
deterministically from a seed (a simulated trusted setup) on the host
(jacobian fixed-base windows) and cached on disk in the same pickle layout
as the JAX package writes, so one blob serves both (`srs_from_numpy`).
`Srs.from_file` / `Srs.save` cover the "bring your own ceremony output"
path.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass

import numpy as np

from .. import params
from ..curves import g1
from ..curves.g1 import G1Points
from ..fields import limbs
from ..reference.curve import G1, G2
from ..reference.tower import Fq2

R = params.R

from ..config import SRS_DIR as _CACHE_DIR

WINDOW_C = 8
NWIN = -(-params.R.bit_length() // WINDOW_C)  # 32


def _fixed_base_table(base):
    """Host window table T[w][d] = d * 2^(8w) * base, shape (NWIN, 256)."""
    table = []
    cur = base  # 2^(8w) * G
    for _ in range(NWIN):
        row = [None]
        acc = None
        for _ in range(255):
            acc = G1.add(acc, cur)
            row.append(acc)
        table.append(row)
        for _ in range(WINDOW_C):
            cur = G1.add(cur, cur)
    return table


def _batch_fixed_base_host(scalars, base):
    """Host windowed fixed-base: [k_i * base] as affine host points
    (jacobian accumulation, one affine conversion per point)."""
    from ..reference.msm import _jac_to_affine, _jadd_affine

    table = _fixed_base_table(base)
    out = []
    for k in scalars:
        kk = k % R
        acc = None
        for w in range(NWIN):
            d = (kk >> (WINDOW_C * w)) & 0xFF
            if d:
                acc = _jadd_affine(acc, table[w][d])
        out.append(_jac_to_affine(acc))
    return out


@dataclass
class Srs:
    """Universal KZG SRS: [tau^i]G in G1 (device), [tau]H in G2 (host)."""

    powers: G1Points            # (max_degree+1,) affine device points
    g2_gen: tuple               # host G2 affine
    g2_tau: tuple               # host G2 affine
    max_degree: int
    _host_pts: list | None = None   # lazy host affine [(x, y) | None]
    seed: bytes = b"aleo-tpu-srs"   # simulated-setup seed (tau derivation)

    @property
    def device(self):
        return self.powers.x.device

    def g2_power(self, s: int):
        """[tau^s]H in G2: the degree-bound pairing check's right side.

        A real ceremony ships these per circuit (one per degree bound);
        this simulated setup re-derives tau from its seed on demand and
        caches per exponent.
        """
        cache = getattr(self, "_g2_pow_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_g2_pow_cache", cache)
        if s not in cache:
            tau = int.from_bytes(hashlib.sha512(self.seed).digest(), "little") % R
            cache[s] = G2.mul(pow(tau, s, R), self.g2_gen)
        return cache[s]

    def host_affine(self) -> list:
        """Host affine copies of the powers (cached)."""
        if self._host_pts is None:
            from ..curves.g1_fused import decode_lf, from_points

            self._host_pts = decode_lf(from_points(self.powers))
        return self._host_pts

    @staticmethod
    def generate(max_degree: int, seed: bytes = b"aleo-tpu-srs", device=None) -> "Srs":
        device = limbs.resolve_device(device)
        tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % R
        taus = []
        acc = 1
        for _ in range(max_degree + 1):
            taus.append(acc)
            acc = acc * tau % R
        host_pts = _batch_fixed_base_host(taus, G1.generator())
        powers = g1.encode_points(host_pts, device=device)
        h = G2.generator()
        return Srs(powers, h, G2.mul(tau, h), max_degree, host_pts, seed)

    @staticmethod
    def load_or_generate(max_degree: int, seed: bytes = b"aleo-tpu-srs",
                         device=None) -> "Srs":
        device = limbs.resolve_device(device)
        os.makedirs(_CACHE_DIR, exist_ok=True)
        key = hashlib.sha256(seed + max_degree.to_bytes(8, "little")).hexdigest()[:16]
        path = os.path.join(_CACHE_DIR, f"srs_{max_degree}_{key}.pkl")
        if os.path.exists(path):
            return Srs.from_file(path, device=device)
        srs = Srs.generate(max_degree, seed, device=device)
        srs.save(path)
        return srs

    def to_numpy(self) -> dict:
        """The blob `save` writes: numpy arrays, ints and tuples only."""
        return {
            "x": limbs.to_numpy(self.powers.x).astype(np.uint32),
            "y": limbs.to_numpy(self.powers.y).astype(np.uint32),
            "z": limbs.to_numpy(self.powers.z).astype(np.uint32),
            "g2_gen": _fq2_pt_to_ints(self.g2_gen),
            "g2_tau": _fq2_pt_to_ints(self.g2_tau),
            "max_degree": self.max_degree,
            "host_pts": self._host_pts,
            "seed": self.seed,
        }

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_numpy(), f)

    @staticmethod
    def from_file(path: str, device=None) -> "Srs":
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return srs_from_numpy(blob, device=device)


def srs_from_numpy(blob: dict, device=None) -> Srs:
    """The blob of `Srs.save` (this package's or the JAX package's: the
    layouts are the same) -> an `Srs` on `device`."""
    device = limbs.resolve_device(device)
    powers = G1Points(*(limbs.to_tensor(np.asarray(blob[k]), device) for k in "xyz"))
    return Srs(
        powers,
        _ints_to_fq2_pt(blob["g2_gen"]),
        _ints_to_fq2_pt(blob["g2_tau"]),
        blob["max_degree"],
        blob.get("host_pts"),
        blob.get("seed", b"aleo-tpu-srs"),
    )


def _fq2_pt_to_ints(p):
    (x, y) = p
    return (x.c0, x.c1, y.c0, y.c1)


def _ints_to_fq2_pt(t):
    return (Fq2(t[0], t[1]), Fq2(t[2], t[3]))
