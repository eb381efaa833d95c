"""The universal SRS the benchmark hands to the program: [tau^i] G for i up to
the degree, with H and [tau] H in G2, generated on the host from a seed and
kept in `proofbench/_cache/`.

tau is the seed's SHA-512, little endian, mod r (a simulated ceremony: the
benchmark keeps the trapdoor, and its reference checks the proofs with it).
The file is a pickle of the blob `aleo_tpu_torch.pcs.srs.srs_from_numpy`
reads, as a user hands in a ceremony's output: x, y, z as (N, 24) Montgomery
limbs of 16 bits, the host affine points, G2's points, the degree and seed.
Only the first run in a checkout generates it; later runs load it.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import List

import numpy as np

from ..reference import curve
from ..reference.field import Q, R

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache")
SEED = b"aleo-tpu-srs"
LIMBS = 24          # 16-bit limbs of an Fq element
WINDOW = 8


def trapdoor(seed: bytes = SEED) -> int:
    return int.from_bytes(hashlib.sha512(seed).digest(), "little") % R


def powers_of_tau(max_degree: int, seed: bytes = SEED) -> List:
    """[tau^i] G, i = 0..max_degree, as affine host points: a fixed-base
    window table of G, Jacobian sums, then one shared inversion."""
    tau = trapdoor(seed)
    nwin = -(-R.bit_length() // WINDOW)
    table, base = [], curve.generator()
    for _ in range(nwin):
        row, acc = [None], None
        for _ in range((1 << WINDOW) - 1):
            acc = curve.add(acc, base)
            row.append(acc)
        table.append(row)
        base = curve.mul(1 << WINDOW, base)
    jac, k = [], 1
    for _ in range(max_degree + 1):
        acc, e = (1, 1, 0), k
        for w in range(nwin):
            d = (e >> (WINDOW * w)) & 0xFF
            if d:
                acc = curve._jadd_affine(acc, table[w][d])
        jac.append(acc)
        k = k * tau % R
    zs = [p[2] for p in jac]
    prefix, run = [], 1
    for z in zs:
        prefix.append(run)
        run = run * z % Q
    inv = pow(run, -1, Q)
    out = [None] * len(jac)
    for i in range(len(jac) - 1, -1, -1):
        zi = prefix[i] * inv % Q
        inv = inv * zs[i] % Q
        zi2 = zi * zi % Q
        out[i] = (jac[i][0] * zi2 % Q, jac[i][1] * zi2 % Q * zi % Q)
    return out


def _mont_limbs(vals: List[int]) -> np.ndarray:
    r_mod = (1 << (16 * LIMBS)) % Q
    buf = b"".join((v * r_mod % Q).to_bytes(2 * LIMBS, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), LIMBS).astype(np.uint32)


def make_blob(max_degree: int, seed: bytes = SEED) -> dict:
    pts = powers_of_tau(max_degree, seed)
    h = curve.g2_generator()
    th = curve.g2_mul(trapdoor(seed), h)
    return {
        "x": _mont_limbs([p[0] for p in pts]),
        "y": _mont_limbs([p[1] for p in pts]),
        "z": _mont_limbs([1] * len(pts)),
        "g2_gen": (h[0][0], h[0][1], h[1][0], h[1][1]),
        "g2_tau": (th[0][0], th[0][1], th[1][0], th[1][1]),
        "max_degree": max_degree,
        "host_pts": pts,
        "seed": seed,
    }


def load(max_degree: int, seed: bytes = SEED, cache_dir: str | None = None):
    """-> (blob, seconds spent generating: 0.0 where the cache held it)."""
    import time

    cache_dir = cache_dir or CACHE_DIR
    key = hashlib.sha256(seed + max_degree.to_bytes(8, "little")).hexdigest()[:16]
    path = os.path.join(cache_dir, f"srs_{max_degree}_{key}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f), 0.0
    t0 = time.perf_counter()
    blob = make_blob(max_degree, seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f)
    os.replace(tmp, path)
    return blob, time.perf_counter() - t0
