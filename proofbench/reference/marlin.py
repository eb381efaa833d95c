"""A plain verifier of the program's proofs (Marlin-family AHP over KZG),
checked with the SRS's trapdoor instead of pairings.

The benchmark makes the SRS itself, so it knows tau. A KZG commitment to p is
[p(tau)] G; the pairing equation of an opening, e(C - yG, H) = e(W, [tau - z] H),
holds exactly when C - yG = [tau - z] W in G1, and a degree-bound check
e(C', H) = e(C, [tau^s] H) exactly when C' = [tau^s] C. So every check of the
pairing verifier is made here in G1 alone, and the verifying key is worked
out from the constraint matrices as [p(tau)] G without a single MSM.

Proof bytes (little endian): b"ATP1", u32 n, m, ell; 48-byte points in
COMMIT_NAMES order, then w_beta, w_gamma; 32-byte Fr values: the three
sigmas, sigma_s, the beta evaluations, the gamma evaluations.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from . import curve
from .field import R, batch_inverse, root_of_unity
from .transcript import Transcript

BETA_POLYS = ["z", "z_a", "z_b", "z_c", "h0", "q_x", "s", "t", "g1", "h1"]
GAMMA_POLYS = [f"{p}_{mn}" for mn in "abc" for p in ("row", "col", "cval", "rcp", "g2", "h2")]
COMMIT_NAMES = ["z", "z_a", "z_b", "z_c", "h0", "q_x", "s", "t", "g1", "h1", "g1_shift"] + [
    f"{p}_{mn}" for mn in "abc" for p in ("g2", "h2", "g2_shift")]
INDEX_POLYS = ("row", "col", "cval", "rcp")


@dataclass
class Proof:
    n: int
    m: int
    ell: int
    commitments: Dict[str, object]
    w_beta: object
    w_gamma: object
    sigmas: Tuple[int, int, int]
    sigma_s: int
    evals_beta: Dict[str, int]
    evals_gamma: Dict[str, int]


def parse_proof(data: bytes) -> Proof:
    """Raises ValueError on bytes that are no proof."""
    if data[:4] != b"ATP1":
        raise ValueError("bad magic")
    n, m, ell = struct.unpack_from("<III", data, 4)
    want = 16 + 48 * (len(COMMIT_NAMES) + 2) + 32 * (4 + len(BETA_POLYS) + len(GAMMA_POLYS))
    if len(data) != want:
        raise ValueError(f"a proof takes {want} bytes, got {len(data)}")
    off = 16
    pts = []
    for _ in range(len(COMMIT_NAMES) + 2):
        pts.append(curve.from_bytes(data[off:off + 48]))
        off += 48
    frs = []
    while off < len(data):
        v = int.from_bytes(data[off:off + 32], "little")
        if v >= R:
            raise ValueError("scalar out of range")
        frs.append(v)
        off += 32
    nb = len(BETA_POLYS)
    return Proof(n, m, ell, dict(zip(COMMIT_NAMES, pts[:-2])), pts[-2], pts[-1],
                 tuple(frs[:3]), frs[3], dict(zip(BETA_POLYS, frs[4:4 + nb])),
                 dict(zip(GAMMA_POLYS, frs[4 + nb:])))


@dataclass
class VerifyingKey:
    n: int
    m: int
    ell: int
    index_commitments: List     # [row, col, cval, rcp] of A, then of B, of C
    tau: int
    max_degree: int


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _lagrange_at(size: int, x: int) -> List[int]:
    """[L_k(x)] over the order-`size` subgroup, x outside it."""
    w = root_of_unity(size)
    hs, h = [], 1
    for _ in range(size):
        hs.append(h)
        h = h * w % R
    scale = (pow(x, size, R) - 1) * pow(size, -1, R) % R
    inv = batch_inverse([(x - h) % R for h in hs])
    return [h * scale % R * i % R for h, i in zip(hs, inv)]


def index_key(matrices: Sequence[Sequence[Tuple[int, int, int]]], num_inputs: int,
              num_constraints: int, num_variables: int, tau: int,
              max_degree: int) -> VerifyingKey:
    """The verifying key of a constraint system (A, B, C as (row, column,
    value) entries in the order the indexer lays them over K).

    Variables sit over H as the indexer places them: input j at j * n / ell,
    the witnesses on the other positions in order. Each matrix gives four
    polynomials over K: row = w_H^row, col = w_H^position, cval = value * col
    / n, rcp = row * col, padded with (1, 1, 0, 1)."""
    ell = _pow2(num_inputs)
    n = _pow2(max(num_constraints, num_variables + ell - num_inputs, 2))
    m = _pow2(max(max(len(c) for c in matrices), 2))
    stride = n // ell
    inputs = set(range(0, n, stride))
    rest = [p for p in range(n) if p not in inputs]
    pos = [j * stride for j in range(num_inputs)] + rest[:num_variables - num_inputs]
    wh = root_of_unity(n)
    omega = [1] * n
    for i in range(1, n):
        omega[i] = omega[i - 1] * wh % R
    n_inv = pow(n, -1, R)
    lag = _lagrange_at(m, tau)
    commitments = []
    for coo in matrices:
        acc = dict.fromkeys(INDEX_POLYS, 0)
        for k, (r, c, v) in enumerate(coo):
            wr, wc = omega[r], omega[pos[c]]
            acc["row"] += wr * lag[k]
            acc["col"] += wc * lag[k]
            acc["cval"] += v * wc % R * n_inv % R * lag[k]
            acc["rcp"] += wr * wc % R * lag[k]
        pad = sum(lag[len(coo):]) % R
        for name in ("row", "col", "rcp"):
            acc[name] += pad
        commitments += [curve.mul(acc[name] % R, curve.generator()) for name in INDEX_POLYS]
    return VerifyingKey(n, m, ell, commitments, tau, max_degree)


def _opening_holds(vk: VerifyingKey, cms, z: int, ys, xi: int, w) -> bool:
    """sum xi^i C_i - (sum xi^i y_i) G == [tau - z] W."""
    acc, y, gp = None, 0, 1
    for cm, yi in zip(cms, ys):
        acc = curve.add(acc, curve.mul(gp, cm))
        y = (y + gp * yi) % R
        gp = gp * xi % R
    lhs = curve.sub(acc, curve.mul(y, curve.generator()))
    return lhs == curve.mul(vk.tau - z, w)


def verify(vk: VerifyingKey, public_inputs: Sequence[int], proof: Proof) -> str:
    """'' where every check holds, else the name of the first that fails."""
    n, m, ell = vk.n, vk.m, vk.ell
    if (proof.n, proof.m, proof.ell) != (n, m, ell):
        return "domain sizes"
    cm, eb, eg = proof.commitments, proof.evals_beta, proof.evals_gamma
    sig_a, sig_b, sig_c = proof.sigmas

    tr = Transcript("varuna")
    tr.absorb_fr(n, m, ell)
    for p in vk.index_commitments:
        tr.absorb_point(p)
    tr.absorb_fr(*public_inputs)
    for name in ("z", "z_a", "z_b", "z_c", "h0", "q_x", "s"):
        tr.absorb_point(cm[name])
    tr.absorb_fr(proof.sigma_s)
    alpha, eta_a, eta_b, eta_c = tr.challenges(4)
    for name in ("t", "g1", "h1", "g1_shift"):
        tr.absorb_point(cm[name])
    beta = tr.challenge()
    tr.absorb_fr(sig_a, sig_b, sig_c)
    for mn in "abc":
        for name in ("g2", "h2", "g2_shift"):
            tr.absorb_point(cm[f"{name}_{mn}"])
    gamma = tr.challenge()
    tr.absorb_fr(*[eb[k] for k in BETA_POLYS])
    tr.absorb_fr(*[eg[k] for k in GAMMA_POLYS])
    xi1, xi2 = tr.challenge(), tr.challenge()

    vh_alpha = (pow(alpha, n, R) - 1) % R
    vh_beta = (pow(beta, n, R) - 1) % R
    if (eb["z_a"] * eb["z_b"] - eb["z_c"] - eb["h0"] * vh_beta) % R:
        return "rowcheck"
    x_pad = list(public_inputs) + [0] * (ell - len(public_inputs))
    xhat = sum(l * x for l, x in zip(_lagrange_at(ell, beta), x_pad)) % R
    if (eb["z"] - xhat - eb["q_x"] * (pow(beta, ell, R) - 1)) % R:
        return "public-input binding"
    if alpha == beta:
        return "alpha == beta"
    r_ab = (vh_alpha - vh_beta) * pow((alpha - beta) % R, -1, R) % R
    s_beta = (eta_a * eb["z_a"] + eta_b * eb["z_b"] + eta_c * eb["z_c"]) % R
    lhs = (eb["s"] + r_ab * s_beta - eb["t"] * eb["z"]) % R
    rhs = (eb["h1"] * vh_beta + beta * eb["g1"] + proof.sigma_s * pow(n, -1, R)) % R
    if lhs != rhs:
        return "lincheck sumcheck"
    if (eta_a * sig_a + eta_b * sig_b + eta_c * sig_c - eb["t"]) % R:
        return "t-sigma consistency"

    d = vk.max_degree
    bounds = [("g1_shift", "g1", d - (n - 2))] + [
        (f"g2_shift_{mn}", f"g2_{mn}", d - (m - 2)) for mn in "abc"]
    for shifted, base, s in bounds:
        if cm[shifted] != curve.mul(pow(vk.tau, s, R), cm[base]):
            return f"degree bound {shifted}"

    vk_gamma = (pow(gamma, m, R) - 1) % R
    m_inv = pow(m, -1, R)
    ab = vh_alpha * vh_beta % R
    for mn, sigma in zip("abc", proof.sigmas):
        f = (gamma * eg[f"g2_{mn}"] + sigma * m_inv) % R
        b = (alpha * beta - alpha * eg[f"col_{mn}"] - beta * eg[f"row_{mn}"]
             + eg[f"rcp_{mn}"]) % R
        if (b * f - ab * eg[f"cval_{mn}"] - eg[f"h2_{mn}"] * vk_gamma) % R:
            return f"rational sumcheck {mn}"

    if not _opening_holds(vk, [cm[k] for k in BETA_POLYS], beta,
                          [eb[k] for k in BETA_POLYS], xi1, proof.w_beta):
        return "beta opening"
    index = {f"{p}_{mn}": vk.index_commitments[i * 4 + j]
             for i, mn in enumerate("abc") for j, p in enumerate(INDEX_POLYS)}
    if not _opening_holds(vk, [index[k] if k in index else cm[k] for k in GAMMA_POLYS], gamma,
                          [eg[k] for k in GAMMA_POLYS], xi2, proof.w_gamma):
        return "gamma opening"
    return ""
