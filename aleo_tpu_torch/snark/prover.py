"""Marlin-family (Varuna-equivalent) AHP prover over KZG.

Counterpart of the JAX package's `snark/prover.py`: the compute-dominant
stage of the execution pipeline (snarkVM's `Trace::prove_execution`). The
protocol is the Marlin AHP for R1CS (lincheck + rowcheck over H, rational
sumcheck over K) compiled with KZG; every round is NTTs + elementwise field
blocks + one MSM per commitment, orchestrated from the host. Where the
reference wraps a block in `jax.jit`, this is a plain function.

All device field math is limbs-first (L, n) through `fields.fr_lf`;
polynomials stay in the lazy < 2p domain between blocks. The device is the
one the index lies on. With the same index, constraint system and seeded
`rng`, the proof is byte for byte the reference's.

Round structure (all challenges by Poseidon Fiat-Shamir, transcript.py):

  R1: commit  z, z_A, z_B, z_C, h0 (rowcheck quotient), q_x (public-input
      quotient: (z - xhat) / v_{H_in})
      -> alpha, eta_A, eta_B, eta_C
  R2: commit  t (lincheck target), g1, h1 with
      r_alpha(X) * sum_M eta_M z_M(X) - t(X) z(X) = h1 v_H + X g1,
      r_alpha(X) = u_H(alpha, X) = (v_H(alpha) - v_H(X)) / (alpha - X)
      -> beta
  R3: per M: sigma_M = sum_K f_M, commit g2_M, h2_M with
      f_M = X g2_M + sigma_M/|K|   and   b_M f_M - a_M = h2_M v_K,
      a_M = v_H(alpha) v_H(beta) cval_M,
      b_M = (alpha - row_M)(beta - col_M)
      -> gamma (K-side query point)
  Openings: batched KZG proofs at beta (H-side polys) and gamma (K-side).

Zero-knowledge (Marlin-style):
  * the witness-carrying polynomials z, z_A, z_B, z_C are masked with
    v_H(X) * (a + b X) for fresh random a, b — the masks vanish on H, so all
    AHP identities hold unchanged, while {commitment, one evaluation} of each
    poly is uniformly distributed (degree-1 mask = 2 unknowns vs 2 exposures);
  * the outer sumcheck is masked with a random s(X) committed in round 1
    whose H-sum sigma_s is revealed — the lincheck identity becomes
    s + r_alpha * sum eta_M z_M - t z = h1 v_H + X g1 + sigma_s/n.
  Quotient cosets are sized for the masked degrees (h0/q1 on 4n, q_x on 2n).

Degree-bound enforcement: g1 (deg <= n-2) and g2_M (deg <= m-2) are
additionally committed as X^(D-d) * g (D = SRS degree) against the SLICED
SRS (kzg.commit_shifted_lf — an (n-1)-point MSM, not a degree-D dense one);
the verifier binds cm_shift to cm with the pairing check
e(cm_shift, H) == e(cm, [tau^(D-d)]H), which only a polynomial of degree
<= d can satisfy from the SRS span (verifier.py).
"""

from __future__ import annotations

import random as _random

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from .. import params
from ..fields import fr_lf as lf
from ..ntt import ntt as dntt
from ..pcs import kzg, poly_lf as pl
from .indexer import Index, z_evaluations
from .r1cs import ConstraintSystem
from .sparse import spmv_lf
from .transcript import Transcript
from ..utils import profiling as prof

R = params.R
SHIFT = params.FR_GENERATOR  # coset shift for quotient computations

# Polynomials opened at each query point. The degree-bound commitments
# (g1_shift, g2_shift_*) are NOT opened: their binding to g1/g2 is a direct
# pairing check e(cm_shift, H) == e(cm, [tau^s]H) (verifier.py), which both
# removes the degree-D dense polynomials from the opening folds and lets the
# shifted commitments ride sliced-SRS MSMs (kzg.commit_shifted_lf).
BETA_POLYS = ["z", "z_a", "z_b", "z_c", "h0", "q_x", "s", "t", "g1", "h1"]
GAMMA_POLYS = [
    f"{p}_{mname}"
    for mname in "abc"
    for p in ("row", "col", "cval", "rcp", "g2", "h2")
]
COMMIT_NAMES = [
    "z", "z_a", "z_b", "z_c", "h0", "q_x", "s", "t", "g1", "h1", "g1_shift",
] + [f"{p}_{mn}" for mn in "abc" for p in ("g2", "h2", "g2_shift")]


@dataclass
class Proof:
    commitments: Dict[str, object]      # name -> host affine G1 point
    sigmas: Tuple[int, int, int]
    sigma_s: int                        # H-sum of the sumcheck mask s(X)
    evals_beta: Dict[str, int]
    evals_gamma: Dict[str, int]
    w_beta: object
    w_gamma: object

    def size_bytes(self) -> int:
        n_points = len(self.commitments) + 2
        n_scalars = 4 + len(self.evals_beta) + len(self.evals_gamma)
        return n_points * 48 + n_scalars * 32


def _fr(x: torch.Tensor) -> int:
    """Decode a single (L, 1) limbs-first element to a host int."""
    return int(lf.decode(x)[0])


def _eval_many(polys, z) -> list:
    """Evaluate many (L, *) polynomials at one point: one stacked block,
    one batched host readback. Returns host ints in order."""
    max_len = max(p.shape[1] for p in polys)
    stack = torch.stack([pl.pad_to(p, max_len) for p in polys], dim=1)
    ys = _eval_stack(stack, z)                  # (L, k)
    return [int(v) for v in lf.decode(ys)]


def _eval_stack(stack, z):
    # stack: (L, k, n); powers shared across the k polynomials
    pw = lf.powers(z, stack.shape[2])
    x = lf.mul(stack, pw[:, None, :])
    while x.shape[2] > 1:
        n = x.shape[2]
        half = n // 2
        s = lf.add(x[:, :, :half], x[:, :, half : 2 * half])
        x = torch.cat([s, x[:, :, 2 * half :]], dim=2) if n % 2 else s
    return x[:, :, 0]


def _h0_block(za_c, zb_c, zc_c, vh_inv):
    return lf.mul(lf.sub(lf.mul(za_c, zb_c), zc_c), vh_inv)


def _qx_block(z_c, xhat_c, vin_inv):
    return lf.mul(lf.sub(z_c, xhat_c), vin_inv)


def _u_alpha_block(alpha_e, wpow_lf, vh_alpha_e):
    denom = lf.sub(alpha_e, wpow_lf)
    return lf.mul(lf.batch_inv(denom), vh_alpha_e)


def _weighted_sum3(xs, ws):
    """sum_i ws[i] * xs[i] for 3 (L, n) tensors; ws: 3 (L, 1) tensors."""
    acc = lf.mul(xs[0], ws[0])
    acc = lf.add(acc, lf.mul(xs[1], ws[1]))
    return lf.add(acc, lf.mul(xs[2], ws[2]))


def _q1_block(smask_c, r_c, s_c, t_c, zf_c):
    return lf.add(smask_c, lf.sub(lf.mul(r_c, s_c), lf.mul(t_c, zf_c)))


def _b_block(row, col, rcp, alpha_e, beta_e, alpha_beta_e):
    """b = (alpha - row)(beta - col) = alpha*beta - alpha*col - beta*row + rcp"""
    return lf.add(
        lf.sub(alpha_beta_e, lf.add(lf.mul(col, alpha_e), lf.mul(row, beta_e))),
        rcp,
    )


def _f_sigma_block(col_e, row_e, rcp_e, cval_e, alpha_e, beta_e, alpha_beta_e,
                   ab_scale_e):
    b_e = _b_block(row_e, col_e, rcp_e, alpha_e, beta_e, alpha_beta_e)
    a_e = lf.mul(cval_e, ab_scale_e)
    f_e = lf.mul(a_e, lf.batch_inv(b_e))
    return f_e, lf.tree_sum(f_e)


def _h2_block(row_c, col_c, rcp_c, cval_c, f_c, alpha_e, beta_e,
              alpha_beta_e, ab_scale_e, vk_inv):
    b_c = _b_block(row_c, col_c, rcp_c, alpha_e, beta_e, alpha_beta_e)
    a_c = lf.mul(cval_c, ab_scale_e)
    num = lf.sub(lf.mul(b_c, f_c), a_c)
    return lf.mul(num, vk_inv)


def _mask_vh(poly: torch.Tensor, n: int, a: int, b: int) -> torch.Tensor:
    """poly + v_H(X) * (a + b X) = poly - (a + b X) + a X^n + b X^(n+1).

    poly: (L, n) -> (L, n+2), still identical to poly on H.
    """
    head = lf.encode([a, b], device=poly.device)
    padded = torch.cat([poly, head], dim=1)
    lo = lf.add(padded[:, :2], lf.neg(head))
    return torch.cat([lo, padded[:, 2:]], dim=1)


def prove(index: Index, cs: ConstraintSystem, rng=None) -> Proof:
    n, m, ell = index.n, index.m, index.ell
    srs = index.srs
    dev = srs.device
    if rng is None:
        rng = _random.SystemRandom()

    # ---- witness layout -----------------------------------------------------
    _s = prof.stage
    z_host = z_evaluations(index, cs)
    z_evals = lf.encode(list(z_host), device=dev)                 # (L, n)
    zm_evals = {mi.name: spmv_lf(mi.by_row, z_evals) for mi in index.matrices}

    # hiding masks: p + v_H * (a + b X), fresh randomness per proof
    z_poly = _mask_vh(dntt.intt_lf(z_evals), n, rng.randrange(R), rng.randrange(R))
    zm_polys = {
        k: _mask_vh(dntt.intt_lf(v), n, rng.randrange(R), rng.randrange(R))
        for k, v in zm_evals.items()
    }

    # outer sumcheck mask s(X), degree <= 2n+1; sigma_s = sum_H s =
    # n * (s_0 + s_n + s_2n)
    s_coeffs = [rng.randrange(R) for _ in range(2 * n + 2)]
    sigma_s = n * (s_coeffs[0] + s_coeffs[n] + s_coeffs[2 * n]) % R
    s_mask_poly = lf.encode(s_coeffs, device=dev)

    # index polynomials, limbs-first views (transposed once)
    ipolys = {}
    for mi in index.matrices:
        mn = mi.name.lower()
        ipolys[f"row_{mn}"] = mi.row_poly.T
        ipolys[f"col_{mn}"] = mi.col_poly.T
        ipolys[f"cval_{mn}"] = mi.cval_poly.T
        ipolys[f"rcp_{mn}"] = mi.rcp_poly.T

    # ---- rowcheck quotient h0 ----------------------------------------------
    # masked deg(z_M) = n+1, so deg(za*zb) = 2n+2: evaluate on a 4n coset.
    za_c = dntt.coset_ntt_lf(pl.pad_to(zm_polys["A"], 4 * n), SHIFT)
    zb_c = dntt.coset_ntt_lf(pl.pad_to(zm_polys["B"], 4 * n), SHIFT)
    zc_c = dntt.coset_ntt_lf(pl.pad_to(zm_polys["C"], 4 * n), SHIFT)
    vh_inv = pl._coset_vh_inv(4 * n, n, SHIFT, dev)
    h0_evals = _h0_block(za_c, zb_c, zc_c, vh_inv)
    h0_poly = dntt.coset_intt_lf(h0_evals, SHIFT)[:, : n + 3]

    # ---- public input quotient q_x -----------------------------------------
    # (z - xhat) / v_ell with deg(z) = n+1: evaluate on a 2n coset.
    x_pub = cs.public_inputs() + [0] * (ell - cs.num_inputs)
    x_pub_e = lf.encode(x_pub, device=dev)
    xhat_poly = dntt.intt_lf(x_pub_e) if ell > 1 else x_pub_e
    z_c = dntt.coset_ntt_lf(pl.pad_to(z_poly, 2 * n), SHIFT)
    xhat_c = dntt.coset_ntt_lf(pl.pad_to(xhat_poly, 2 * n), SHIFT)
    vin_inv = pl._coset_vh_inv(2 * n, ell, SHIFT, dev)
    qx_evals = _qx_block(z_c, xhat_c, vin_inv)
    qx_poly = dntt.coset_intt_lf(qx_evals, SHIFT)[:, : n + 2 - ell]

    commitments: Dict[str, object] = {}
    r1_names = ["z", "z_a", "z_b", "z_c", "h0", "q_x", "s"]
    r1_polys = [z_poly, zm_polys["A"], zm_polys["B"], zm_polys["C"],
                h0_poly, qx_poly, s_mask_poly]
    with _s("prove/commit_r1"):
        commitments.update(zip(r1_names, kzg.commit_many_lf(srs, r1_polys)))

    # ---- transcript / round 1 ----------------------------------------------
    tr = Transcript("varuna")
    tr.absorb_fr(n, m, ell)
    tr.absorb_points(index.index_commitments())
    tr.absorb_fr(*cs.public_inputs())
    for name in ("z", "z_a", "z_b", "z_c", "h0", "q_x", "s"):
        tr.absorb_point(commitments[name])
    tr.absorb_fr(sigma_s)
    alpha, eta_a, eta_b, eta_c = tr.challenges(4)
    etas = {"A": eta_a, "B": eta_b, "C": eta_c}

    # ---- round 2: lincheck sumcheck ----------------------------------------
    dH = dntt.domain(n)
    vh_alpha = (pow(alpha, n, R) - 1) % R
    alpha_e = lf.const(alpha, device=dev)
    # u_H(alpha, h) = v_H(alpha) / (alpha - h) for h in H
    u_alpha = _u_alpha_block(
        alpha_e, dH.wpow_lf(dev), lf.const(vh_alpha, device=dev)
    )
    # t over H: sum_M eta_M * (M^T u_alpha)
    spmvs = [spmv_lf(mi.by_col, u_alpha) for mi in index.matrices]
    eta_ws = [lf.const(etas[mi.name], device=dev) for mi in index.matrices]
    t_vec = _weighted_sum3(spmvs, eta_ws)
    t_poly = dntt.intt_lf(t_vec)

    # r_alpha(X) = sum_i alpha^{n-1-i} X^i  (degree n-1)
    r_alpha_poly = lf.powers(alpha_e, n).flip(1)

    # s(X) = sum_M eta_M z_M(X)
    s_poly = _weighted_sum3([zm_polys[k] for k in ("A", "B", "C")], eta_ws)

    # masked degrees: r(n-1) * s_eta(n+1) and t(n-1) * z(n+1) are 2n, the
    # mask s is 2n+1 -> evaluate q1 on a 4n coset.
    r_c = dntt.coset_ntt_lf(pl.pad_to(r_alpha_poly, 4 * n), SHIFT)
    s_c = dntt.coset_ntt_lf(pl.pad_to(s_poly, 4 * n), SHIFT)
    t_c = dntt.coset_ntt_lf(pl.pad_to(t_poly, 4 * n), SHIFT)
    zf_c = dntt.coset_ntt_lf(pl.pad_to(z_poly, 4 * n), SHIFT)
    smask_c = dntt.coset_ntt_lf(pl.pad_to(s_mask_poly, 4 * n), SHIFT)
    q1_evals = _q1_block(smask_c, r_c, s_c, t_c, zf_c)
    q1_poly = dntt.coset_intt_lf(q1_evals, SHIFT)[:, : 2 * n + 2]
    h1_poly, rem = pl.divide_by_vanishing(q1_poly, n)
    g1_poly = rem[:, 1:]  # rem = sigma_s/n + X g1 (by the masked sum identity)

    # degree-bound commitment for g1 (bound n-2): commit X^(D-(n-2)) * g1
    # directly against the shifted SRS slice — an (n-1)-point MSM instead of
    # a degree-D dense one
    D = srs.max_degree
    with _s("prove/commit_r2"):
        commitments.update(zip(
            ("t", "g1", "h1"),
            kzg.commit_many_lf(srs, [t_poly, g1_poly, h1_poly]),
        ))
        commitments["g1_shift"] = kzg.commit_shifted_lf(srs, g1_poly, D - (n - 2))
    for nm in ("t", "g1", "h1", "g1_shift"):
        tr.absorb_point(commitments[nm])
    beta = tr.challenge()

    # ---- round 3: rational sumchecks over K --------------------------------
    vh_beta = (pow(beta, n, R) - 1) % R
    sigmas = {}
    g2_polys, h2_polys = {}, {}
    vk_inv_4m = pl._coset_vh_inv(4 * m, m, SHIFT, dev)
    beta_e = lf.const(beta, device=dev)
    ab_e = lf.const(alpha * beta % R, device=dev)
    abs_e = lf.const(vh_alpha * vh_beta % R, device=dev)
    for mi in index.matrices:
        mn = mi.name.lower()
        f_e, sigma_dev = _f_sigma_block(
            mi.col_evals.T, mi.row_evals.T, mi.rcp_evals.T, mi.cval_evals.T,
            alpha_e, beta_e, ab_e, abs_e,
        )
        sigma = _fr(sigma_dev)
        sigmas[mi.name] = sigma
        f_poly = dntt.intt_lf(f_e)
        g2_polys[mn] = f_poly[:, 1:]
        # h2 = (b f - a) / v_K on a 4m coset
        row_c = dntt.coset_ntt_lf(pl.pad_to(ipolys[f"row_{mn}"], 4 * m), SHIFT)
        col_c = dntt.coset_ntt_lf(pl.pad_to(ipolys[f"col_{mn}"], 4 * m), SHIFT)
        rcp_c = dntt.coset_ntt_lf(pl.pad_to(ipolys[f"rcp_{mn}"], 4 * m), SHIFT)
        cval_c = dntt.coset_ntt_lf(pl.pad_to(ipolys[f"cval_{mn}"], 4 * m), SHIFT)
        f_c = dntt.coset_ntt_lf(pl.pad_to(f_poly, 4 * m), SHIFT)
        h2_evals = _h2_block(
            row_c, col_c, rcp_c, cval_c, f_c,
            alpha_e, beta_e, ab_e, abs_e, vk_inv_4m,
        )
        # deg(b*f) = 2m-2, so h2 = (b f - a)/v_K has degree m-2 when the
        # division is exact; trim so commitments stay within a size-m SRS.
        h2_polys[mn] = dntt.coset_intt_lf(h2_evals, SHIFT)[:, : m - 1]

    # one multi-MSM for all six K-side commitments, one more (sliced SRS)
    # for the three shared-offset degree-bound commitments
    with _s("prove/commit_r3"):
        r3 = kzg.commit_many_lf(
            srs, [g2_polys[mn] for mn in "abc"] + [h2_polys[mn] for mn in "abc"]
        )
    for i, mn in enumerate("abc"):
        commitments[f"g2_{mn}"] = r3[i]
        commitments[f"h2_{mn}"] = r3[3 + i]
    with _s("prove/commit_r3_shift"):
        shifts3 = kzg.commit_many_lf(
            srs, [g2_polys[mn] for mn in "abc"], shift=D - (m - 2)
        )
    for i, mn in enumerate("abc"):
        commitments[f"g2_shift_{mn}"] = shifts3[i]

    tr.absorb_fr(sigmas["A"], sigmas["B"], sigmas["C"])
    for mn in "abc":
        tr.absorb_point(commitments[f"g2_{mn}"])
        tr.absorb_point(commitments[f"h2_{mn}"])
        tr.absorb_point(commitments[f"g2_shift_{mn}"])
    gamma = tr.challenge()

    # ---- openings -----------------------------------------------------------
    # (degree-bound commitments are bound by pairing checks, not openings)
    beta_polys = {
        "z": z_poly, "z_a": zm_polys["A"], "z_b": zm_polys["B"], "z_c": zm_polys["C"],
        "h0": h0_poly, "q_x": qx_poly, "s": s_mask_poly, "t": t_poly,
        "g1": g1_poly, "h1": h1_poly,
    }
    gamma_polys = {}
    for mi in index.matrices:
        mn = mi.name.lower()
        gamma_polys[f"row_{mn}"] = ipolys[f"row_{mn}"]
        gamma_polys[f"col_{mn}"] = ipolys[f"col_{mn}"]
        gamma_polys[f"cval_{mn}"] = ipolys[f"cval_{mn}"]
        gamma_polys[f"rcp_{mn}"] = ipolys[f"rcp_{mn}"]
        gamma_polys[f"g2_{mn}"] = g2_polys[mn]
        gamma_polys[f"h2_{mn}"] = h2_polys[mn]

    gamma_e = lf.const(gamma, device=dev)
    # evaluations are batched into one stacked block and ONE host readback
    # per query point
    with _s("prove/evals"):
        evals_beta = dict(zip(
            BETA_POLYS, _eval_many([beta_polys[k] for k in BETA_POLYS], beta_e)
        ))
        evals_gamma = dict(zip(
            GAMMA_POLYS, _eval_many([gamma_polys[k] for k in GAMMA_POLYS], gamma_e)
        ))

    tr.absorb_fr(*[evals_beta[k] for k in BETA_POLYS])
    tr.absorb_fr(*[evals_gamma[k] for k in GAMMA_POLYS])
    xi1 = tr.challenge()
    xi2 = tr.challenge()

    with _s("prove/open"):
        w_beta, _ = kzg.batch_open_at_lf(
            srs, [beta_polys[k] for k in BETA_POLYS], beta_e, lf.const(xi1, device=dev),
            compute_evals=False,
        )
        w_gamma, _ = kzg.batch_open_at_lf(
            srs, [gamma_polys[k] for k in GAMMA_POLYS], gamma_e, lf.const(xi2, device=dev),
            compute_evals=False,
        )

    return Proof(
        commitments=commitments,
        sigmas=(sigmas["A"], sigmas["B"], sigmas["C"]),
        sigma_s=sigma_s,
        evals_beta=evals_beta,
        evals_gamma=evals_gamma,
        w_beta=w_beta,
        w_gamma=w_gamma,
    )
