"""Host-side verifier for the Marlin-family AHP over KZG.

Implemented independently of the prover (host bigint algebra + pairings),
playing the role the unmodified Rust verifier plays for the reference's test
strategy (SURVEY.md §4: proofs must verify under an implementation that
shares no code with the prover's hot path). Mirrors
`Trace::verify_execution_proof` / `Process::verify_execution`
(`upstream:rust/src/program/helpers/offline.rs:71-78`,
`wasm/src/programs/manager/execute.rs:185`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .. import params
from ..reference import polynomial as rpoly
from .prover import BETA_POLYS, GAMMA_POLYS, Proof
from .transcript import Transcript

R = params.R


@dataclass
class VerifyingKey:
    n: int
    m: int
    ell: int
    index_commitments: List       # 12 host points: [row,col,cval,rcp] x A,B,C
    srs: object                   # pcs.srs.Srs (g2 parts + generator used)

    @staticmethod
    def from_index(index) -> "VerifyingKey":
        return VerifyingKey(
            n=index.n,
            m=index.m,
            ell=index.ell,
            index_commitments=index.index_commitments(),
            srs=index.srs,
        )


def verify(vk: VerifyingKey, public_inputs: List[int], proof: Proof,
           debug: bool = False) -> bool:
    from ..pcs import kzg

    def fail(check: str) -> bool:
        if debug:
            print(f"verify: FAILED check [{check}]", flush=True)
        return False

    n, m, ell = vk.n, vk.m, vk.ell
    cm = proof.commitments
    eb, eg = proof.evals_beta, proof.evals_gamma
    sig_a, sig_b, sig_c = proof.sigmas

    # ---- transcript replay --------------------------------------------------
    tr = Transcript("varuna")
    tr.absorb_fr(n, m, ell)
    tr.absorb_points(vk.index_commitments)
    tr.absorb_fr(*public_inputs)
    for name in ("z", "z_a", "z_b", "z_c", "h0", "q_x", "s"):
        tr.absorb_point(cm[name])
    tr.absorb_fr(proof.sigma_s)
    alpha, eta_a, eta_b, eta_c = tr.challenges(4)
    for nm in ("t", "g1", "h1", "g1_shift"):
        tr.absorb_point(cm[nm])
    beta = tr.challenge()
    tr.absorb_fr(sig_a, sig_b, sig_c)
    for mn in "abc":
        tr.absorb_point(cm[f"g2_{mn}"])
        tr.absorb_point(cm[f"h2_{mn}"])
        tr.absorb_point(cm[f"g2_shift_{mn}"])
    gamma = tr.challenge()
    tr.absorb_fr(*[eb[k] for k in BETA_POLYS])
    tr.absorb_fr(*[eg[k] for k in GAMMA_POLYS])
    xi1 = tr.challenge()
    xi2 = tr.challenge()

    vh_alpha = (pow(alpha, n, R) - 1) % R
    vh_beta = (pow(beta, n, R) - 1) % R

    # ---- AHP checks at beta -------------------------------------------------
    # rowcheck
    if (eb["z_a"] * eb["z_b"] - eb["z_c"] - eb["h0"] * vh_beta) % R != 0:
        return fail("rowcheck")
    # public input binding
    x_padded = list(public_inputs) + [0] * (ell - len(public_inputs))
    lag = rpoly.lagrange_coeffs_at(ell, beta)
    xhat_beta = sum(l * x for l, x in zip(lag, x_padded)) % R
    v_in_beta = (pow(beta, ell, R) - 1) % R
    if (eb["z"] - xhat_beta - eb["q_x"] * v_in_beta) % R != 0:
        return fail("public-input binding")
    # masked lincheck sumcheck:
    #   s(beta) + u_H(alpha,beta) s_eta(beta) - t(beta) z(beta)
    #     = h1(beta) v_H(beta) + beta g1(beta) + sigma_s / n
    if alpha == beta:
        return fail("alpha == beta")
    r_ab = (vh_alpha - vh_beta) * pow((alpha - beta) % R, -1, R) % R
    s_beta = (eta_a * eb["z_a"] + eta_b * eb["z_b"] + eta_c * eb["z_c"]) % R
    lhs = (eb["s"] + r_ab * s_beta - eb["t"] * eb["z"]) % R
    rhs = (eb["h1"] * vh_beta + beta * eb["g1"] + proof.sigma_s * pow(n, -1, R)) % R
    if lhs != rhs:
        return fail("lincheck sumcheck")
    # t(beta) consistency with the K-side sums
    if (eta_a * sig_a + eta_b * sig_b + eta_c * sig_c - eb["t"]) % R != 0:
        return fail("t-sigma consistency")

    # ---- degree-bound checks (shifted commitments, pairing form) -----------
    # cm_shift must equal tau^s * cm as group elements:
    #   e(cm_shift, H) == e(cm, [tau^s]H).
    # A prover can only produce such a cm_shift from the SRS when
    # deg(g) + s <= D, i.e. deg(g) <= D - s — the required degree bound
    # (standard KZG power-span argument; replaces opening the degree-D
    # dense shifted polynomial).
    from ..reference.curve import G1 as G1h, pairing_check

    D = vk.srs.max_degree
    bound_checks = [("g1_shift", cm["g1"], D - (n - 2))] + [
        (f"g2_shift_{mn}", cm[f"g2_{mn}"], D - (m - 2)) for mn in "abc"
    ]
    for shift_name, base_cm, s in bound_checks:
        ok = pairing_check([
            (cm[shift_name], vk.srs.g2_gen),
            (G1h.neg(base_cm), vk.srs.g2_power(s)),
        ])
        if not ok:
            return fail(f"degree bound {shift_name}")

    # ---- AHP checks at gamma (per matrix) -----------------------------------
    vk_gamma = (pow(gamma, m, R) - 1) % R
    m_inv = pow(m, -1, R)
    ab_scale = vh_alpha * vh_beta % R
    for mn, sigma in zip("abc", (sig_a, sig_b, sig_c)):
        f_gamma = (gamma * eg[f"g2_{mn}"] + sigma * m_inv) % R
        b_gamma = (
            alpha * beta
            - alpha * eg[f"col_{mn}"]
            - beta * eg[f"row_{mn}"]
            + eg[f"rcp_{mn}"]
        ) % R
        a_gamma = ab_scale * eg[f"cval_{mn}"] % R
        if (b_gamma * f_gamma - a_gamma - eg[f"h2_{mn}"] * vk_gamma) % R != 0:
            return fail(f"rational sumcheck {mn}")

    # ---- KZG batched openings ----------------------------------------------
    beta_cms = [cm[k] for k in BETA_POLYS]
    beta_ys = [eb[k] for k in BETA_POLYS]
    if not kzg.batch_verify(vk.srs, beta_cms, beta, beta_ys, xi1, proof.w_beta):
        return fail("beta opening")
    idx_cm = {}
    for i, mn in enumerate("abc"):
        for j, p in enumerate(("row", "col", "cval", "rcp")):
            idx_cm[f"{p}_{mn}"] = vk.index_commitments[i * 4 + j]
    gamma_cms = []
    for k in GAMMA_POLYS:
        gamma_cms.append(idx_cm[k] if k in idx_cm else cm[k])
    gamma_ys = [eg[k] for k in GAMMA_POLYS]
    if not kzg.batch_verify(vk.srs, gamma_cms, gamma, gamma_ys, xi2, proof.w_gamma):
        return fail("gamma opening")
    return True
