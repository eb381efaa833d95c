"""Marlin-family AHP indexer: R1CS -> committed index polynomials + tables.

Counterpart of the JAX package's `snark/indexer.py`: the analogue of snarkVM
Varuna's circuit indexing (the "ProvingKey / VerifyingKey synthesis" of
`Process::deploy` / `synthesize_key`). For each matrix M in {A, B, C} the indexer produces
polynomials over the non-zero-entry domain K:

  row_M(kappa)  = omega_H^{row of entry kappa}
  col_M(kappa)  = omega_H^{col position of entry kappa}
  cval_M(kappa) = val * col_M(kappa) / n        (normalization chosen so the
                  lincheck polynomial t interpolates t(c) = sum_{col=c}
                  val * u_H(alpha, row); see prover.py for the derivation)
  rcp_M(kappa)  = row_M * col_M

plus device sparse-matvec tables for M z (row-sorted) and M^T u (col-sorted),
and KZG commitments to all index polynomials (the verifying-key material).

Variable -> H-position layout: public input j sits at H index j*(n/l) so the
input sub-domain is the order-l subgroup of H; witnesses fill the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import params
from ..fields import fr_lf as lf
from ..fields import limbs
from ..ntt import ntt as dntt
from ..pcs import kzg
from ..pcs.srs import Srs
from .r1cs import ConstraintSystem
from .sparse import SparseTables, build_tables

R = params.R


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclass
class MatrixIndex:
    name: str
    row_poly: torch.Tensor     # (m, L) coeffs, Montgomery
    col_poly: torch.Tensor
    cval_poly: torch.Tensor
    rcp_poly: torch.Tensor
    row_evals: torch.Tensor    # (m, L) evaluations over K (prover convenience)
    col_evals: torch.Tensor
    cval_evals: torch.Tensor
    rcp_evals: torch.Tensor
    commitments: List         # [row, col, cval, rcp] host points
    by_row: SparseTables      # for M z     (out over H rows)
    by_col: SparseTables      # for M^T u   (out over H cols)


@dataclass
class Index:
    srs: Srs
    n: int                    # |H|
    m: int                    # |K|
    ell: int                  # |input domain|
    num_inputs: int
    var_pos: np.ndarray       # variable index -> H position
    matrices: List[MatrixIndex]

    def index_commitments(self) -> List:
        out = []
        for mi in self.matrices:
            out.extend(mi.commitments)
        return out


def variable_positions(n: int, ell: int, num_inputs: int, num_vars: int) -> np.ndarray:
    """Input j -> j*(n/ell); witnesses fill the non-input positions in order.

    Only the first `num_inputs` variables are inputs; when num_inputs < ell
    (ell is the input count rounded up to a power of two) the remaining
    input-domain positions stay EMPTY — they must evaluate to the zero
    padding of x_pub, or the q_x public-input binding breaks (the padded
    slots are part of v_ell's vanishing set).
    """
    stride = n // ell
    pos = np.zeros(num_vars, dtype=np.int64)
    input_positions = set(range(0, n, stride))
    pos[:num_inputs] = np.arange(num_inputs) * stride
    rest = [p for p in range(n) if p not in input_positions]
    k = num_vars - num_inputs
    assert k <= len(rest), "domain too small for witnesses + input padding"
    pos[num_inputs:] = rest[:k]
    return pos


def index_r1cs(cs: ConstraintSystem, srs: Srs | None = None, seed: bytes = b"aleo-tpu-srs",
               device=None) -> Index:
    """Index a constraint system on `device` (None: the GPU; with an `srs`
    given, the device its powers lie on)."""
    device = srs.device if srs is not None and device is None else limbs.resolve_device(device)
    ell = _next_pow2(cs.num_inputs)
    # capacity: witnesses live outside the full ell-point input sub-domain,
    # so the empty padded slots must not displace them past n.
    n = _next_pow2(
        max(cs.num_constraints, cs.num_variables + (ell - cs.num_inputs), 2)
    )
    assert ell <= n
    coos = cs.matrices()
    m = _next_pow2(max(max(len(c) for c in coos), 2))
    # Largest committed polynomial: the K-side index/g2/h2 polys (length m),
    # the H-side masked polys (length <= n+3), and the degree-(2n+1) outer
    # sumcheck mask; quotients on the 2n/4n/4m cosets are trimmed to their
    # true degrees before committing.
    if srs is None:
        srs = Srs.load_or_generate(max(2 * n + 1, m) + 1, seed, device=device)
    assert srs.max_degree >= max(2 * n + 1, m)

    var_pos = variable_positions(n, ell, cs.num_inputs, cs.num_variables)
    dH = dntt.domain(n)
    omega_pows = dH.elements()          # host ints
    n_inv = pow(n, -1, R)

    matrices = []
    for name, coo in zip("ABC", coos):
        # Map columns to H positions.
        coo_pos = [(r, int(var_pos[c]), v) for (r, c, v) in coo]
        row_e, col_e, cval_e, rcp_e = [], [], [], []
        for (r, cpos, v) in coo_pos:
            wr = omega_pows[r]
            wc = omega_pows[cpos]
            row_e.append(wr)
            col_e.append(wc)
            cval_e.append(v * wc % R * n_inv % R)
            rcp_e.append(wr * wc % R)
        pad = m - len(coo_pos)
        row_e += [1] * pad
        col_e += [1] * pad
        cval_e += [0] * pad
        rcp_e += [1] * pad

        row_ev, col_ev, cval_ev, rcp_ev = (
            lf.encode(e, device=device).T.contiguous()
            for e in (row_e, col_e, cval_e, rcp_e)
        )
        row_poly = dntt.intt(row_ev)
        col_poly = dntt.intt(col_ev)
        cval_poly = dntt.intt(cval_ev)
        rcp_poly = dntt.intt(rcp_ev)
        # one grouped call: the four index commitments share one gather
        # table, one bucket pipeline and one readback (kzg.commit_many_lf)
        cms = kzg.commit_many_lf(
            srs, [p.T for p in (row_poly, col_poly, cval_poly, rcp_poly)]
        )

        by_row = build_tables(
            coo_pos, key_of=lambda e: e[0], gather_of=lambda e: e[1], out_size=n,
            m_pad=m, device=device,
        )
        by_col = build_tables(
            coo_pos, key_of=lambda e: e[1], gather_of=lambda e: e[0], out_size=n,
            m_pad=m, device=device,
        )
        matrices.append(
            MatrixIndex(
                name,
                row_poly, col_poly, cval_poly, rcp_poly,
                row_ev, col_ev, cval_ev, rcp_ev,
                cms, by_row, by_col,
            )
        )
    return Index(srs, n, m, ell, cs.num_inputs, var_pos, matrices)


def z_evaluations(index: Index, cs: ConstraintSystem) -> np.ndarray:
    """Host: full variable assignment laid out over H (length n ints)."""
    z = np.zeros(index.n, dtype=object)
    z[:] = 0
    for var, val in enumerate(cs.assignments):
        z[index.var_pos[var]] = val
    return z
