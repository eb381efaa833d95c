"""KZG polynomial commitments (commit/open/batch-open) + host verify.

Counterpart of the JAX package's `pcs/kzg.py`: the limbs-first API of the
prover, and the limbs-last API on (n, L) coefficient vectors (`commit`,
`commit_host`, `open_at`, `batch_open_at`) as adapters over it.
Commitments and opening proofs are MSMs over the SRS: they run the port's
device MSM on whichever device the SRS lies; there is no host-MSM
diversion. By default that is the variable-base MSM (`msm/msm.py`); with
`config.FIXED_BASE_MODE` on, a commit runs the fixed-base MSM over cached
per-window tables of the SRS (`msm/fixed_base.py`) instead: the same group
element either way. Verification is host-side pairing algebra.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import config, params
from ..curves.g1 import G1Points
from ..fields import fr_lf as flf
from ..msm import fixed_base
from ..msm.msm import (
    auto_c, combine_windows_host, make_table, msm, msm_fast_host, msm_windows_batch,
)
from ..reference.curve import G1, G2, pairing_check
from ..utils import profiling as prof
from . import poly_lf as pl_lf
from .srs import Srs

R = params.R

# Most points (k * n_pad) one bucket pipeline of `commit_many_lf` takes: a
# larger size group is split into pipelines of at most this many points.
# 4 x 2^22, the multi-MSM that `msm.msm_batch_host` runs on one card.
MAX_PIPELINE_POINTS = 1 << 24


def _table(srs: Srs, start: int, n: int) -> torch.Tensor:
    p = srs.powers
    return make_table(G1Points(
        p.x[start : start + n], p.y[start : start + n], p.z[start : start + n]
    ))


def _pad_size(srs: Srs, n: int, shift: int = 0) -> int:
    """Lengths are padded up to a power of two, so MSM lane grids come in a
    few size classes."""
    n_pad = min(1 << max(2, (n - 1).bit_length()), srs.max_degree + 1 - shift)
    return max(n, n_pad)


def verify(srs: Srs, commitment, z: int, y: int, proof_w) -> bool:
    """Host pairing check: e(C - yG, H) == e(W, [tau]H - zH), i.e.
    e(C - yG, H) * e(-W, tauH - zH) == 1."""
    c_minus_y = G1.add(commitment, G1.neg(G1.mul(y, G1.generator())))
    tau_minus_z = G2.add(srs.g2_tau, G2.neg(G2.mul(z, srs.g2_gen)))
    return pairing_check(
        [(c_minus_y, srs.g2_gen), (G1.neg(proof_w), tau_minus_z)]
    )


# -- limbs-last API ((n, L) coefficient vectors) ---------------------------------
#
# Adapters over the limbs-first API below: coefficients are moved to (L, n)
# and evaluations come back canonical, as (L,) limbs-last vectors.


def commit(srs: Srs, coeffs: torch.Tensor, c: int | None = None) -> G1Points:
    """Commit to a coefficient vector (n, L) Montgomery limbs: C = sum c_i
    [tau^i]G, one projective point (canonical limbs) from the device MSM
    with its device window combine, on the SRS's device."""
    n = coeffs.shape[0]
    assert n <= srs.max_degree + 1, "polynomial exceeds SRS degree"
    m = _pad_size(srs, n)
    raw = flf.from_mont(pl_lf.pad_to(coeffs.T.contiguous(), m)).T.contiguous()
    p = srs.powers
    return msm(raw, G1Points(p.x[:m], p.y[:m], p.z[:m]), c=c, device=srs.device)


def commit_host(srs: Srs, coeffs: torch.Tensor, c: int | None = None):
    """Commit and decode -> host affine point: the device bucket pipeline
    with the host window combine (`commit_lf`), on the SRS's device."""
    return commit_lf(srs, coeffs.T.contiguous(), c=c)


def open_at(srs: Srs, coeffs: torch.Tensor, z: torch.Tensor, c: int | None = None):
    """Opening proof W = [q(tau)]G with q = (p - p(z))/(X - z); z (L,).
    Returns (W host affine point, y (L,) Montgomery evaluation)."""
    w, y = open_at_lf(srs, coeffs.T.contiguous(), z[:, None], c=c)
    return w, flf.normalize(y)[:, 0]


def batch_open_at(
    srs: Srs,
    polys: Sequence[torch.Tensor],
    z: torch.Tensor,
    gamma: torch.Tensor,
    c: int | None = None,
):
    """One opening proof for many polynomials at one point via the random
    linear combination sum gamma^i p_i. Returns (W host point, [y_i] (L,)
    Montgomery)."""
    w, ys = batch_open_at_lf(srs, [p.T.contiguous() for p in polys], z[:, None],
                             gamma[:, None], c=c)
    return w, [flf.normalize(y)[:, 0] for y in ys]


# -- limbs-first API (prover pipeline; (L, n) coefficient tensors) --------------


def commit_lf(srs: Srs, coeffs_lf: torch.Tensor, c: int | None = None):
    """Commit a limbs-first (L, n) coefficient tensor -> host affine point:
    from_mont (lazy ok: the group order r absorbs the +r ambiguity, and the
    digits cover 254 bits) -> device bucket MSM -> host window combine."""
    return commit_shifted_lf(srs, coeffs_lf, 0, c=c)


def commit_shifted_lf(srs: Srs, coeffs_lf: torch.Tensor, shift: int,
                      c: int | None = None):
    """Commit to X^shift * p(X) without materializing the zero prefix:
    an MSM of p's coefficients against SRS points [shift, shift+n).

    The degree-bound commitments (snark/prover.py) are X^(D-d) * g with D
    the SRS degree: the same group element as the dense degree-D commitment,
    from an n-point MSM.
    """
    n = coeffs_lf.shape[1]
    assert shift + n <= srs.max_degree + 1, "shifted polynomial exceeds SRS"
    with prof.stage("kzg/commit"):
        coeffs_lf = pl_lf.pad_to(coeffs_lf, _pad_size(srs, n, shift))
        raw = flf.from_mont(coeffs_lf).T.contiguous()
        m = coeffs_lf.shape[1]
        if _use_fixed_base(m):
            return fixed_base.msm_fixed_host(raw, fixed_base.srs_table(srs, m, shift))
        return msm_fast_host(raw, _table(srs, shift, m), c=c)


def _use_fixed_base(n: int) -> bool:
    """Whether a commit of n (padded) points runs the fixed-base MSM: by
    `config.FIXED_BASE_MODE` and the size alone, read at call time."""
    if config.FIXED_BASE_MODE in ("0", "false"):
        return False
    if config.FIXED_BASE_MODE == "1":
        return True
    return n >= fixed_base.FIXED_BASE_MIN_N


def commit_many_lf(srs: Srs, polys_lf, c: int | None = None, shift: int = 0):
    """Commit a list of limbs-first polynomials, grouped by padded size.

    With the fixed-base MSM on for the size (`_use_fixed_base`), a size
    group rides ONE fixed-base multi-MSM over the cached table of its SRS
    slice. Otherwise a size group shares one gather table and its k MSMs run
    as ONE bucket pipeline (`msm.msm_windows_batch`: one sort, one round
    count read, one round loop over k * W * 2^(c-1) lanes, one reduction;
    groups of more than `MAX_PIPELINE_POINTS` points split into several);
    the per-window totals of a pipeline are normalized on the device and
    read back in ONE host transfer (`msm.combine_windows_host`). shift > 0
    commits X^shift * p_i against the SRS points from `shift` on
    (shared-offset degree-bound commitments). With profiling on, the
    counters `kzg/msms` and `kzg/pipelines` count the variable-base MSMs and
    the pipelines that ran them.

    The JAX package runs a group's MSMs one after another: on a TPU v5e its
    device-bound k-way pipeline gained nothing (2737 ms for k = 6 at 2^15
    against 6 x 256 ms). On the H100 the port's commitments are bound by
    launches and host work instead, which one pipeline per group shares out.
    """
    groups = {}
    for i, p in enumerate(polys_lf):
        groups.setdefault(_pad_size(srs, p.shape[1], shift), []).append(i)
    out = [None] * len(polys_lf)
    for n_pad, idxs in groups.items():
        assert shift + n_pad <= srs.max_degree + 1
        if _use_fixed_base(n_pad):
            with prof.stage("kzg/commit"):
                ft = fixed_base.srs_table(srs, n_pad, shift)
                raws = [flf.from_mont(pl_lf.pad_to(polys_lf[i], n_pad)).T for i in idxs]
                pts = fixed_base.msm_fixed_batch_host(torch.stack(raws), ft)
            for j, i in enumerate(idxs):
                out[i] = pts[j]
            continue
        table = _table(srs, shift, n_pad)
        cg = c if c is not None else auto_c(n_pad)
        per = max(1, MAX_PIPELINE_POINTS // n_pad)
        for lo in range(0, len(idxs), per):
            part = idxs[lo : lo + per]
            with prof.stage("kzg/commit"):
                raws = torch.stack([flf.from_mont(pl_lf.pad_to(polys_lf[i], n_pad)).T
                                    for i in part])
                windows = msm_windows_batch(raws, table, c=cg)
            prof.counter("kzg/msms", len(part))
            prof.counter("kzg/pipelines", 1)
            # one normalize and one device->host transfer for the pipeline's
            # k * W window totals, outside `kzg/commit`
            for i, p in zip(part, combine_windows_host(windows, cg, len(part))):
                out[i] = p
    return out


def open_at_lf(srs: Srs, coeffs_lf: torch.Tensor, z_lf: torch.Tensor, c: int | None = None):
    """Opening proof W = [q(tau)]G, limbs-first. Returns (W host point,
    y (L, 1) Montgomery evaluation)."""
    q, y = pl_lf.divide_by_linear_via_domain(coeffs_lf, z_lf)
    w = commit_lf(srs, q, c=c)
    return w, y


def batch_open_at_lf(
    srs: Srs,
    polys_lf: Sequence[torch.Tensor],
    z_lf: torch.Tensor,
    gamma_lf: torch.Tensor,
    c: int | None = None,
    compute_evals: bool = True,
):
    """Single opening proof for many limbs-first polynomials at one point via
    the random linear combination sum gamma^i p_i. Returns (W, [y_i]).

    compute_evals=False skips the per-polynomial evaluations when the caller
    already holds them (the prover evaluates all of them in one batch before
    the transcript absorbs them)."""
    ys = [pl_lf.eval_coeffs(p, z_lf) for p in polys_lf] if compute_evals else None
    max_len = max(p.shape[1] for p in polys_lf)
    stack = torch.stack([pl_lf.pad_to(p, max_len) for p in polys_lf], dim=1)
    gpows = flf.powers(gamma_lf, len(polys_lf))          # (L, k)
    acc = pl_lf.fold_stack(stack, gpows)
    w, _ = open_at_lf(srs, acc, z_lf, c=c)
    return w, ys


def batch_verify(
    srs: Srs,
    commitments: Sequence,
    z: int,
    ys: Sequence[int],
    gamma: int,
    proof_w,
) -> bool:
    """Host verification of a batched opening."""
    acc_c = None
    acc_y = 0
    gp = 1
    for cm, y in zip(commitments, ys):
        acc_c = G1.add(acc_c, G1.mul(gp, cm))
        acc_y = (acc_y + gp * y) % R
        gp = gp * gamma % R
    return verify(srs, acc_c, z, acc_y, proof_w)
