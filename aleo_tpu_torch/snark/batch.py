"""Batched Varuna prover: k same-circuit transitions in one device pipeline.

Counterpart of the JAX package's `snark/batch.py` (BASELINE config 5, batch
proving of multi-record transactions): all k proofs share one `Index` (same
function circuit), so every device stage (spmv, NTTs, elementwise rounds,
batched inversions, evaluations, folds) runs once for the whole batch, and
every round's commitments go through `kzg.commit_many_lf` (one gather table
for the k polynomials of a stack, their k MSMs in one bucket pipeline, one
readback for the stack; the JAX package runs them one after another, as
its TPU gained nothing from the k-way pipeline).

Layout. At this module's helper boundaries a batch is the reference's
(k, L, n) stack (proof axis leading; evaluations (k, L, 1)), which is also
what MatNTT's `*_batch_lf16` entry points take. Where the reference lifts a
function over the proof axis with `jax.vmap`, the port hands the function
the same data as (L, k, n), a transposed view: `fields.fr_lf`,
`pcs.poly_lf`, `snark.sparse.spmv_lf`, the butterfly network and the round
blocks of `snark.prover` all take batch axes between the limb axis and the
lane axis, elementwise ops as k*n lanes of one launch, the ops that run
along the lanes (scans, inversions, sums, powers) row by row in the same
launches. Tensors shared by the batch (index polynomials, vanishing
inverses, domain tables) are broadcast as (L, 1, n), never copied per
proof. `_over_proofs` is that lift.

Host work (Fiat-Shamir transcripts, window combines) stays per proof: each
proof has its own independent transcript, exactly as k separate `prove`
calls would. The draws from `rng` come in the reference's order (the masks
of z for every proof, then of z_A, z_B, z_C, then each proof's 2n + 2
coefficients of s), so with the same index, constraint systems and seeded
`rng` the k proofs are byte for byte the reference's.

With a `mesh` (`parallel.mesh.make_mesh`) the proof axis is split over its
`dp` axis: rank r proves proofs [r*k/dp, (r+1)*k/dp) through the same
batched stages, on the device its index's SRS lies on, and the proofs are
gathered over `dp` in rank order, so every rank returns all k. Each rank
draws the whole `rng` sequence and keeps its own slice, so seeded proofs are
those of the batch on one device, byte for byte. The `field` axis is not
used here, as in the reference.
"""

from __future__ import annotations

import random as _random
from typing import List

import torch
import torch.distributed as dist

from .. import params
from ..fields import fr_lf as lf
from ..ntt import matntt
from ..ntt import ntt as dntt
from ..pcs import kzg, poly_lf as pl
from ..utils import profiling as prof
from .indexer import Index, z_evaluations
from .prover import (
    BETA_POLYS, GAMMA_POLYS, Proof, _mask_vh,
    _f_sigma_block, _h0_block, _h2_block, _q1_block, _qx_block,
    _u_alpha_block, _weighted_sum3,
)
from .r1cs import ConstraintSystem
from .sparse import spmv_lf
from .transcript import Transcript

R = params.R
SHIFT = params.FR_GENERATOR

# batched transforms since the counts were last set to 0, by path
NTT_CALLS = {"matntt": 0, "butterfly": 0}


def reset_ntt_calls() -> None:
    for key in NTT_CALLS:
        NTT_CALLS[key] = 0


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(k, L, ...) stack <-> (L, k, ...) batch rows (a view; its own
    inverse)."""
    return x.transpose(0, 1)


def _over_proofs(fn, in_axes):
    """Lift `fn` over the proof axis, as `jax.vmap(fn, in_axes)` does in the
    reference: an argument with axis 0 is a (k, L, ...) stack, one with None
    a shared (L, n) tensor, which the limb arithmetic broadcasts over the
    batch rows. One call of `fn` on (L, k, n) views; results come back as
    stacks."""

    def lifted(*args):
        out = fn(*(_lanes(a) if ax == 0 else a for a, ax in zip(args, in_axes)))
        if isinstance(out, tuple):
            return tuple(_lanes(o) for o in out)
        return _lanes(out)

    return lifted


_mul_b = _over_proofs(lf.mul, (0, 0))
_add_b = _over_proofs(lf.add, (0, 0))
_sub_b = _over_proofs(lf.sub, (0, 0))
_binv_b = _over_proofs(lf.batch_inv, (0,))
_tsum_b = _over_proofs(lf.tree_sum, (0,))
_eval_b = _over_proofs(pl.eval_coeffs, (0, 0))

_h0_block_b = _over_proofs(_h0_block, (0, 0, 0, None))
_qx_block_b = _over_proofs(_qx_block, (0, 0, None))
_q1_block_b = _over_proofs(_q1_block, (0, 0, 0, 0, 0))
_u_alpha_block_b = _over_proofs(_u_alpha_block, (0, None, 0))
_f_sigma_block_b = _over_proofs(_f_sigma_block, (None, None, None, None, 0, 0, 0, 0))
_h2_block_b = _over_proofs(_h2_block, (None, None, None, None, 0, 0, 0, 0, 0, None))


def _weighted_sum3_b(xs, ws):
    """sum_i ws[:, i] * xs[i]; xs: (3, k, L, n) (or three stacks), ws:
    (k, 3, L, 1) -> (k, L, n)."""
    return _lanes(_weighted_sum3(
        [_lanes(xs[i]) for i in range(3)], [_lanes(ws[:, i]) for i in range(3)]
    ))


# Batched NTTs: MatNTT takes the batch natively (the k axis rides as extra
# matmul lanes, ntt/matntt.py) at the sizes `ntt._use_matntt` gives it, by
# size alone; below them the butterfly network transforms the k rows side by
# side in the launches of one transform.


def _transform_b(x, batch_fn, single_fn):
    with prof.stage("prove_batch/ntt"):
        if dntt._use_matntt(x.shape[2]):
            NTT_CALLS["matntt"] += 1
            return batch_fn(x)
        NTT_CALLS["butterfly"] += 1
        return _lanes(single_fn(_lanes(x))).contiguous()


def _ntt_b(x):
    return _transform_b(x, matntt.ntt_batch_lf16, dntt.ntt_lf)


def _intt_b(x):
    return _transform_b(x, matntt.intt_batch_lf16, dntt.intt_lf)


def _coset_ntt_b(x, shift):
    return _transform_b(
        x, lambda a: matntt.coset_ntt_batch_lf16(a, shift),
        lambda a: dntt.coset_ntt_lf(a, shift),
    )


def _coset_intt_b(x, shift):
    return _transform_b(
        x, lambda a: matntt.coset_intt_batch_lf16(a, shift),
        lambda a: dntt.coset_intt_lf(a, shift),
    )


def _divide_by_linear_b(coeffs_b: torch.Tensor, z_b: torch.Tensor):
    """Batched (q, y) with p - y = q (X - z): the evaluation-domain division
    of `pl.divide_by_linear_via_domain` over the proof axis, its NTT pair on
    the batched transforms. coeffs_b (k, L, n), z_b (k, L, 1) ->
    (q (k, L, n - 1), y (k, L, 1))."""
    n = coeffs_b.shape[2]
    npow2 = 1 << max(1, (n - 1).bit_length())
    c = _pad_b(coeffs_b, npow2)
    y_b = _eval_b(coeffs_b, z_b)                       # (k, L, 1)
    evals = _ntt_b(c)
    xs = dntt.domain(npow2).wpow_lf(coeffs_b.device)   # (L, npow2), shared
    q_evals = _lanes(pl._linear_quotient_evals(_lanes(evals), xs, _lanes(z_b), _lanes(y_b)))
    q = _intt_b(q_evals)
    return q[:, :, : max(1, n - 1)], y_b


def _pad_b(x, n):
    """(k, L, m) -> (k, L, n), zero-padded on the lane axis."""
    return pl.pad_to(x, n)


def _const_b(vals: List[int], n: int = 1, device=None) -> torch.Tensor:
    """Per-proof host scalars -> (k, L, n) Montgomery limbs (a broadcast
    view along n)."""
    enc = lf.encode(vals, device=device)    # (L, k)
    return enc.T[:, :, None].expand(len(vals), lf.L, n)


def _commit_batch(srs, stack, c=None, shift=0):
    """stack (k, L, n) -> k host affine points (`kzg.commit_many_lf`: one
    gather table and one bucket pipeline for the stack, one readback)."""
    return kzg.commit_many_lf(
        srs, [stack[i] for i in range(stack.shape[0])], c=c, shift=shift
    )


def _decode_b(y_b: torch.Tensor) -> list:
    """(k, L, 1) evaluations -> k host ints."""
    return [int(v) for v in lf.decode(_lanes(y_b)[:, :, 0])]


def _stack_named(stacks, names):
    """Named (k, L, n_i) stacks -> one (L, k, j, max n_i) block, zero-padded."""
    max_len = max(stacks[nm].shape[2] for nm in names)
    return torch.stack([_lanes(_pad_b(stacks[nm], max_len)) for nm in names], dim=2)


def _evals_of(block, names, z_b):
    """Evaluate the j polynomials of every proof at the proof's own point:
    block (L, k, j, n), z_b (k, L, 1) -> {name: k host ints}. The powers of a
    proof's point are shared by its j polynomials; one readback."""
    k, j = block.shape[1], block.shape[2]
    pw = lf.powers(_lanes(z_b), block.shape[3])        # (L, k, n)
    ys = lf.tree_sum(lf.mul(block, pw[:, :, None, :]))  # (L, k, j, 1)
    flat = [int(v) for v in lf.decode(ys.reshape(lf.L, k * j))]
    return {nm: [flat[p * j + i] for p in range(k)] for i, nm in enumerate(names)}


def _draw_masks(rng, k: int, n: int, names) -> dict:
    """Every draw of `rng` for k proofs, in the reference's order: the two
    masks of z for each proof, then those of z_A, z_B, z_C (`names`), then
    each proof's 2n + 2 coefficients of s."""
    pair = lambda: [(rng.randrange(R), rng.randrange(R)) for _ in range(k)]
    draws = {"z": pair()}
    for name in names:
        draws[name] = pair()
    draws["s"] = [[rng.randrange(R) for _ in range(2 * n + 2)] for _ in range(k)]
    return draws


def prove_batch(index: Index, cs_list: List[ConstraintSystem], rng=None,
                mesh=None) -> List[Proof]:
    """k proofs under one index; returns one Proof per constraint system, on
    the device the index's SRS lies on. `rng` seeds the hiding masks of all k
    proofs (default: the system's entropy). `mesh` splits the k proofs over
    its `dp` axis (k a multiple of it); every rank returns all k."""
    k = len(cs_list)
    assert k >= 1
    if rng is None:
        rng = _random.SystemRandom()
    draws = _draw_masks(rng, k, index.n, [mi.name for mi in index.matrices])
    if mesh is None:
        return _prove_batch(index, cs_list, draws)
    dp, rank = mesh["dp"].size(), mesh.get_local_rank("dp")
    assert k % dp == 0, "k must divide over the dp axis"
    mine = slice(rank * k // dp, (rank + 1) * k // dp)
    part = _prove_batch(index, cs_list[mine], {key: v[mine] for key, v in draws.items()})
    parts = [None] * dp
    dist.all_gather_object(parts, part, group=mesh.get_group("dp"))
    return [proof for p in parts for proof in p]


def _prove_batch(index: Index, cs_list: List[ConstraintSystem], draws: dict) -> List[Proof]:
    """The k proofs of `cs_list` with the masks of `draws`."""
    k = len(cs_list)
    n, m, ell = index.n, index.m, index.ell
    srs = index.srs
    dev = srs.device
    _s = prof.stage
    const = lambda vals, width=1: _const_b(vals, width, device=dev)

    # ---- batched witness layout --------------------------------------------
    with _s("prove_batch/witness"):
        z_evals = torch.stack(
            [lf.encode(list(z_evaluations(index, cs)), device=dev) for cs in cs_list]
        )                                               # (k, L, n)
        spmv_b = {
            mi.name: _lanes(spmv_lf(mi.by_row, _lanes(z_evals))) for mi in index.matrices
        }
        mask = lambda pb, pairs: torch.stack(
            [_mask_vh(pb[p], n, *pairs[p]) for p in range(k)]
        )
        z_poly = mask(_intt_b(z_evals), draws["z"])     # (k, L, n+2)
        zm_polys = {key: mask(_intt_b(v), draws[key]) for key, v in spmv_b.items()}

        s_coeff_list = draws["s"]
        sigma_s = [n * (sc[0] + sc[n] + sc[2 * n]) % R for sc in s_coeff_list]
        s_mask = torch.stack([lf.encode(sc, device=dev) for sc in s_coeff_list])

    # ---- rowcheck + input quotients ----------------------------------------
    with _s("prove_batch/r1_quotients"):
        za_c = _coset_ntt_b(_pad_b(zm_polys["A"], 4 * n), SHIFT)
        zb_c = _coset_ntt_b(_pad_b(zm_polys["B"], 4 * n), SHIFT)
        zc_c = _coset_ntt_b(_pad_b(zm_polys["C"], 4 * n), SHIFT)
        vh_inv = pl._coset_vh_inv(4 * n, n, SHIFT, dev)
        h0_evals = _h0_block_b(za_c, zb_c, zc_c, vh_inv)
        h0_poly = _coset_intt_b(h0_evals, SHIFT)[:, :, : n + 3]

        x_pubs = [cs.public_inputs() + [0] * (ell - cs.num_inputs) for cs in cs_list]
        xhat = torch.stack([lf.encode(x, device=dev) for x in x_pubs])
        xhat_poly = _intt_b(xhat) if ell > 1 else xhat
        z_c = _coset_ntt_b(_pad_b(z_poly, 2 * n), SHIFT)
        xhat_c = _coset_ntt_b(_pad_b(xhat_poly, 2 * n), SHIFT)
        vin_inv = pl._coset_vh_inv(2 * n, ell, SHIFT, dev)
        qx_evals = _qx_block_b(z_c, xhat_c, vin_inv)
        qx_poly = _coset_intt_b(qx_evals, SHIFT)[:, :, : n + 2 - ell]

    cms = {}
    with _s("prove_batch/commit_r1"):
        for name, stack in (
            ("z", z_poly), ("z_a", zm_polys["A"]), ("z_b", zm_polys["B"]),
            ("z_c", zm_polys["C"]), ("h0", h0_poly), ("q_x", qx_poly),
            ("s", s_mask),
        ):
            cms[name] = _commit_batch(srs, stack)

    # ---- transcripts / round 1 ---------------------------------------------
    trs = [Transcript("varuna") for _ in range(k)]
    for p, tr in enumerate(trs):
        tr.absorb_fr(n, m, ell)
        tr.absorb_points(index.index_commitments())
        tr.absorb_fr(*cs_list[p].public_inputs())
        for name in ("z", "z_a", "z_b", "z_c", "h0", "q_x", "s"):
            tr.absorb_point(cms[name][p])
        tr.absorb_fr(sigma_s[p])
    chals = [tr.challenges(4) for tr in trs]
    alphas = [ch[0] for ch in chals]
    etas = {"A": [ch[1] for ch in chals], "B": [ch[2] for ch in chals],
            "C": [ch[3] for ch in chals]}

    # ---- round 2 ------------------------------------------------------------
    with _s("prove_batch/r2"):
        dH = dntt.domain(n)
        vh_alphas = [(pow(a, n, R) - 1) % R for a in alphas]
        u_alpha = _u_alpha_block_b(const(alphas, n), dH.wpow_lf(dev), const(vh_alphas, n))
        spmvs = [
            _lanes(spmv_lf(mi.by_col, _lanes(u_alpha))) for mi in index.matrices
        ]                                               # 3 x (k, L, n)
        eta_ws = torch.stack(
            [const(etas[mi.name]) for mi in index.matrices], dim=1
        )                                               # (k, 3, L, 1)
        t_vec = _weighted_sum3_b(spmvs, eta_ws)
        t_poly = _intt_b(t_vec)

        r_alpha = _lanes(lf.powers(_lanes(const(alphas)), n).flip(-1))
        s_eta = _weighted_sum3_b(
            [zm_polys[mname] for mname in ("A", "B", "C")],
            torch.stack([const(etas[mname]) for mname in ("A", "B", "C")], dim=1),
        )

        r_c = _coset_ntt_b(_pad_b(r_alpha, 4 * n), SHIFT)
        s_c = _coset_ntt_b(_pad_b(s_eta, 4 * n), SHIFT)
        t_c = _coset_ntt_b(_pad_b(t_poly, 4 * n), SHIFT)
        zf_c = _coset_ntt_b(_pad_b(z_poly, 4 * n), SHIFT)
        sm_c = _coset_ntt_b(_pad_b(s_mask, 4 * n), SHIFT)
        q1_evals = _q1_block_b(sm_c, r_c, s_c, t_c, zf_c)
        q1_poly = _coset_intt_b(q1_evals, SHIFT)[:, :, : 2 * n + 2]
        # chunked X^n = 1 reduction: pure adds over the batch rows
        h1_l, rem_l = pl.divide_by_vanishing(_lanes(q1_poly), n)
        h1_poly = _lanes(h1_l)
        g1_poly = _lanes(rem_l)[:, :, 1:]

    D = srs.max_degree
    with _s("prove_batch/commit_r2"):
        for name, stack in (("t", t_poly), ("g1", g1_poly), ("h1", h1_poly)):
            cms[name] = _commit_batch(srs, stack)
        cms["g1_shift"] = _commit_batch(srs, g1_poly, shift=D - (n - 2))
    for p, tr in enumerate(trs):
        for nm in ("t", "g1", "h1", "g1_shift"):
            tr.absorb_point(cms[nm][p])
    betas = [tr.challenge() for tr in trs]

    # ---- round 3 ------------------------------------------------------------
    vh_betas = [(pow(b, n, R) - 1) % R for b in betas]
    ab_list = [a * b % R for a, b in zip(alphas, betas)]
    abs_list = [va * vb % R for va, vb in zip(vh_alphas, vh_betas)]
    sigmas = {}
    g2_polys, h2_polys = {}, {}
    vk_inv = pl._coset_vh_inv(4 * m, m, SHIFT, dev)
    for mi in index.matrices:
        mn = mi.name.lower()
        with _s("prove_batch/r3"):
            # index evaluations and polynomials are SHARED across the batch:
            # the coset lifts run unbatched and the blocks broadcast them
            f_e, sigma_dev = _f_sigma_block_b(
                mi.col_evals.T, mi.row_evals.T, mi.rcp_evals.T, mi.cval_evals.T,
                const(alphas, m), const(betas, m),
                const(ab_list, m), const(abs_list, m),
            )
            sigmas[mi.name] = _decode_b(sigma_dev)
            f_poly = _intt_b(f_e)
            g2_polys[mn] = f_poly[:, :, 1:]
            row_c = dntt.coset_ntt_lf(pl.pad_to(mi.row_poly.T, 4 * m), SHIFT)
            col_c = dntt.coset_ntt_lf(pl.pad_to(mi.col_poly.T, 4 * m), SHIFT)
            rcp_c = dntt.coset_ntt_lf(pl.pad_to(mi.rcp_poly.T, 4 * m), SHIFT)
            cval_c = dntt.coset_ntt_lf(pl.pad_to(mi.cval_poly.T, 4 * m), SHIFT)
            f_c = _coset_ntt_b(_pad_b(f_poly, 4 * m), SHIFT)
            h2_evals = _h2_block_b(
                row_c, col_c, rcp_c, cval_c, f_c,
                const(alphas, 4 * m), const(betas, 4 * m),
                const(ab_list, 4 * m), const(abs_list, 4 * m), vk_inv,
            )
            h2_polys[mn] = _coset_intt_b(h2_evals, SHIFT)[:, :, : m - 1]
        with _s("prove_batch/commit_r3"):
            cms[f"g2_{mn}"] = _commit_batch(srs, g2_polys[mn])
            cms[f"h2_{mn}"] = _commit_batch(srs, h2_polys[mn])
        with _s("prove_batch/commit_r3_shift"):
            cms[f"g2_shift_{mn}"] = _commit_batch(srs, g2_polys[mn], shift=D - (m - 2))

    for p, tr in enumerate(trs):
        tr.absorb_fr(sigmas["A"][p], sigmas["B"][p], sigmas["C"][p])
        for mn in "abc":
            tr.absorb_point(cms[f"g2_{mn}"][p])
            tr.absorb_point(cms[f"h2_{mn}"][p])
            tr.absorb_point(cms[f"g2_shift_{mn}"][p])
    gammas = [tr.challenge() for tr in trs]

    # ---- openings -----------------------------------------------------------
    beta_stacks = {
        "z": z_poly, "z_a": zm_polys["A"], "z_b": zm_polys["B"],
        "z_c": zm_polys["C"], "h0": h0_poly, "q_x": qx_poly, "s": s_mask,
        "t": t_poly, "g1": g1_poly, "h1": h1_poly,
    }
    gamma_stacks = {}
    for mi in index.matrices:
        mn = mi.name.lower()
        for pname in ("row", "col", "cval", "rcp"):
            gamma_stacks[f"{pname}_{mn}"] = getattr(mi, f"{pname}_poly").T[None].expand(
                k, lf.L, m
            )
        gamma_stacks[f"g2_{mn}"] = g2_polys[mn]
        gamma_stacks[f"h2_{mn}"] = h2_polys[mn]

    beta_b = const(betas)
    gamma_b = const(gammas)
    # each point's polynomials as one (L, k, j, n) block, built once for the
    # evaluations and the opening fold
    beta_block = _stack_named(beta_stacks, BETA_POLYS)
    gamma_block = _stack_named(gamma_stacks, GAMMA_POLYS)
    with _s("prove_batch/evals"):
        evals_beta = _evals_of(beta_block, BETA_POLYS, beta_b)
        evals_gamma = _evals_of(gamma_block, GAMMA_POLYS, gamma_b)

    for p, tr in enumerate(trs):
        tr.absorb_fr(*[evals_beta[kk][p] for kk in BETA_POLYS])
        tr.absorb_fr(*[evals_gamma[kk][p] for kk in GAMMA_POLYS])
    xi1s = [tr.challenge() for tr in trs]
    xi2s = [tr.challenge() for tr in trs]

    def batch_open(block, z_b, xi_list):
        gpows = lf.powers(_lanes(const(xi_list)), block.shape[2])      # (L, k, j)
        acc = _lanes(pl.fold_stack(block, gpows))
        q_b, _ = _divide_by_linear_b(acc, z_b)
        return _commit_batch(srs, q_b)

    with _s("prove_batch/open"):
        w_betas = batch_open(beta_block, beta_b, xi1s)
        del beta_block
        w_gammas = batch_open(gamma_block, gamma_b, xi2s)

    return [
        Proof(
            commitments={name: pts[p] for name, pts in cms.items()},
            sigmas=(sigmas["A"][p], sigmas["B"][p], sigmas["C"][p]),
            sigma_s=sigma_s[p],
            evals_beta={kk: v[p] for kk, v in evals_beta.items()},
            evals_gamma={kk: v[p] for kk, v in evals_gamma.items()},
            w_beta=w_betas[p],
            w_gamma=w_gammas[p],
        )
        for p in range(k)
    ]
