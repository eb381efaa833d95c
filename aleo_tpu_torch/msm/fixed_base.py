"""Fixed-base MSM with precomputed per-window shifted base tables.

Counterpart of the JAX package's `msm/fixed_base.py`. Every KZG commitment
of the prover is an MSM against FIXED bases, the SRS powers [tau^i]G shared
by all commits of every proof. That permits the classic fixed-base
transformation: precompute

    Q[w, i] = 2^(c*w) * P_i          (w = 0..W-1, the window shifts)

once per SRS slice, after which an N-point MSM becomes a SINGLE-WINDOW
bucket problem over the W*N precomputed points with signed digits d[w, i]:

  * no Horner window combine (the result IS the weighted bucket sum),
  * the bucket space is 2^(c-1) buckets sub-split across `s` lanes (the
    generalization of msm.py's top-window splitting to every bucket), so
    the round count is ~E / (2^(c-1) * s) + tail for E = W*N digit entries,
  * zero scalars contribute zero digits, which sort into the unqueried
    magnitude-0 region: padding a polynomial up to the table's size class
    costs sort width only.

Round adds ride the batch-affine pipeline (`msm.run_rounds_af`: `madd`,
with its tail balancing) on the wide lane grid; the narrow weighted
reduction after the sub-lane merges rides the projective adds
(`msm._weighted_bucket_sum`: `add_lf`, `double_lf`).

Tables build on the device of the points: W - 1 chains of c doublings
(`double_lf`) and one batched affine normalization (`batch_inv_lf`, then
`fq_mul` for x/z and y/z), the same code on every device; they are cached
per (SRS seed, degree, shift, size, c, device). Nothing is built at import.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import params
from ..curves import g1_affine as ga, g1_fused as gf
from ..curves.g1 import G1Points
from ..curves.g1_affine import G1AF
from ..curves.g1_fused import G1LF
from ..fields import limb_kernels as lk
from ..fields.limbs import STORE
from . import msm as msm_mod

NBITS = params.R.bit_length()  # 253

DEFAULT_C = 13                  # W = 20 windows, 4096 buckets
TARGET_LANES = 1 << 15          # the lane grid's width the reference aims at
FIXED_BASE_MIN_N = 2048         # the smallest commit that kzg's "auto" mode
                                # sends here (the reference's default)


def _nwin(c: int) -> int:
    return math.ceil((NBITS + 1) / c)


def _sub_split(c: int, n: int, k: int = 1) -> int:
    """Sub-lanes per bucket: fill the lane grid up to TARGET_LANES, but
    never far past the digit-entry count (lanes beyond ~2E idle every
    round)."""
    half = 1 << (c - 1)
    entries = _nwin(c) * n
    s = max(1, min(TARGET_LANES, 2 * entries) // (half * k))
    return 1 << (s.bit_length() - 1)


class FixedTable:
    """Precomputed (W*N, 2L) affine gather rows for one base slice: row
    w*N + i holds 2^(c*w) * P_i as canonical [x | y] Montgomery limbs, the
    identity as (0, 0) (`msm.make_table`'s row format)."""

    def __init__(self, rows: torch.Tensor, n: int, c: int):
        self.rows = rows
        self.n = n
        self.c = c
        self.w = _nwin(c)


def _dbl_chain(p: G1LF, c: int) -> G1LF:
    """2^c * P for a whole batch: c doublings."""
    for _ in range(c):
        p = gf.double_lf(p)
    return p


def build_table(points: G1Points, c: int = DEFAULT_C) -> FixedTable:
    """W - 1 chains of c doublings + one batched to-affine.

    points: (N,) affine-encoded batch (z == 1, or z == 0 identity), on the
    device the table is built on.
    """
    n = points.x.shape[0]
    cur = gf.from_points(points)                     # (L, N) projective
    snaps = [cur]
    for _ in range(_nwin(c) - 1):
        cur = _dbl_chain(cur, c)
        snaps.append(cur)
    allp = G1LF(*(torch.cat([getattr(s, k) for s in snaps], dim=1) for k in "xyz"))
    return FixedTable(_to_affine_rows(allp), n, c)


def _to_affine_rows(p: G1LF) -> torch.Tensor:
    """Projective (L, M) batch -> (M, 2L) canonical affine gather rows with
    the (0, 0) identity sentinel: one batch inversion of the z's, one
    product each for x/z and y/z. A lazy x/z of a finite point may be p
    where the canonical value is 0, so the rows are normalized."""
    ring = lk.get_fq()
    L, m = p.x.shape
    inf = lk.is_zero_mod_p(ring, p.z)                # (1, M): z is 0 or p
    zsafe = torch.where(inf, ga._one_mont(p.z.device), p.z).contiguous()
    zinv = ga.batch_inv_lf(zsafe)
    ax = lk.normalize(ring, ga.fq_mul(p.x.contiguous(), zinv))
    ay = lk.normalize(ring, ga.fq_mul(p.y.contiguous(), zinv))
    rows = torch.cat([ax, ay], dim=0).masked_fill_(inf, 0)
    return rows.T.contiguous()                       # (M, 2L)


# -- per-SRS table cache --------------------------------------------------------

_CACHE: dict = {}


def srs_table(srs, n_pad: int, shift: int = 0, c: int | None = None) -> FixedTable:
    """Cached fixed-base table over srs.powers[shift : shift + n_pad] (c
    defaults to DEFAULT_C, read at call time)."""
    c = DEFAULT_C if c is None else c
    key = (srs.seed, srs.max_degree, shift, n_pad, c, str(srs.device))
    if key not in _CACHE:
        pw = srs.powers
        _CACHE[key] = build_table(G1Points(*(
            a[shift : shift + n_pad] for a in (pw.x, pw.y, pw.z)
        )), c)
    return _CACHE[key]


def cached_bytes() -> int:
    """Bytes of every cached table's rows."""
    return sum(t.rows.numel() * t.rows.element_size() for t in _CACHE.values())


def clear_cache() -> None:
    _CACHE.clear()


# -- the single-window bucket pipeline -----------------------------------------


def _fixed_rounds(scalars_raw: torch.Tensor, rows: torch.Tensor, c: int,
                  n: int, k: int) -> G1AF:
    """k MSMs over one fixed-base table -> bucket accumulators on the
    (k * 2^(c-1)) grid (sub-lanes merged).

    scalars_raw: (k, N, FR_LIMBS) int32 standard-form limbs (N == table.n).
    """
    assert scalars_raw.shape[:2] == (k, n) and rows.shape[0] == _nwin(c) * n
    dev = rows.device
    w_total = _nwin(c)
    half = 1 << (c - 1)
    s = _sub_split(c, n, k)
    m_exp = k * w_total * n

    digits = msm_mod.signed_digits(scalars_raw, c)   # (k, W, N) int32
    mag = digits.abs().to(torch.int64)
    sign = (digits < 0).to(STORE)

    # entries index the (W*N)-row table: id = w*N + i; the key is the MSM's
    # index above the magnitude's c bits. Sign and table index are permuted
    # apart from the key.
    msm_ids = torch.arange(k, dtype=torch.int64, device=dev).repeat_interleave(w_total * n)
    keys = (msm_ids << c) | mag.reshape(-1)
    tbl_ids = torch.arange(w_total * n, dtype=torch.int64, device=dev).repeat(k)
    sorted_keys, perm = torch.sort(keys, stable=True)
    sorted_pt = tbl_ids[perm]
    sorted_sign = sign.reshape(-1)[perm]

    # lane grid: k * half * s, MSM-major, bucket-major, sub-minor
    lanes = k * half * s
    iota = torch.arange(lanes, dtype=torch.int64, device=dev)
    qmsm = iota // (half * s)
    bucket = (iota // s) % half
    sub = iota % s
    qkeys = (qmsm << c) | (bucket + 1)
    starts = torch.searchsorted(sorted_keys, qkeys, right=False)
    ends = torch.searchsorted(sorted_keys, qkeys, right=True)
    counts = ends - starts
    lane_start = starts + sub
    lane_count = torch.clamp((counts - sub + s - 1) // s, min=0)

    # round-robin batch-affine accumulation with tail balancing
    stride = torch.full((lanes,), s, dtype=torch.int64, device=dev)
    acc = msm_mod.run_rounds_af(
        sorted_pt, sorted_sign, rows, lane_start, stride, lane_count, m_exp
    )

    # merge sub-lanes: log2(s) masked adds (partner = lane + d)
    iota_np = np.arange(lanes)
    d = 1
    while d < s:
        mask = ((iota_np % (2 * d) == 0) & (iota_np % s + d < s)).astype(np.int32)
        idx = torch.clamp(iota + d, max=lanes - 1)
        partner = G1AF(acc.x[:, idx], acc.y[:, idx], acc.inf[:, idx])
        acc = ga.add_pairs(acc, partner, valid=torch.from_numpy(mask).to(dev)[None, :])
        d *= 2
    if s > 1:
        acc = G1AF(*(a[:, ::s].contiguous() for a in acc))
    return acc


def _fixed_windows(scalars_raw: torch.Tensor, rows: torch.Tensor, c: int,
                   n: int, k: int) -> G1LF:
    """k MSMs -> G1LF batch k: the rounds, then the weighted bucket
    reduction over the (k, 2^(c-1)) grid."""
    acc = _fixed_rounds(scalars_raw, rows, c, n, k)
    return msm_mod._weighted_bucket_sum(ga.to_lf(acc), k, 1 << (c - 1))


def msm_fixed_host(scalars_raw: torch.Tensor, table: FixedTable):
    """One MSM -> host affine point (device pipeline + host decode).
    scalars_raw: (N, FR_LIMBS) int32 standard-form limbs, N == table.n."""
    out = _fixed_windows(scalars_raw[None], table.rows, table.c, table.n, 1)
    return gf.decode_lf(out)[0]


def msm_fixed_batch_host(scalars_raw: torch.Tensor, table: FixedTable) -> list:
    """(k, N, FR_LIMBS) scalars -> k host affine points, one device
    pipeline."""
    k = scalars_raw.shape[0]
    out = _fixed_windows(scalars_raw, table.rows, table.c, table.n, k)
    return gf.decode_lf(out)
