"""Pippenger multi-scalar multiplication, variable-base, two pipelines.

Counterpart of the JAX package's `msm/msm.py`: every KZG commitment of the
prover is one MSM over the SRS. The formulation makes *buckets* the vector
lanes and streams points into them:

  1. signed-digit window decomposition (digits in [-2^(c-1), 2^(c-1)];
     negating a point is free, which halves the bucket count),
  2. ONE global sort of all (window, |digit|) keys across every window,
  3. bucket start/count recovery via searchsorted over the sorted keys,
  4. round-robin accumulation: round j gathers the j-th point of every
     (window, bucket) segment and performs one batched add over all bucket
     lanes. The round count is the largest segment, a device value read back
     once per MSM,
  5. log-depth weighted bucket reduction (tree sums + suffix scans, all as
     full-width batched adds),
  6. window combine (Horner): on host bigints for the prover, whose
     transcript lives on the host anyway (`combine_windows_host`, the one
     host combine of `msm_fast_host`, `msm_batch_host` and
     `kzg.commit_many_lf`, in the stage `msm/combine_host`), or on the
     device (`msm`).

A pipeline run (`msm_windows_batch`) is three `utils.profiling` stages:
`msm/setup` (steps 1-3, the spare split and the round count's read),
`msm/rounds` (the round loop of step 4) and `msm/reduce` (the merges and
step 5). With profiling on, the round count's read also feeds the counters
`msm/lane_rounds` and `msm/adds`; nothing is timed or counted inside a
round.

Steps 4 and 5 exist twice, chosen by `config.MSM_AFFINE_MODE`:

  * batch-affine (the default): affine accumulators and one shared batch
    inversion per add (`curves.g1_affine.madd`, five CUDA kernels); the
    heaviest segments are split over spare lanes first. Functions `*_af`.
  * projective ("0"): complete projective adds, no inversion
    (`curves.g1_fused`: `add_sel_lf` in the rounds, `add_sel_proj_lf` in the
    top window's merge, `add_lf` and `double_lf` in the reduction).

The sort, searchsorted, argsort and gathers are library calls here as they
are in the reference (outside any kernel).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import config, params
from ..curves import g1, g1_affine as ga, g1_fused as gf
from ..curves.g1 import G1Points
from ..curves.g1_affine import G1AF
from ..curves.g1_fused import G1LF
from ..fields import limbs
from ..fields.limbs import STORE
from ..utils import profiling as prof

NBITS = params.R.bit_length()  # 253

# rounds of the bucket accumulation, summed over every pipeline run in the
# process (a reader takes differences; chip_smoke.py prints them per MSM)
ROUNDS = {"rounds": 0}


def auto_c(n: int) -> int:
    """Pippenger window size for an n-point MSM: ~log2(n) - 2 balances the
    bucket-lane count (W * 2^(c-1)) against the round count (max bucket
    occupancy ~ n / 2^(c-1) + tail). Same rule as the reference, so both
    build the same lane grids."""
    return max(3, min(12, n.bit_length() - 2))


def _nwin(c: int) -> int:
    # +1 bit of headroom so the signed-digit carry out of the top window
    # is always absorbed (relevant when c divides NBITS).
    return math.ceil((NBITS + 1) / c)


def signed_digits(scalars_raw: torch.Tensor, c: int) -> torch.Tensor:
    """(..., N, FR_LIMBS) raw 16-bit limbs -> (..., W, N) int32 signed window
    digits (leading axes, the k of a batch of MSMs, ride along).

    Digits lie in [-(2^(c-1)-1), 2^(c-1)] and satisfy
    sum_w d_w 2^(cw) == scalar. Requires c <= 16.
    """
    assert 2 <= c <= 16
    lead = scalars_raw.shape[:-1]
    w_total = _nwin(c)
    half = 1 << (c - 1)
    padded = torch.cat(
        [scalars_raw.to(torch.int64),
         torch.zeros(lead + (2,), dtype=torch.int64, device=scalars_raw.device)],
        dim=-1,
    )
    carry = torch.zeros(lead, dtype=torch.int64, device=scalars_raw.device)
    out = []
    for w in range(w_total):
        bit0 = w * c
        j0, sh = bit0 // 16, bit0 % 16
        v = padded[..., j0] | (padded[..., j0 + 1] << 16)
        d = ((v >> sh) & ((1 << c) - 1)) + carry
        big = d > half
        out.append(torch.where(big, d - (1 << c), d))
        carry = big.to(torch.int64)
    return torch.stack(out, dim=-2).to(torch.int32)


def make_table(points: G1Points) -> torch.Tensor:
    """(N,)-batched points -> (N, 2L) int32 gather table of [x|y] rows.

    Affine rows. Identity points are stored as the off-curve sentinel (0, 0)
    (y^2 = x^3 + 1 has no point with y = 0), which the accumulation masks
    like an invalid lane.
    """
    ident = (points.z == 0).all(dim=-1, keepdim=True)
    xy = torch.cat([points.x, points.y], dim=-1)
    return torch.where(ident, torch.zeros_like(xy), xy)


def _top_window_split(c: int, w_total: int) -> tuple:
    """(effective top-window bucket count, sub-split factor).

    The top window covers only `NBITS+1 - c*(W-1)` bits, so its digit range
    (and occupied bucket count) is far below 2^(c-1); without correction its
    buckets hold ~n/2^(top_bits) entries and they alone set the round count.
    Splitting each top bucket across the window's unused lanes restores
    uniform occupancy; the sub-accumulators are merged afterwards by log2(s)
    masked adds.
    """
    half = 1 << (c - 1)
    top_bits = (NBITS + 1) - c * (w_total - 1)
    mag_top = min(1 << top_bits, half)
    return mag_top, half // mag_top


@functools.lru_cache(maxsize=None)
def _lane_layout_np(c: int, w_total: int, k: int = 1):
    """Static per-lane layout (numpy): sub offsets, strides, merge masks,
    and the post-merge reshuffle, for k MSMs over one table.

    Lane grid: k * W * half lanes, MSM-major then window-major. Normal
    windows: one lane per bucket (stride 1). Top window of each MSM: bucket
    b's segment is interleaved across s lanes (stride s); merge mask d
    selects lanes with sub % 2^(d+1) == 0 and sub + 2^d < s.
    """
    half = 1 << (c - 1)
    mag_top, s = _top_window_split(c, w_total)
    lanes = k * w_total * half
    iota = np.arange(lanes)
    win = (iota // half) % w_total
    lane_in_win = iota % half
    is_top = win == (w_total - 1)
    sub = np.where(is_top, lane_in_win % s, 0)
    bucket = np.where(is_top, lane_in_win // s, lane_in_win)
    stride = np.where(is_top, s, 1).astype(np.int64)
    merge_masks = []
    d = 1
    while d < s:
        merge_masks.append(
            (is_top & (sub % (2 * d) == 0) & (sub + d < s)).astype(np.int32)
        )
        d *= 2
    # reshuffle: the weighted scan wants bucket b's total at lane index b
    # within its window; merged totals sit at sub-lane 0 (lane b*s).
    src = np.where(
        is_top & (lane_in_win < mag_top),
        iota - lane_in_win + lane_in_win * s,
        iota,
    ).astype(np.int64)
    keep = (~is_top | (lane_in_win < mag_top)).astype(np.int32)
    return (
        sub.astype(np.int64), bucket.astype(np.int64), stride,
        merge_masks, src, keep, s,
    )


def _sort_keys(msm_ids, win_ids, mag, c: int):
    """The sort key of a (MSM, window, |digit|) entry, int64: the MSM's
    index above the window's above the magnitude's c bits. Windows get 8
    bits (W <= 127 for c >= 2), as in the reference's 32-bit packing; for a
    single MSM the index is 0 and the key is the reference's k = 1 key."""
    return (msm_ids << (c + 8)) | (win_ids << c) | mag


def _bucket_grid(sorted_keys: torch.Tensor, c: int, w_total: int, k: int = 1):
    """(lane_start, lane_stride, lane_count) int64 tensors over the lane grid
    of k MSMs, with top-window sub-splitting applied."""
    half = 1 << (c - 1)
    dev = sorted_keys.device
    sub_np, bucket_np, stride_np, merge_masks, src_np, keep_np, s = (
        _lane_layout_np(c, w_total, k)
    )
    ids = torch.arange(k * w_total, dtype=torch.int64, device=dev).repeat_interleave(half)
    qmag = torch.from_numpy(bucket_np).to(dev) + 1
    qkeys = _sort_keys(ids // w_total, ids % w_total, qmag, c)
    starts = torch.searchsorted(sorted_keys, qkeys, right=False)
    ends = torch.searchsorted(sorted_keys, qkeys, right=True)
    counts = ends - starts
    sub = torch.from_numpy(sub_np).to(dev)
    stride = torch.from_numpy(stride_np).to(dev)
    lane_start = starts + sub
    lane_count = torch.clamp((counts - sub + stride - 1) // stride, min=0)
    return lane_start, stride, lane_count, merge_masks, src_np, keep_np, s


def _top_windows(a: torch.Tensor, k: int, half: int) -> torch.Tensor:
    """The lanes of every MSM's top window out of a (rows, k * W * half) lane
    grid -> (rows, k * half)."""
    rows = a.shape[0]
    return a.reshape(rows, k, -1, half)[:, :, -1].reshape(rows, k * half)


def _put_top_windows(a: torch.Tensor, top: torch.Tensor, k: int, half: int) -> torch.Tensor:
    """The grid `a` with its top windows replaced by `top` (rows, k * half)."""
    rows = a.shape[0]
    a4 = a.reshape(rows, k, -1, half)
    return torch.cat([a4[:, :, :-1], top.reshape(rows, k, 1, half)], dim=2).reshape(rows, -1)


def _merge_partner_idx(k: int, half: int, shift: int, dev) -> torch.Tensor:
    """Lane `shift` to the right within its own top window (clamped), over
    the (k * half) top-window lanes."""
    idx = torch.clamp(torch.arange(half, device=dev) + shift, max=half - 1)
    return (torch.arange(k, device=dev)[:, None] * half + idx[None, :]).reshape(-1)


# Overflow balancing: fraction of extra "spare" lanes that adopt the second
# half of the heaviest buckets' segments. The round count is the MAX segment
# length (the occupancy tail is about twice the mean), so splitting just the
# heavy tail cuts rounds for a few more lanes.
OVERFLOW_FRAC = 8  # spares = lanes // OVERFLOW_FRAC


def _spare_split(lane_start, lane_stride, lane_count, balance: bool = True):
    """Tail balancing of a (start, stride, count) lane grid: the
    lanes // OVERFLOW_FRAC heaviest segments are split in half, and the
    second halves ride spare lanes appended to the grid. Returns the grid
    over main and spare lanes, and the spares' partners (`None` without
    spares): the mains each spare serves and the mask of split mains."""
    lanes = lane_start.shape[0]
    n_spare = lanes // OVERFLOW_FRAC if balance else 0
    if not n_spare:
        return lane_start, lane_stride, lane_count, None
    order = torch.argsort(lane_count, descending=True, stable=True)
    tgt = order[:n_spare]                          # heaviest mains
    is_split = torch.zeros((lanes,), dtype=torch.bool, device=lane_start.device)
    is_split[tgt] = True
    h = torch.where(is_split, (lane_count + 1) // 2, lane_count)
    all_start = torch.cat([lane_start, lane_start[tgt] + h[tgt] * lane_stride[tgt]])
    all_stride = torch.cat([lane_stride, lane_stride[tgt]])
    all_count = torch.cat([h, lane_count[tgt] - h[tgt]])
    return all_start, all_stride, all_count, (tgt, is_split)


def _round_count(lane_count) -> int:
    """The one device->host read of a pipeline run: how many rounds its data
    needs (the largest segment). With profiling on, the same read brings the
    segments' sum for the counters `msm/lane_rounds` (lanes x rounds, the
    loop's lane slots) and `msm/adds` (the points added)."""
    if prof.enabled():
        rounds, adds = torch.stack([lane_count.max(), lane_count.sum()]).tolist()
        prof.counter("msm/lane_rounds", lane_count.shape[0] * rounds)
        prof.counter("msm/adds", adds)
    else:
        rounds = int(lane_count.max().item())
    ROUNDS["rounds"] += rounds
    return rounds


def _accumulate_buckets_af(sorted_pt, sorted_sign, table, lane_start, lane_stride,
                           lane_count, rounds: int, m_exp: int) -> G1AF:
    """The round loop, batch-affine: round j adds the j-th point of every
    lane's segment into the lane's affine accumulator.

    sorted_pt / sorted_sign: (m_exp,) point index and sign of every sorted
    (window, digit) entry (kept apart: sign << 31 | id does not fit int32).
    """
    L = table.shape[1] // 2
    acc = ga.identity_af(lane_start.shape[0], device=table.device)
    for j in range(rounds):
        pos = torch.clamp(lane_start + j * lane_stride, max=m_exp - 1)
        valid = (j < lane_count).to(STORE)
        coords = table[sorted_pt[pos]].T.contiguous()       # (2L, lanes)
        px, py = coords[:L], coords[L:]
        # identity sentinel (0, 0): y == 0 never occurs in the subgroup
        pinf = (py.amax(dim=0, keepdim=True) == 0).to(STORE)
        acc = ga.madd(acc, px, py, pinf, sorted_sign[pos], valid)
    return acc


def _merge_spares_af(acc: G1AF, lanes: int, spares) -> G1AF:
    """The main lanes of `acc`, each split main with its spare added back:
    one masked add with a runtime partner gather (pidx[i] = spare index
    serving main i)."""
    main = G1AF(acc.x[:, :lanes], acc.y[:, :lanes], acc.inf[:, :lanes])
    if spares is None:
        return main
    tgt, is_split = spares
    pidx = torch.zeros((lanes,), dtype=torch.int64, device=acc.x.device)
    pidx[tgt] = torch.arange(tgt.shape[0], dtype=torch.int64, device=acc.x.device)
    sx, sy, sinf = acc.x[:, lanes:], acc.y[:, lanes:], acc.inf[:, lanes:]
    partner = G1AF(sx[:, pidx], sy[:, pidx], sinf[:, pidx])
    return ga.add_pairs(main, partner, valid=is_split.to(STORE))


def run_rounds_af(sorted_pt, sorted_sign, table, lane_start, lane_stride,
                  lane_count, m_exp: int, balance: bool = True) -> G1AF:
    """Round-robin batch-affine accumulation over a (start, stride, count)
    lane grid with tail balancing, in one call: the spare split, the round
    count's read, the round loop and the spares' merge (the fixed-base
    MSM's rounds)."""
    start, stride, count, spares = _spare_split(lane_start, lane_stride, lane_count, balance)
    acc = _accumulate_buckets_af(sorted_pt, sorted_sign, table, start, stride, count,
                                 _round_count(count), m_exp)
    return _merge_spares_af(acc, lane_start.shape[0], spares)


def _merge_top_windows_af(acc: G1AF, merge_masks, src_np, keep_np, half: int,
                          k: int = 1) -> G1AF:
    """Top-window merge/reshuffle, batch-affine. `half` is the lane count of
    one window, `k` the number of MSMs."""
    dev = acc.x.device
    # merge the top windows' sub-accumulators: log2(s) masked adds over those
    # windows' lanes alone (the last `half` lanes of each MSM's grid; no
    # other lane has a partner)
    if len(merge_masks):
        top = G1AF(*(_top_windows(a, k, half) for a in acc))
        shift = 1
        for mask_np in merge_masks:
            idx = _merge_partner_idx(k, half, shift, dev)
            partner = G1AF(top.x[:, idx], top.y[:, idx], top.inf[:, idx])
            mask = _top_windows(torch.from_numpy(mask_np).to(dev)[None, :], k, half)
            top = ga.add_pairs(top, partner, valid=mask)
            shift *= 2
        acc = G1AF(*(_put_top_windows(a, t, k, half) for a, t in zip(acc, top)))
        src = torch.from_numpy(src_np).to(dev)
        keep = torch.from_numpy(keep_np).to(dev)[None, :] != 0
        acc = G1AF(
            torch.where(keep, acc.x[:, src], 0),
            torch.where(keep, acc.y[:, src], 0),
            torch.where(keep, acc.inf[:, src], 1),
        )
    return acc


def _scan_add_buckets_af(p: G1AF, w: int, b: int) -> G1AF:
    """Hillis-Steele suffix scan along the bucket axis:
    out[b'] = sum_{k >= b'} p[k] within each window."""
    L = p.x.shape[0]
    x, y, inf = p.x, p.y, p.inf
    s = 1
    while s < b:

        def shc(a, rows, fill):
            a3 = a.reshape(rows, w, b)
            tail = torch.full((rows, w, s), fill, dtype=a.dtype, device=a.device)
            return torch.cat([a3[:, :, s:], tail], dim=2).reshape(rows, -1)

        r = ga.add_pairs(
            G1AF(x, y, inf), G1AF(shc(x, L, 0), shc(y, L, 0), shc(inf, 1, 1))
        )
        x, y, inf = r.x, r.y, r.inf
        s *= 2
    return G1AF(x, y, inf)


def _tree_sum_axis_af(p: G1AF, L: int, pre: int, b: int, post: int) -> G1AF:
    """Halving tree reduction over the middle axis of a (rows, pre, b, post)
    lane view. Work ~2x one full-width add."""
    x, y, inf = p.x, p.y, p.inf
    while b > 1:
        half = b // 2

        def split(a, rows):
            a4 = a.reshape(rows, pre, b, post)
            return (
                a4[:, :, :half].reshape(rows, -1),
                a4[:, :, half:].reshape(rows, -1),
            )

        (xl, xh) = split(x, L)
        (yl, yh) = split(y, L)
        (il, ih) = split(inf, 1)
        s = ga.add_pairs(G1AF(xl, yl, il), G1AF(xh, yh, ih))
        x, y, inf, b = s.x, s.y, s.inf, half
    return G1AF(x, y, inf)


def _first_bucket_af(p: G1AF, w: int, b: int) -> G1AF:
    L = p.x.shape[0]
    return G1AF(
        p.x.reshape(L, w, b)[:, :, 0],
        p.y.reshape(L, w, b)[:, :, 0],
        p.inf.reshape(1, w, b)[:, :, 0],
    )


def _weighted_bucket_sum_af(p: G1AF, w: int, b: int) -> G1AF:
    """sum_i (i+1) * S_i per window -> (L, w) window totals.

    Chunked formulation: with i = hi*G + lo,
      sum (i+1) S_i = G * sum_hi hi*A_hi + sum_lo (lo+1)*B_lo,
    where A_hi/B_lo are tree sums over the other sub-axis: the big-width
    work is two tree reductions instead of 2*log2(b) full-width adds.
    """
    L = p.x.shape[0]
    if b <= 64:
        q = _scan_add_buckets_af(p, w, b)
        q = _scan_add_buckets_af(q, w, b)
        return _first_bucket_af(q, w, b)
    g = (b.bit_length() - 1) // 2
    G = 1 << g
    H = b // G
    A = _tree_sum_axis_af(p, L, w * H, G, 1)            # (L, w*H)
    B = _tree_sum_axis_af(p, L, w, H, G)                # (L, w*G)

    def shift_left(a, rows, fill):
        a3 = a.reshape(rows, w, H)
        tail = torch.full((rows, w, 1), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a3[:, :, 1:], tail], dim=2).reshape(rows, -1)

    # X = sum_hi hi * A_hi == sum_k (k+1) * A[k+1]  (shift A left by one)
    A1 = G1AF(
        shift_left(A.x, L, 0), shift_left(A.y, L, 0), shift_left(A.inf, 1, 1)
    )
    X = _scan_add_buckets_af(A1, w, H)
    X = _scan_add_buckets_af(X, w, H)
    X = _first_bucket_af(X, w, H)                       # (L, w)
    Y = _scan_add_buckets_af(B, w, G)
    Y = _scan_add_buckets_af(Y, w, G)
    Y = _first_bucket_af(Y, w, G)                       # (L, w)
    for _ in range(g):                                  # G * X
        X = ga.double_af(X)
    return ga.add_pairs(X, Y)


# ---------------------------------------------------------------------------
# projective pipeline: complete adds on G1LF lanes, no inversion
# ---------------------------------------------------------------------------


def _shift_buckets(p: G1LF, w: int, b: int, s: int) -> G1LF:
    """Shift the bucket axis of a (L, w * b) lane view left by s; the
    identity (0, 1, 0) enters at the end of each window."""
    L = p.x.shape[0]
    ident = gf.identity_lf(1, device=p.x.device)

    def sh(a, fill):
        tail = fill.reshape(L, 1, 1).expand(L, w, s)
        return torch.cat([a.reshape(L, w, b)[:, :, s:], tail], dim=2).reshape(L, -1)

    return G1LF(sh(p.x, ident.x), sh(p.y, ident.y), sh(p.z, ident.z))


def _scan_add_buckets(p: G1LF, w: int, b: int) -> G1LF:
    """Hillis-Steele suffix scan along the bucket axis:
    out[b'] = sum_{k >= b'} p[k] within each window."""
    s = 1
    while s < b:
        p = gf.add_lf(p, _shift_buckets(p, w, b, s))
        s *= 2
    return p


def _tree_sum_axis(p: G1LF, L: int, pre: int, b: int, post: int) -> G1LF:
    """Halving tree reduction over the middle axis of a (L, pre, b, post)
    lane view. Work ~2x one full-width add."""
    while b > 1:
        half = b // 2
        lo = G1LF(*(a.reshape(L, pre, b, post)[:, :, :half].reshape(L, -1) for a in p))
        hi = G1LF(*(a.reshape(L, pre, b, post)[:, :, half:].reshape(L, -1) for a in p))
        p, b = gf.add_lf(lo, hi), half
    return p


def _first_bucket(p: G1LF, w: int, b: int) -> G1LF:
    L = p.x.shape[0]
    return G1LF(*(a.reshape(L, w, b)[:, :, 0] for a in p))


def _weighted_bucket_sum(p: G1LF, w: int, b: int) -> G1LF:
    """sum_i (i+1) * S_i per window -> (L, w) window totals; the chunked
    formulation of `_weighted_bucket_sum_af` on projective lanes."""
    L = p.x.shape[0]
    if b <= 64:
        q = _scan_add_buckets(p, w, b)
        q = _scan_add_buckets(q, w, b)
        return _first_bucket(q, w, b)
    g = (b.bit_length() - 1) // 2
    G = 1 << g
    H = b // G
    A = _tree_sum_axis(p, L, w * H, G, 1)               # (L, w*H)
    B = _tree_sum_axis(p, L, w, H, G)                   # (L, w*G)
    # X = sum_hi hi * A_hi == sum_k (k+1) * A[k+1]  (shift A left by one)
    X = _scan_add_buckets(_shift_buckets(A, w, H, 1), w, H)
    X = _scan_add_buckets(X, w, H)
    X = _first_bucket(X, w, H)                          # (L, w)
    Y = _scan_add_buckets(B, w, G)
    Y = _scan_add_buckets(Y, w, G)
    Y = _first_bucket(Y, w, G)                          # (L, w)
    for _ in range(g):                                  # G * X
        X = gf.double_lf(X)
    return gf.add_lf(X, Y)


def _accumulate_buckets(sorted_pt, sorted_sign, table, lane_start, lane_stride,
                        lane_count, rounds: int, m_exp: int) -> G1LF:
    """The round loop, projective: round j mixed-adds the j-th point of every
    lane's segment. No tail balancing on this path."""
    L = table.shape[1] // 2
    acc = gf.identity_lf(lane_start.shape[0], device=table.device)
    for j in range(rounds):
        pos = torch.clamp(lane_start + j * lane_stride, max=m_exp - 1)
        valid = (j < lane_count).to(STORE)
        coords = table[sorted_pt[pos]].T.contiguous()       # (2L, lanes)
        acc = gf.add_sel_lf(acc, coords[:L], coords[L:], sorted_sign[pos], valid)
    return acc


def _merge_top_windows(acc: G1LF, merge_masks, src_np, keep_np, half: int,
                       k: int = 1) -> G1LF:
    """Top-window merge/reshuffle, projective. `half` is the lane count of
    one window, `k` the number of MSMs."""
    dev = acc.x.device
    # merge the top windows' sub-accumulators: log2(s) masked adds over those
    # windows' lanes alone (the last `half` lanes of each MSM's grid; no
    # other lane has a partner)
    if len(merge_masks):
        top = G1LF(*(_top_windows(a, k, half) for a in acc))
        sign = torch.zeros((1, k * half), dtype=STORE, device=dev)
        shift = 1
        for mask_np in merge_masks:
            idx = _merge_partner_idx(k, half, shift, dev)
            partner = G1LF(*(a[:, idx] for a in top))
            mask = _top_windows(torch.from_numpy(mask_np).to(dev)[None, :], k, half)
            top = gf.add_sel_proj_lf(top, partner, sign, mask)
            shift *= 2
        ident = gf.identity_lf(1, device=dev)
        src = torch.from_numpy(src_np).to(dev)
        keep = torch.from_numpy(keep_np).to(dev)[None, :] != 0
        acc = G1LF(*(
            torch.where(keep, _put_top_windows(a, t, k, half)[:, src], i)
            for a, t, i in zip(acc, top, ident)
        ))
    return acc


def _use_affine() -> bool:
    return config.MSM_AFFINE_MODE not in ("0", "false")


def msm_windows(scalars_raw: torch.Tensor, table: torch.Tensor, c: int) -> G1LF:
    """Per-window MSM totals: G1LF with batch axis = window index (W lanes).

    scalars_raw: (N, FR_LIMBS) int32 standard-form 16-bit limbs (lazy < 2r
    allowed: the group order absorbs +r and the digits cover 254 bits).
    table: (N, 2L) gather table from `make_table`, on the same device.
    One MSM is a batch of one: the same code as `msm_windows_batch`.
    """
    return msm_windows_batch(scalars_raw[None], table, c)


def msm_windows_batch(scalars_raw: torch.Tensor, table: torch.Tensor, c: int) -> G1LF:
    """Multi-MSM over a SHARED point table: k MSMs in one bucket pipeline.

    scalars_raw: (k, N, FR_LIMBS) int32 standard-form limbs; table: (N, 2L).
    Returns G1LF with batch axis k * W (MSM-major): lane p * W + w holds MSM
    p's window-w total.

    The batch rides the one-global-sort formulation: the MSM's index joins
    the sort key above (window, |digit|), so the k MSMs share every round's
    add across k * W * 2^(c-1) lanes. The round count is the largest
    segment over ALL k MSMs (about a single MSM's), read back once for the
    whole batch, while the lanes of a launch grow k-fold. Keys are int64
    (`torch.sort(stable=True)` is exact on them); sign and point index are
    permuted apart from the key.
    """
    k, n = scalars_raw.shape[0], scalars_raw.shape[1]
    assert table.shape[0] == n
    dev = table.device
    w_total = _nwin(c)
    half = 1 << (c - 1)
    m_exp = k * w_total * n  # expanded (MSM, window, point) triples
    affine = _use_affine()

    with prof.stage("msm/setup"):
        digits = signed_digits(scalars_raw, c)  # (k, W, N) int32
        mag = digits.abs().to(torch.int64)
        sign = (digits < 0).to(STORE)

        ids = torch.arange(k * w_total, dtype=torch.int64, device=dev).repeat_interleave(n)
        keys = _sort_keys(ids // w_total, ids % w_total, mag.reshape(-1), c)
        pt_ids = torch.arange(n, dtype=torch.int64, device=dev).repeat(k * w_total)
        sorted_keys, perm = torch.sort(keys, stable=True)
        sorted_pt = pt_ids[perm]
        sorted_sign = sign.reshape(-1)[perm]

        lane_start, lane_stride, lane_count, merge_masks, src_np, keep_np, _s = (
            _bucket_grid(sorted_keys, c, w_total, k)
        )
        # tail balancing on the batch-affine path only
        start, stride, count, spares = _spare_split(lane_start, lane_stride, lane_count,
                                                    balance=affine)
        rounds = _round_count(count)
    grid = (sorted_pt, sorted_sign, table, start, stride, count, rounds, m_exp)
    with prof.stage("msm/rounds"):
        acc = _accumulate_buckets_af(*grid) if affine else _accumulate_buckets(*grid)
    with prof.stage("msm/reduce"):
        if affine:
            buckets = _merge_top_windows_af(_merge_spares_af(acc, lane_start.shape[0], spares),
                                            merge_masks, src_np, keep_np, half, k)
            return ga.to_lf(_weighted_bucket_sum_af(buckets, k * w_total, half))
        buckets = _merge_top_windows(acc, merge_masks, src_np, keep_np, half, k)
        return _weighted_bucket_sum(buckets, k * w_total, half)


def _combine_device(windows: G1LF, c: int) -> G1Points:
    """Horner window combine on the device (c doublings + 1 add per
    window)."""
    wp = gf.to_points(windows)  # (W, L) limbs-last
    acc = g1.identity((), device=wp.x.device)
    for w in reversed(range(wp.x.shape[0])):
        for _ in range(c):
            acc = g1.double(acc)
        acc = g1.add(acc, G1Points(wp.x[w], wp.y[w], wp.z[w]))
    return acc


def msm(scalars_raw: torch.Tensor, points: G1Points, c: int | None = None,
        device=None) -> G1Points:
    """MSM sum_i scalars[i] * points[i], fully on the device.

    scalars_raw: (N, FR_LIMBS) int32, standard (non-Montgomery) form.
    points: affine-encoded batch (z == 1, or z == 0 for identity fillers).
    Returns a single projective point (batch shape ()), canonical limbs.
    """
    device = limbs.resolve_device(device)
    if c is None:
        c = auto_c(scalars_raw.shape[0])
    table = make_table(G1Points(*(a.to(device) for a in points)))
    return _combine_device(msm_windows(scalars_raw.to(device), table, c=c), c)


def horner_windows_host(pts, c: int):
    """Window totals [(x, y) | None], lowest window first -> their Horner
    combination on host bigints."""
    from ..reference.curve import G1

    acc = None
    for p in reversed(pts):
        for _ in range(c):
            acc = G1.double(acc)
        acc = G1.add(acc, p)
    return acc


def combine_windows_host(windows: G1LF, c: int, k: int = 1) -> list:
    """Per-window totals of k MSMs (batch axis k * W, MSM-major) -> the k
    host affine points: one normalize and one device->host read of all
    k * W totals (`gf.decode_lf`), then a Horner combine on host bigints for
    each MSM. The one host combine of `msm_fast_host`, `msm_batch_host` and
    `kzg.commit_many_lf`, timed and marked as the stage `msm/combine_host`
    (the decode inside it: the card falls idle while the host waits there).
    """
    with prof.stage("msm/combine_host"):
        pts = gf.decode_lf(windows)
        w_total = len(pts) // k
        return [horner_windows_host(pts[p * w_total : (p + 1) * w_total], c)
                for p in range(k)]


def msm_fast_host(scalars_raw: torch.Tensor, table: torch.Tensor, c: int | None = None):
    """Device bucket pipeline + host window combine -> host affine point.

    The path the prover takes: commitments are decoded for the Fiat-Shamir
    transcript anyway, and the ~250-doubling window-combine chain is cheaper
    as host bigint math than as sequential device launches.
    """
    if c is None:
        c = auto_c(scalars_raw.shape[0])
    return combine_windows_host(msm_windows(scalars_raw, table, c=c), c)[0]


def msm_batch_host(scalars_raw: torch.Tensor, table: torch.Tensor, c: int | None = None):
    """k MSMs over one table -> k host affine points (one device bucket
    pipeline for the batch, then `combine_windows_host` over all k * W
    window totals)."""
    k = scalars_raw.shape[0]
    if c is None:
        c = auto_c(scalars_raw.shape[1])
    # the reference packs its sort key into 32 bits; the port's keys are
    # int64 and would hold more, but both take the same batches
    assert c + 8 + k.bit_length() <= 32, "sort key packing overflow"
    return combine_windows_host(msm_windows_batch(scalars_raw, table, c=c), c, k)


def msm_host(scalars, points_affine, c: int | None = None, device=None):
    """Convenience host wrapper: python ints / host points -> host point."""
    device = limbs.resolve_device(device)
    sc = limbs.to_tensor(
        limbs.ints_to_limbs([s % params.R for s in scalars], params.FR_LIMBS), device
    )
    pts = g1.encode_points(points_affine, device=device)
    return msm_fast_host(sc, make_table(pts), c=c)
