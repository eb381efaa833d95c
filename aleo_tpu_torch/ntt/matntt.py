"""MatNTT: mixed-radix NTT where every multiply is an int8 matrix product.

Counterpart of the JAX package's `ntt/matntt.py`, same names; the path of
every power-of-two transform of `config.MATNTT_MIN_N` lanes and more. The
transform is a decimation-in-frequency mixed-radix decomposition
n = d1 * d2 * ... * ds (radices <= 64) where

  * each radix-d stage is ONE limb-blocked int8 product (fields/fmat.dft_apply):
    the DFT_d matrix's constants are folded into a (76d x 38d) int8 matrix,
    so the stage's muls AND butterfly adds all run on the tensor cores,
  * inter-stage twiddles w^{k*j} are batched Toeplitz constant-mul products;
    when the natural lane sharing is too narrow (early depths of a single
    transform) the exponent k*j is SPLIT j = hi*S + lo into two factors,
    each shared across >= 128 lanes,
  * coset scalings g^j factor over the digit axes of j (one tiny Toeplitz
    bank per digit), and the n^-1 of the inverse transform is folded into
    the depth-1 DFT matrix for free.

Data flow: (16, n) int32 16-bit Montgomery limbs -> pack7 -> s stages of
[DFT product -> Montgomery reduce -> twiddle products] -> digit-reversal
transpose -> unpack7. The 2^256 Montgomery form factor of the 16-bit
pipeline passes through unchanged (all constants carry fmat's R7 factor).
Every product ends in `fmat.mont_reduce_cols`, which on the GPU is the one
kernel `fmat_reduce`.

The plans are host numpy arrays, equal to the reference's byte for byte;
each plan keeps its banks as tensors on the devices that used them, so a
second transform of the same (n, direction, shift) uploads nothing. Each
`permute` + `reshape` below is one int8 copy of the (38, n) data.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params
from ..fields import fmat
from ..reference.field import fr_root_of_unity

R = params.R
L7 = fmat.L7

MIN_LANES = 128        # below this, twiddle exponents are split


def _factorize(n: int) -> list:
    """n = prod(dims), radices <= 64, balanced, fewest stages.

    Stage count dominates cost (each stage pays a fixed carry/reduce
    budget), so radices go up to 64 (column sums stay < 2^26, see fmat);
    balancing keeps the per-stage products similar sizes.
    """
    k = n.bit_length() - 1
    s = max(1, -(-k // 6))
    base, rem = divmod(k, s)
    return [1 << (base + 1)] * rem + [1 << base] * (s - rem)


def _dft_matrix(d: int, root: int, scale: int = 1) -> list:
    """DFT_d matrix entries [r][m] = root^(r*m) * scale (plain ints mod R)."""
    return [[pow(root, r * m, R) * scale % R for m in range(d)] for r in range(d)]


MAX_TW_BATCH = 4096   # Toeplitz batch cap, the reference's


def _plan_groups(d: int, m_next: int, bpre: int) -> list:
    """Split jrest's log2(m_next) bits into groups sized so each factor's
    Toeplitz product has B = d*2^g <= MAX_TW_BATCH and, where achievable,
    lanes = bpre * m_next / 2^g >= MIN_LANES."""
    total = m_next.bit_length() - 1
    if total == 0:
        return []
    cap_batch = max(1, (MAX_TW_BATCH // d).bit_length() - 1)
    lane_bits = (bpre * m_next).bit_length() - 1
    cap_lanes = max(1, lane_bits - (MIN_LANES.bit_length() - 1))
    gmax = max(1, min(cap_batch, cap_lanes))
    n_groups = -(-total // gmax)
    base, rem = divmod(total, n_groups)
    return [base + 1] * rem + [base] * (n_groups - rem)


class _DeviceBanks:
    """Host banks with lazy per-device tensor copies."""

    def dev(self, key, host_arr, device, dtype=torch.int8) -> torch.Tensor:
        """The bank `host_arr` on `device`, uploaded at its first use there.
        Toeplitz banks are kept as float32 (the type of their product)."""
        k = (key, str(device), dtype)
        if k not in self._dev:
            self._dev[k] = torch.from_numpy(host_arr).to(device=device, dtype=dtype)
        return self._dev[k]


class Plan(_DeviceBanks):
    """Host-precomputed banks for one (n, inverse, fold_scale) transform."""

    def __init__(self, n: int, inverse: bool, fold_scale: int = 1):
        self.n = n
        self.dims = _factorize(n)
        w = fr_root_of_unity(n)
        if inverse:
            w = pow(w, -1, R)
        self.w = w
        self._dev = {}
        # depth-1 DFT folds the caller's scale (n^-1 for inverse transforms)
        self.dft_banks = []
        for i, d in enumerate(self.dims):
            root_d = pow(w, n // d, R)
            scale = fold_scale if i == 0 else 1
            self.dft_banks.append(
                fmat.dft_bank_np(_dft_matrix(d, root_d, scale))
            )
        # Twiddle banks per depth. The exponent k*j over (d, m_next) is split
        # into factors over bit-groups of j so every Toeplitz product gets a
        # well-shaped batch (B = d*2^g <= MAX_TW_BATCH) and enough lanes
        # (bpre * m_next / 2^g >= MIN_LANES where achievable).
        self.tw = []
        m_i = n
        bpre = 1
        for i, d in enumerate(self.dims[:-1]):
            m_next = m_i // d
            root = pow(w, n // m_i, R)           # w_{m_i}
            groups = _plan_groups(d, m_next, bpre)
            factors = []
            stride_bits = m_next.bit_length() - 1
            for g in groups:
                stride_bits -= g
                consts = [
                    pow(root, k * (j << stride_bits), R)
                    for k in range(d)
                    for j in range(1 << g)
                ]
                factors.append(fmat.toeplitz_bank_np(consts))
            self.tw.append((tuple(groups), factors))
            m_i = m_next
            bpre *= d


@functools.lru_cache(maxsize=24)
def plan(n: int, inverse: bool, fold_scale: int = 1) -> Plan:
    return Plan(n, inverse, fold_scale)


class ScalePlan(_DeviceBanks):
    """Digit-factored elementwise scaling by base^j (coset shifts)."""

    def __init__(self, n: int, base: int, dims: tuple):
        self.dims = dims
        self.banks = []
        self._dev = {}
        stride = n
        for d in dims:
            stride //= d
            self.banks.append(
                fmat.toeplitz_bank_np([pow(base, j * stride, R) for j in range(d)])
            )


@functools.lru_cache(maxsize=24)
def scale_plan(n: int, base: int, dims: tuple) -> ScalePlan:
    return ScalePlan(n, base, dims)


# ---------------------------------------------------------------------------
# device transform
# ---------------------------------------------------------------------------


def _dft_stage(x: torch.Tensor, bank: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply one radix-d DFT product along `axis` of (L7, d1.., d, ..) data."""
    d = x.shape[axis]
    x = x.movedim(axis, 1)
    shape = x.shape
    y2 = fmat.dft_apply(bank, x.reshape(L7 * d, -1), d)
    return y2.reshape(shape).movedim(1, axis)


def _toeplitz_over(x: torch.Tensor, bank: torch.Tensor, const_axes: tuple) -> torch.Tensor:
    """Multiply x (L7, ...) by the bank whose constants are indexed by
    `const_axes` (row-major); every other axis is lanes."""
    lane_axes = tuple(a for a in range(1, x.dim()) if a not in const_axes)
    perm = const_axes + (0,) + lane_axes
    xt = x.permute(perm)
    B = int(np.prod([x.shape[a] for a in const_axes]))
    # the transposing copy also casts to the product's float32
    xf = torch.empty(xt.shape, dtype=torch.float32, device=x.device).copy_(xt)
    y = fmat.toeplitz_apply(bank, xf.reshape(B, L7, -1))
    return y.reshape(xt.shape).permute(tuple(int(a) for a in np.argsort(perm)))


def _tw_multi(x, groups, banks, depth):
    """Twiddle at `depth` as a product of bit-group factors.

    x viewed as (L7, pre, d, 2^g1, ..., 2^gz): factor i's constants depend
    on (d, group_i); all other axes are its lanes. Each factor is one
    batched Toeplitz const-mul at a planner-guaranteed shape."""
    shape = x.shape
    d = shape[depth + 1]
    pre = int(np.prod(shape[1 : depth + 1])) if depth else 1
    xg = x.reshape((L7, pre, d) + tuple(1 << g for g in groups))
    for i in range(len(groups)):
        xg = _toeplitz_over(xg, banks[i], (2, 3 + i))
    return xg.reshape(shape)


def _scale_digits(x: torch.Tensor, sp: ScalePlan, lead: int = 1) -> torch.Tensor:
    """Elementwise scale by base^j via one Toeplitz mul per digit axis.

    `lead` = number of leading non-digit axes after the limb axis (1 when a
    batch axis precedes the digit axes)."""
    for i in range(len(sp.dims)):
        bank = sp.dev(i, sp.banks[i], x.device, torch.float32)
        x = _toeplitz_over(x, bank, (lead + i,))
    return x


def transform7(x7: torch.Tensor, p: Plan, batch: int = 1) -> torch.Tensor:
    """Core transform on (L7, [batch,] n) int8 limbs -> same, natural order.

    A leading batch axis (between limbs and digits) rides along as extra
    "pre" lanes for every stage: the twiddle factors only get wider-lane
    (better-shaped) products out of it.
    """
    n = p.n
    dims = p.dims
    dev = x7.device
    x = x7.reshape((L7, batch) + tuple(dims))
    for i, d in enumerate(dims):
        x = _dft_stage(x, p.dev(("dft", i), p.dft_banks[i], dev), axis=2 + i)
        if i < len(dims) - 1:
            groups, factors = p.tw[i]
            banks = [
                p.dev(("tw", i, j), f, dev, torch.float32)
                for j, f in enumerate(factors)
            ]
            x = _tw_multi(x, groups, banks, depth=i + 1)
    # output digit-reversal: position (k1..ks) holds X[k1 + d1*(k2 + ...)]
    s = len(dims)
    x = x.permute((0, 1) + tuple(range(s + 1, 1, -1)))
    return x.reshape((L7, batch, n) if batch > 1 else (L7, n))


# ---------------------------------------------------------------------------
# public API: (16, n) int32 16-bit Montgomery limbs, lazy in/out, or
# (16, k, n) for k transforms side by side (the layout of `fields.fr_lf`'s
# batch axes). The plans of one (n, direction, shift) are cached with their
# device banks.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=96)
def _plans(n: int, inverse: bool, shift: int | None):
    ninv = pow(n, -1, R) if inverse else 1
    p = plan(n, inverse, ninv)
    sp = None
    if shift is not None:
        base = shift if not inverse else pow(shift, -1, R)
        sp = scale_plan(n, base, tuple(p.dims))
    return p, sp


def _run(x16: torch.Tensor, inverse: bool, shift: int | None):
    """x16: (16, [batch,] n) -> the same shape, transformed."""
    batch = x16.shape[1] if x16.dim() == 3 else 1
    p, sp = _plans(x16.shape[-1], inverse, shift)
    bshape = (L7, batch) + tuple(p.dims)
    x7 = fmat.pack7(x16)
    if sp is not None and not inverse:
        x7 = _scale_digits(x7.reshape(bshape), sp, lead=2).reshape(x7.shape)
    out7 = transform7(x7, p, batch=batch)
    if sp is not None and inverse:
        out7 = _scale_digits(out7.reshape(bshape), sp, lead=2).reshape(out7.shape)
    return fmat.unpack7(out7).reshape(x16.shape)


def ntt_lf16(x16: torch.Tensor) -> torch.Tensor:
    return _run(x16, False, None)


def intt_lf16(x16: torch.Tensor) -> torch.Tensor:
    return _run(x16, True, None)


def coset_ntt_lf16(x16: torch.Tensor, shift: int) -> torch.Tensor:
    return _run(x16, False, shift)


def coset_intt_lf16(x16: torch.Tensor, shift: int) -> torch.Tensor:
    return _run(x16, True, shift)


# -- batched API: x16 (k, 16, n) int32, the batch prover's array layout -------


def _batched(x16: torch.Tensor, inverse: bool, shift: int | None) -> torch.Tensor:
    # (k, 16, n) -> (16, k, n): limbs leading for pack7; back at the end
    out = _run(x16.transpose(0, 1), inverse, shift)
    return out.transpose(0, 1).contiguous()


def ntt_batch_lf16(x16: torch.Tensor) -> torch.Tensor:
    return _batched(x16, False, None)


def intt_batch_lf16(x16: torch.Tensor) -> torch.Tensor:
    return _batched(x16, True, None)


def coset_ntt_batch_lf16(x16: torch.Tensor, shift: int) -> torch.Tensor:
    return _batched(x16, False, shift)


def coset_intt_batch_lf16(x16: torch.Tensor, shift: int) -> torch.Tensor:
    return _batched(x16, True, shift)
