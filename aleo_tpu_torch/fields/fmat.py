"""Fr field ops as int8 matrix products (7-bit limbs): MatNTT's compute core.

Counterpart of the JAX package's `fields/fmat.py`, same names. Every
constant-by-variable multiplication of the NTT is an integer matrix product:

  * DFT matrices  -> one "limb-blocked" int8 product per radix stage,
  * twiddle/coset tables -> batched Toeplitz constant-mul products,
  * Montgomery reduction -> two band products and three carries, which on
    a CUDA tensor are ONE hand-written kernel (`fmat_kernels.mont_reduce8`).

Representation: a field element batch is (L7, ...) int8, 38 little-endian
7-bit limbs (axis 0), value < 2^266 = R7 (the Montgomery radix of this
module). Constants are stored in R7-Montgomery form (c * R7 mod p), so each
product's Montgomery reduction by R7 preserves whatever external form the
variable data carries: the 16-bit pipeline's 2^256 form flows through
unchanged, and only limb REPACKING happens at the module's boundaries.

Why 7-bit limbs: band-matrix entries and data limbs must fit int8 (<= 127);
products are 14-bit and column sums stay < 2^26 under a convolution width of
38 and radix <= 64, far from int32 overflow.

Why L7 = 38 (266 bits) for a 253-bit prime: a product accumulates up to 64
unreduced terms, so a single Montgomery reduction leaves u < t/R7 + p; with
R7 >= 2^13 * p the lazy bound converges to < 1.1p and always fits 38 limbs.

The two large products are library calls, as the reference leaves them to
its compiler: `torch._int_mm` for a DFT stage (int8 in, int32 sums; float32
would not be exact, a column sum reaches 38 * 64 * 127^2 > 2^24) and a
float32 `torch.bmm` for the Toeplitz batches (every sum <= 38 * 127^2 <
2^24, so float32 is exact whatever the TF32 setting: the inputs have 7
bits). The host-side bank functions give the reference's arrays byte for
byte, made with numpy indexing instead of Python loops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config, params
from . import limbs

LIMB_BITS = 7
BASE = 1 << LIMB_BITS
L7 = 38                      # limbs per element
K7 = 2 * L7                  # convolution columns
R7 = 1 << (LIMB_BITS * L7)   # Montgomery radix 2^266

P = params.R                 # the Fr modulus (snarkVM scalar field)
assert (1 << 13) * P <= R7, "lazy accumulation bound needs R7 >= 2^13 p"
NPRIME = (-pow(P, -1, R7)) % R7
R7_MOD = R7 % P

_NBYTES = (LIMB_BITS * L7 + 7) // 8      # 34 bytes hold 266 bits
_WEIGHTS = (1 << np.arange(LIMB_BITS)).astype(np.uint8)


# ---------------------------------------------------------------------------
# host-side packing / band matrices (numpy)
# ---------------------------------------------------------------------------


def to7_np(xs) -> np.ndarray:
    """Host ints (< R7) -> (N, L7) int8 limbs (little-endian)."""
    xs = [int(x) for x in xs]
    assert all(0 <= x < R7 for x in xs)
    if not xs:
        return np.zeros((0, L7), dtype=np.int8)
    buf = b"".join(x.to_bytes(_NBYTES, "little") for x in xs)
    bits = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), _NBYTES),
        axis=1, bitorder="little",
    )[:, : LIMB_BITS * L7]
    return (bits.reshape(len(xs), L7, LIMB_BITS) @ _WEIGHTS).astype(np.int8)


def from7_np(a: np.ndarray):
    """(..., K) limbs in [0, 127] -> object array of host ints."""
    a = np.asarray(a, dtype=np.int64)
    assert a.size == 0 or (a.min() >= 0 and a.max() < BASE)
    flat = a.reshape(-1, a.shape[-1]).astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(LIMB_BITS, dtype=np.uint8)) & 1
    packed = np.packbits(bits.reshape(flat.shape[0], -1), axis=1, bitorder="little")
    out = np.empty(flat.shape[0], dtype=object)
    for n, row in enumerate(packed):
        out[n] = int.from_bytes(row.tobytes(), "little")
    return out.reshape(a.shape[:-1])


def _band_index(out_cols: int):
    """(k - j) clipped into [0, L7) and the mask 0 <= k - j < L7, both
    (out_cols, L7): entry [k, j] of a Toeplitz band reads limb k - j."""
    diff = np.arange(out_cols)[:, None] - np.arange(L7)[None, :]
    mask = (diff >= 0) & (diff < L7)
    return np.clip(diff, 0, L7 - 1), mask


def band_np(c: int, out_cols: int) -> np.ndarray:
    """Toeplitz band W[k, j] = limb_{k-j}(c): conv-by-c as a matrix product."""
    idx, mask = _band_index(out_cols)
    return np.where(mask, to7_np([c])[0][idx], 0).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _reduce_mats():
    """(Wnp (L7, L7), Wp (K7, L7)) numpy int8: the two constant matrices of
    the R7-Montgomery reduction (m = t*N' mod R7; u = (t + m*p)/R7)."""
    Wnp = band_np(NPRIME, L7)
    Wp = band_np(P, K7)
    return Wnp, Wp


def toeplitz_bank_np(consts) -> np.ndarray:
    """Constants (plain ints mod p) -> (B, K7, L7) int8 Toeplitz bank for a
    batched Montgomery const-mul. Entries carry the R7 form factor so the
    reduction preserves the variable operand's external form."""
    digits = to7_np([c % P * R7_MOD % P for c in consts])        # (B, L7)
    idx, mask = _band_index(K7)
    return np.where(mask[None], digits[:, idx], 0).astype(np.int8)


def dft_bank_np(mat) -> np.ndarray:
    """DFT matrix (R x M plain ints mod p) -> big int8 matrix of shape
    (K7 * R, L7 * M), row index k*R + r, col index j*M + m, matching the
    natural ravel of (L7, M, T) limbs-first data and (K7, R, T) output.

    Y[(k, r), t] = sum_{(j, m)} limb_{k-j}(mat[r][m] * R7) * X[(j, m), t]
    computes the raw 76-column convolution sums of sum_m mat[r][m]*x[m] for
    every lane t: the whole radix-R DFT stage as ONE int8 product.
    """
    Rr, M = len(mat), len(mat[0])
    flat = [int(v) % P * R7_MOD % P for row in mat for v in row]
    digits = to7_np(flat).reshape(Rr, M, L7)
    idx, mask = _band_index(K7)
    A = np.where(mask, digits[:, :, idx], 0).astype(np.int8)      # (Rr, M, K7, L7)
    return np.ascontiguousarray(A.transpose(2, 0, 3, 1)).reshape(K7 * Rr, L7 * M)


# ---------------------------------------------------------------------------
# device ops (plain PyTorch; on a CUDA tensor the carries and the fused
# reduction are the kernels of fmat_kernels.py)
# ---------------------------------------------------------------------------


def _shift_down(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Shift rows toward higher indices along `axis`, zero-filling."""
    keep = x.narrow(axis, 0, x.shape[axis] - s)
    pad = torch.zeros_like(x.narrow(axis, 0, s))
    return torch.cat([pad, keep], dim=axis)


def carry_cols(cols: torch.Tensor, peels: int = 4, axis: int = 0) -> torch.Tensor:
    """Normalize int32 column sums (< 2^26) to 7-bit limbs along `axis`.

    `peels` magnitude-reduction rounds bring values <= 255, then an exact
    Kogge-Stone generate/propagate pass resolves the remaining ripple
    chains. Carry out of the top position is dropped (callers' range
    analysis guarantees it is absent). Returns int32 in [0, 127]. This is
    the plain version of the carry kernels (`fmat_kernels.carry8`). The
    Kogge-Stone pass stops once no propagate run is left (further steps
    would change nothing): random columns need two or three of its seven
    steps, which is most of this function's time on the CPU.
    """
    K = cols.shape[axis]
    x = cols
    for _ in range(peels):
        lo = x & (BASE - 1)
        hi = x >> LIMB_BITS
        x = lo + _shift_down(hi, 1, axis)
    d = x & (BASE - 1)
    g = x >> LIMB_BITS                       # in {0, 1} after peels
    prop = (d == BASE - 1).to(torch.int32)
    sh = 1
    while sh < K and bool(prop.any()):
        g = g | (prop & _shift_down(g, sh, axis))
        prop = prop & _shift_down(prop, sh, axis)
        sh *= 2
    out = d + _shift_down(g, 1, axis)
    return out & (BASE - 1)


@functools.lru_cache(maxsize=None)
def _reduce_mats_dev(device_str: str):
    """(Wnp, Wp) of `_reduce_mats` as float32 tensors on a device, made once."""
    dev = torch.device(device_str)
    return tuple(
        torch.from_numpy(W).to(device=dev, dtype=torch.float32) for W in _reduce_mats()
    )


def _band_dot(W: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract the columns of the float32 band W with `axis` of int8 limbs x
    -> int32 sums with the limb axis back at `axis`. float32 is exact: every
    sum is <= 38 * 127^2 < 2^24."""
    y = torch.tensordot(W, x.to(torch.float32), dims=([1], [axis]))
    return y.movedim(0, axis).to(torch.int32)


def mont_reduce_cols(t_cols: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Montgomery-reduce raw convolution columns (K7 wide along `axis`).

    The limb axis is independent of every other axis (the dft_bank layout is
    limb-major), so the N'/p reduction products contract just the limb axis
    with the globally shared Wnp/Wp band matrices. Returns int8 limbs
    (L7 along `axis`), values < 1.1p.

    With `config.FUSED_REDUCE` (the default) a 2-D limb-leading tensor goes
    to `fmat_kernels.mont_reduce8`: on the GPU the whole chain (3 carries +
    2 band products) is one kernel, one int32 read and one int8 write per
    column. Otherwise the chain below runs with `fmat_kernels.carry8` for
    its three carries.
    """
    from . import fmat_kernels

    if t_cols.dim() == 2 and axis == 0 and config.FUSED_REDUCE:
        return fmat_kernels.mont_reduce8(t_cols)
    Wnp, Wp = _reduce_mats_dev(str(t_cols.device))
    t_lo = fmat_kernels.carry8(t_cols, 4, axis).narrow(axis, 0, L7)
    m = fmat_kernels.carry8(_band_dot(Wnp, t_lo, axis), 3, axis)
    u_cols = _band_dot(Wp, m, axis) + t_cols
    u = fmat_kernels.carry8(u_cols, 4, axis)
    return u.narrow(axis, L7, L7).contiguous()


def dft_apply(bank: torch.Tensor, x: torch.Tensor, E_out: int) -> torch.Tensor:
    """One radix stage: x (L7*E_in, T) int8 -> (L7*E_out, T) int8.

    bank: (K7*E_out, L7*E_in) int8 from dft_bank_np (limb-major rows). The
    product computes raw field-matmul columns; the reduction sees them as
    (K7, E_out*T), a free reshape in this layout. `torch._int_mm` raises
    on a shape it does not take (on a CUDA tensor: more than 16 rows, inner
    and lane sizes multiples of 8); nothing stands in for it.
    """
    T = x.shape[-1]
    x = x.contiguous()
    if x.stride() != (T, 1):
        # a single lane (T = 1) counts as contiguous whatever its row stride
        # is, and the product reads the strides: give it the plain ones
        x = x.clone(memory_format=torch.contiguous_format)
    t_cols = torch._int_mm(bank, x)
    u = mont_reduce_cols(t_cols.reshape(K7, E_out * T))
    return u.reshape(L7 * E_out, T)


def toeplitz_apply(bank: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery const-mul: x (B, L7, T) * bank (B, K7, L7), each
    int8 or float32 holding the same integers -> (B, L7, T) int8 (values
    < 1.1p).

    One batched product for the constants' convolution, then ONE copy into
    the limb-leading int32 layout (cast and transpose in the same pass) so
    the whole reduction runs on the 2-D path.
    """
    B, _, T = x.shape
    t_cols = torch.bmm(bank.to(torch.float32), x.to(torch.float32))   # (B, K7, T)
    t2 = torch.empty((K7, B, T), dtype=torch.int32, device=x.device)
    t2.copy_(t_cols.permute(1, 0, 2))
    u = mont_reduce_cols(t2.reshape(K7, B * T))          # (L7, B*T) int8
    return u.reshape(L7, B, T).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# 16-bit <-> 7-bit limb repacking (module boundary; bit-exact, form-neutral)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repack_tables(device_str: str):
    """Row indices and shifts of the two repackings, as tensors on a device.

    pack7: 7-bit limb i covers bits [7i, 7i+7), inside the 32-bit window of
    16-bit limbs (j, j+1), j = 7i // 16, at offset s = 7i % 16; limbs past
    bit 256 read a zero row (index 16 of the padded input).
    unpack7: 16-bit limb j covers bits [16j, 16j+16), inside the 28-bit
    window of 7-bit limbs i0..i0+3, i0 = 16j // 7, at offset 16j - 7*i0.
    """
    dev = torch.device(device_str)
    bit0 = np.arange(L7) * LIMB_BITS
    j = np.minimum(bit0 // 16, 16)
    i0 = (np.arange(16) * 16) // LIMB_BITS
    as_t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
    as_s = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)
    return (
        as_t(j), as_t(np.minimum(j + 1, 16)), as_s(bit0 % 16),
        [as_t(i0 + t) for t in range(4)], as_s(np.arange(16) * 16 - i0 * LIMB_BITS),
    )


def _col(v: torch.Tensor, nd: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (nd - 1))


def pack7(x16: torch.Tensor) -> torch.Tensor:
    """(16, ...) int32 16-bit limbs -> (L7, ...) int8 7-bit limbs.

    Values may be lazy (< 2p < 2^254); the raw 256-bit integer is re-sliced
    bit-exactly. Every row is gathered at once: the low limb, the next one
    shifted up 16 (the sign bit may be set; only bits below 22 are read),
    one shift and one mask.
    """
    lo_i, hi_i, s, _, _ = _repack_tables(str(x16.device))
    xp = torch.cat([x16, torch.zeros_like(x16[:1])], dim=0)
    w = xp.index_select(0, lo_i) | (xp.index_select(0, hi_i) << 16)
    return ((w >> _col(s, x16.dim())) & (BASE - 1)).to(torch.int8)


def unpack7(x7: torch.Tensor) -> torch.Tensor:
    """(L7, ...) int8 7-bit limbs -> (16, ...) int32 16-bit limbs.

    Input values < 2^256 (canonical/lazy field elements; top limbs of the
    266-bit capacity must be clear, which mont-reduced outputs guarantee).
    """
    _, _, _, idx, s = _repack_tables(str(x7.device))
    x = x7.to(torch.int32)
    w = x.index_select(0, idx[0])
    for t in range(1, 4):
        w = w | (x.index_select(0, idx[t]) << (LIMB_BITS * t))
    return (w >> _col(s, x7.dim())) & 0xFFFF


# ---------------------------------------------------------------------------
# host encode/decode (tests / standalone use)
# ---------------------------------------------------------------------------


def encode7(xs, device=None) -> torch.Tensor:
    """Host ints -> (L7, N) int8 limbs, NO form factor (raw values)."""
    a = np.ascontiguousarray(to7_np([x % P for x in xs]).T)
    return torch.from_numpy(a).to(limbs.resolve_device(device))


def decode7(a) -> list:
    """(L7, N) device limbs (raw values, possibly lazy < 2p) -> host ints."""
    vals = from7_np(a.detach().cpu().numpy().T)
    return [int(v) % P for v in vals]
