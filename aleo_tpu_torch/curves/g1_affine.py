"""Batch-affine G1 accumulation: inversion-amortized affine adds.

Counterpart of the JAX package's `curves/g1_affine.py`. The affine chord law

    lam = (y2 - y1) / (x2 - x1)
    x3  = lam^2 - x1 - x2
    y3  = lam * (x1 - x3) - y1

costs 3 muls once the denominator's inverse is known, and the inverses of a
whole lane grid are amortized with Montgomery's batch-inversion trick: the
product of each tile of INV_TILE lanes, one inversion of the <= 128 tile
products at the root, and a pushdown through each tile.

The affine law is incomplete; completeness is restored by a case code per
lane (no data-dependent control flow):

  * acc identity            -> result = +-P      (case TAKE)
  * P identity/invalid lane -> result = acc      (case KEEP)
  * x1 == x2, y1 == y2      -> tangent law: lam = 3 x1^2 / (2 y1)
                               (same x3/y3 formulas; case FORMULA)
  * x1 == x2, y1 == -y2     -> result = identity (case IDENT)

Degenerate lanes feed the batch inversion a Montgomery one, so one lane's
zero can never poison the shared product tree. Equality checks are done on
lazy (< 2p) differences by testing both representatives {0, p}.

Accumulators are `G1AF(x, y, inf)`: (L, M) int32 16-bit Montgomery limb
coordinates (lazy < 2p) plus a (1, M) identity-flag row.

Six steps are CUDA kernels (csrc/g1_affine.cu), each behind a wrapper here:
`fq_prepare`, `fq_inv_up`, `fq_fermat`, `fq_inv_down`, `fq_apply`, and
`fq_mul` (to_affine's elementwise product). A wrapper given CUDA tensors
launches its kernel or raises; given CPU tensors it takes the plain PyTorch
version beside it (`_prepare_plain`, `_inv_up_plain`, `_fermat_plain`,
`_inv_down_plain`, `_apply_plain`, `_mul_plain`), which is also what the
kernels are held against on the card. Every launch adds one to
`LAUNCHES[name]`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build, params
from ..fields import limb_kernels as lk
from ..fields import limbs
from ..fields.limbs import STORE

FERMAT_W = 128      # most tile products inverted at the root (one fq_fermat block)
INV_TILE = 1024     # lanes of one inversion tile (one fq_inv_up / fq_inv_down block)
S30_LIMBS = 13      # signed 30-bit limbs of fq_fermat's safegcd (csrc/fq_inv.cuh)
SAFEGCD_BATCHES = 37    # its fixed count of batches of 30 divsteps

# case codes (int32 rows)
CASE_KEEP = 0       # result = acc (invalid lane / P identity / both identity)
CASE_FORMULA = 1    # result = chord/tangent formula
CASE_IDENT = 2      # result = identity (P == -acc)
CASE_TAKE = 3       # result = +-P (acc was identity)

# kernel launches since the counts were last set to 0 (one per launch, and
# nowhere else)
LAUNCHES = {"fq_prepare": 0, "fq_mul": 0, "fq_inv_up": 0, "fq_fermat": 0,
            "fq_inv_down": 0, "fq_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class G1AF(NamedTuple):
    """Affine G1 batch, limbs-first: coords (L, M) int32 lazy < 2p,
    inf (1, M) int32 in {0, 1}."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor

    @property
    def n(self):
        return self.x.shape[1]


def _fq():
    return lk.get_fq()


def identity_af(m: int, device=None) -> G1AF:
    device = limbs.resolve_device(device)
    L = _fq().L
    return G1AF(
        torch.zeros((L, m), dtype=STORE, device=device),
        torch.zeros((L, m), dtype=STORE, device=device),
        torch.ones((1, m), dtype=STORE, device=device),
    )


def _one_mont(device) -> torch.Tensor:
    """(L, 1) Montgomery one on `device`."""
    return _fq().consts(device)["one"].to(STORE)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _mul_plain(a, b):
    return lk.mont_mul(_fq(), a, b)


def _prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid):
    """Denominator/numerator/case for one batched affine add. d is one on
    every non-FORMULA lane."""
    ring = _fq()
    y2n = torch.where(sign != 0, lk.neg(ring, y2), y2)
    dx = lk.sub(ring, x2, x1)
    dy = lk.sub(ring, y2n, y1)
    xeq = lk.is_zero_mod_p(ring, dx)
    yeq = lk.is_zero_mod_p(ring, dy)
    active = (valid != 0) & (inf1 == 0) & (inf2 == 0)
    is_dbl = xeq & yeq & active
    is_cancel = xeq & (~yeq) & active
    use = active & (~is_cancel)
    num_dbl = lk.mul3(ring, lk.mont_sq(ring, x1))      # 3 x1^2
    den_dbl = lk.add(ring, y1, y1)                     # 2 y1
    d = torch.where(is_dbl, den_dbl, dx)
    num = torch.where(is_dbl, num_dbl, dy)
    d = torch.where(use, d, _one_mont(d.device))
    case = torch.where(use, CASE_FORMULA, CASE_KEEP)
    case = torch.where(is_cancel, CASE_IDENT, case)
    take = (inf1 != 0) & (valid != 0) & (inf2 == 0)
    case = torch.where(take, CASE_TAKE, case).to(STORE)
    return d, num, case


def _apply_plain(x1, y1, inf1, x2, y2, sign, case, num, inv):
    """Finish the add with the batch-inverted denominators."""
    ring = _fq()
    lam = lk.mont_mul(ring, num, inv)
    x3 = lk.sub(ring, lk.sub(ring, lk.mont_sq(ring, lam), x1), x2)
    y3 = lk.sub(ring, lk.mont_mul(ring, lam, lk.sub(ring, x1, x3)), y1)
    y2n = torch.where(sign != 0, lk.neg(ring, y2), y2)
    is_f = case == CASE_FORMULA
    is_t = case == CASE_TAKE
    ox = torch.where(is_f, x3, torch.where(is_t, x2, x1))
    oy = torch.where(is_f, y3, torch.where(is_t, y2n, y1))
    oinf = torch.where(
        is_f | is_t, 0, torch.where(case == CASE_IDENT, 1, inf1)
    ).to(STORE)
    return ox, oy, oinf


def _fermat_plain(x):
    """The inverse, Montgomery in and out, canonical. The function is the
    modular inverse, so it is taken on host integers."""
    Q, L = params.Q, _fq().L
    xs = limbs.from_mont_host(limbs.to_numpy(lk.normalize(_fq(), x)).T, Q)
    inv = [pow(v, -1, Q) for v in xs]
    return limbs.to_tensor(limbs.to_mont_host(inv, Q, L).T, x.device)


def _tile_levels(d):
    """The product trees of the tiles of (L, M) d, leaves first: level k is
    (L, n_tiles, INV_TILE >> k), each node the product of the two halves of
    the level below (parent i = child i * child i + w). Lanes past M are
    Montgomery ones."""
    L, m = d.shape
    nt = -(-m // INV_TILE)
    if nt * INV_TILE > m:
        pad = _one_mont(d.device).expand(L, nt * INV_TILE - m)
        d = torch.cat([d, pad], dim=1)
    levels = [d.reshape(L, nt, INV_TILE)]
    while levels[-1].shape[2] > 1:
        cur = levels[-1]
        half = cur.shape[2] // 2
        levels.append(_mul_plain(cur[:, :, :half], cur[:, :, half:]))
    return levels


def _inv_up_plain(d):
    """(L, M) -> (L, ceil(M / INV_TILE)): the product of each tile."""
    return _tile_levels(d)[-1].reshape(d.shape[0], -1)


def _inv_down_plain(d, rinv):
    """(L, M) d and the inverses of its tile products (L, ceil(M / INV_TILE))
    -> 1/d: down each tile, a node's inverse times the sibling is the
    child's inverse ([lo, hi] <- [inv hi, inv lo])."""
    levels = _tile_levels(d)
    inv = rinv.reshape(d.shape[0], -1, 1)
    for lv in reversed(levels[:-1]):
        half = lv.shape[2] // 2
        # both halves in one product: [inv | inv] * [hi | lo]
        inv = _mul_plain(torch.cat([inv, inv], dim=2),
                         torch.cat([lv[:, :, half:], lv[:, :, :half]], dim=2))
    return inv.reshape(d.shape[0], -1)[:, : d.shape[1]]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, t, rows, m):
    if t.dtype != STORE or t.dim() != 2 or t.shape[0] != rows or t.shape[1] != m:
        raise ValueError(
            f"{name}: expected int32 ({rows}, {m}), got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def _stream():
    # Launches go to PyTorch's current stream, and so does every allocation
    # and release of the tensors they read: a temporary freed right after a
    # launch is reused only by work queued behind that launch.
    return torch.cuda.current_stream().cuda_stream


def fq_mul(a, b):
    """Elementwise Fq Montgomery product, lazy < 2p. a, b: (24, M)."""
    if not a.is_cuda:
        return _mul_plain(a, b)
    L, m = _fq().L, a.shape[1]
    for nm, t in (("a", a), ("b", b)):
        _check(f"fq_mul {nm}", t, L, m)
    out = torch.empty((L, m), dtype=STORE, device=a.device)
    rc = _build.library().fq_mul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, _stream()
    )
    _launched("fq_mul", rc)
    return out


def fq_prepare(x1, y1, inf1, x2, y2, inf2, sign, valid):
    """-> (d, num, case) of one batched affine add; see `_prepare_plain`."""
    if not x1.is_cuda:
        return _prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    L, m = _fq().L, x1.shape[1]
    for nm, t in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2)):
        _check(f"fq_prepare {nm}", t, L, m)
    for nm, t in (("inf1", inf1), ("inf2", inf2), ("sign", sign), ("valid", valid)):
        _check(f"fq_prepare {nm}", t, 1, m)
    d = torch.empty((L, m), dtype=STORE, device=x1.device)
    num = torch.empty((L, m), dtype=STORE, device=x1.device)
    case = torch.empty((1, m), dtype=STORE, device=x1.device)
    rc = _build.library().fq_prepare_launch(
        x1.data_ptr(), y1.data_ptr(), inf1.data_ptr(), x2.data_ptr(),
        y2.data_ptr(), inf2.data_ptr(), sign.data_ptr(), valid.data_ptr(),
        d.data_ptr(), num.data_ptr(), case.data_ptr(), m, _stream(),
    )
    _launched("fq_prepare", rc)
    return d, num, case


def fq_apply(x1, y1, inf1, x2, y2, sign, case, num, inv):
    """-> (x3, y3, inf3), the finished add; see `_apply_plain`."""
    if not x1.is_cuda:
        return _apply_plain(x1, y1, inf1, x2, y2, sign, case, num, inv)
    L, m = _fq().L, x1.shape[1]
    for nm, t in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                  ("num", num), ("inv", inv)):
        _check(f"fq_apply {nm}", t, L, m)
    for nm, t in (("inf1", inf1), ("sign", sign), ("case", case)):
        _check(f"fq_apply {nm}", t, 1, m)
    ox = torch.empty((L, m), dtype=STORE, device=x1.device)
    oy = torch.empty((L, m), dtype=STORE, device=x1.device)
    oinf = torch.empty((1, m), dtype=STORE, device=x1.device)
    rc = _build.library().fq_apply_launch(
        x1.data_ptr(), y1.data_ptr(), inf1.data_ptr(), x2.data_ptr(),
        y2.data_ptr(), sign.data_ptr(), case.data_ptr(), num.data_ptr(),
        inv.data_ptr(), ox.data_ptr(), oy.data_ptr(), oinf.data_ptr(), m,
        _stream(),
    )
    _launched("fq_apply", rc)
    return ox, oy, oinf


def fq_fermat(x):
    """The inverse per lane, Montgomery in and out (canonical out; the
    kernel's body is the safegcd of csrc/fq_inv.cuh). x: (24, W), W <=
    FERMAT_W in the inversion tree (any width is accepted)."""
    if not x.is_cuda:
        return _fermat_plain(x)
    L, m = _fq().L, x.shape[1]
    _check("fq_fermat x", x, L, m)
    out = torch.empty((L, m), dtype=STORE, device=x.device)
    rc = _build.library().fq_fermat_launch(
        x.data_ptr(), out.data_ptr(), m, _stream()
    )
    _launched("fq_fermat", rc)
    return out


def fq_inv_up(d):
    """(24, M) lazy Montgomery -> (24, ceil(M / INV_TILE)): the product of
    each tile of INV_TILE consecutive lanes; see `_inv_up_plain`."""
    if not d.is_cuda:
        return _inv_up_plain(d)
    L, m = _fq().L, d.shape[1]
    _check("fq_inv_up d", d, L, m)
    roots = torch.empty((L, -(-m // INV_TILE)), dtype=STORE, device=d.device)
    rc = _build.library().fq_inv_up_launch(d.data_ptr(), roots.data_ptr(), m, _stream())
    _launched("fq_inv_up", rc)
    return roots


def fq_inv_down(d, rinv):
    """(24, M) d and the inverses of its tile products (24, ceil(M /
    INV_TILE)) -> (24, M) 1/d; see `_inv_down_plain`."""
    if not d.is_cuda:
        return _inv_down_plain(d, rinv)
    L, m = _fq().L, d.shape[1]
    _check("fq_inv_down d", d, L, m)
    _check("fq_inv_down rinv", rinv, L, -(-m // INV_TILE))
    out = torch.empty((L, m), dtype=STORE, device=d.device)
    rc = _build.library().fq_inv_down_launch(
        d.data_ptr(), rinv.data_ptr(), out.data_ptr(), m, _stream()
    )
    _launched("fq_inv_down", rc)
    return out


# ---------------------------------------------------------------------------
# batch inversion
# ---------------------------------------------------------------------------


def batch_inv_lf(d: torch.Tensor) -> torch.Tensor:
    """Elementwise modular inverse of (L, M) lazy Montgomery values.

    Montgomery's trick over tiles: `fq_inv_up` takes the product of each
    tile of INV_TILE lanes, `fq_fermat` inverts the tile products, and
    `fq_inv_down` pushes each inverse back down its tile (~3 muls per lane
    and one inversion per tile). Three launches up to FERMAT_W * INV_TILE
    lanes, one at FERMAT_W lanes or fewer; past FERMAT_W tiles the tile
    products are tiled again. All lanes MUST be nonzero mod p (`fq_prepare`
    guarantees this with its case analysis).
    """
    levels = []
    cur = d.contiguous()
    while cur.shape[1] > FERMAT_W:
        levels.append(cur)
        cur = fq_inv_up(cur)
    inv = fq_fermat(cur)
    for lower in reversed(levels):
        inv = fq_inv_down(lower, inv)
    return inv


# ---------------------------------------------------------------------------
# public add
# ---------------------------------------------------------------------------


def _flag(t, m):
    return t.reshape(1, m).to(STORE).contiguous()


def madd(acc: G1AF, px, py, pinf, sign, valid) -> G1AF:
    """acc (+)= (sign ? -P : P) where valid, complete affine law.

    px/py: (L, M) addend coords (canonical or lazy Montgomery); pinf, sign,
    valid: (1, M) or (M,) integer or bool rows.
    """
    m = acc.x.shape[1]
    x1, y1 = acc.x.contiguous(), acc.y.contiguous()
    x2, y2 = px.contiguous(), py.contiguous()
    if1, sg = _flag(acc.inf, m), _flag(sign, m)
    d, num, case = fq_prepare(
        x1, y1, if1, x2, y2, _flag(pinf, m), sg, _flag(valid, m)
    )
    inv = batch_inv_lf(d).contiguous()
    ox, oy, oinf = fq_apply(x1, y1, if1, x2, y2, sg, case, num, inv)
    return G1AF(ox, oy, oinf)


def add_pairs(a: G1AF, b: G1AF, valid=None) -> G1AF:
    """a (+)= b for two affine accumulator batches (masked when valid given).

    a + a lanes resolve to the tangent law automatically (dx == 0, dy == 0);
    doubling chains reuse this entry point.
    """
    m = a.x.shape[1]
    if valid is None:
        valid = torch.ones((1, m), dtype=STORE, device=a.x.device)
    sign = torch.zeros((1, m), dtype=STORE, device=a.x.device)
    return madd(a, b.x, b.y, b.inf, sign, valid)


def double_af(a: G1AF) -> G1AF:
    return add_pairs(a, a)


# ---------------------------------------------------------------------------
# layout converters
# ---------------------------------------------------------------------------


def to_lf(p: G1AF):
    """Affine batch -> projective G1LF (z = 0 on identity lanes, 1 else)."""
    from . import g1_fused as gf

    inf = p.inf.reshape(1, -1) != 0
    one = _one_mont(p.x.device).expand_as(p.x)
    zero = torch.zeros_like(p.x)
    return gf.G1LF(
        torch.where(inf, zero, p.x), torch.where(inf, one, p.y),
        torch.where(inf, zero, one),
    )


def decode_af(p: G1AF):
    """Device batch -> host affine [(x, y) | None]."""
    Q, L = params.Q, p.x.shape[0]
    ring = _fq()
    # one device->host transfer for both coordinate planes and the flags
    stacked = limbs.to_numpy(torch.cat(
        [lk.normalize(ring, p.x), lk.normalize(ring, p.y),
         p.inf.reshape(1, -1).to(STORE)], dim=0,
    ))
    xs = limbs.from_mont_host(stacked[:L].T, Q)
    ys = limbs.from_mont_host(stacked[L : 2 * L].T, Q)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, stacked[2 * L])]
