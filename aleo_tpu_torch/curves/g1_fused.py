"""Fused projective G1 (BLS12-377) group law, limbs-first layout.

Counterpart of the JAX package's `curves/g1_fused.py`. One call performs a
complete Renes-Costello-Batina 2016 projective addition (Algorithm 7, a = 0,
b3 = 3), mixed addition (Algorithm 8) or doubling (Algorithm 9) on a whole
lane batch: all products and carries of a group operation stay in registers.
The formulas are complete, so doubling, inverse pairs and the identity on
either side need no case analysis and no inversion.

Point batches are `G1LF(x, y, z)`, each coordinate a (24, M) int32 tensor of
16-bit Montgomery limbs, lazy < 2p; z = 0 (mod p) marks the identity, whose
canonical form is (0, 1, 0). `normalize_lf` gives canonical limbs at batch
boundaries.

Five functions are CUDA kernels (csrc/g1_fused.cu), each behind a wrapper
here: `double_lf` (g1_double), `add_lf` (g1_add), `add_sel_lf` (g1_add_sel),
`add_sel_proj_lf` (g1_add_sel_proj), `normalize_lf` (g1_normalize). A wrapper
given CUDA tensors launches its kernel or raises; given CPU tensors it takes
the plain PyTorch version beside it (`_double_plain`, `_add_plain`,
`_add_sel_plain`, `_add_sel_proj_plain`, `_normalize_plain`), which is also
what the kernels are held against on the card. Every launch adds one to
`LAUNCHES[name]`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build, params
from ..fields import limb_kernels as lk
from ..fields import limbs
from ..fields.limbs import STORE
from .g1_affine import _check, _stream

# kernel launches since the counts were last set to 0 (one per launch, and
# nowhere else)
LAUNCHES = {"g1_double": 0, "g1_add": 0, "g1_add_sel": 0, "g1_add_sel_proj": 0,
            "g1_normalize": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class G1LF(NamedTuple):
    """Projective G1 batch, limbs-first: three (24, M) int32 tensors of
    Montgomery limbs (lazy < 2p allowed); z = 0 marks the identity."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def n(self):
        return self.x.shape[1]


def _fq():
    return lk.get_fq()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _add_plain(x1, y1, z1, x2, y2, z2):
    """RCB16 Algorithm 7 (a = 0, b3 = 3): 12 products, 3 mul3."""
    ring = _fq()
    mul = lambda a, b: lk.mont_mul(ring, a, b)
    add = lambda a, b: lk.add(ring, a, b)
    sub = lambda a, b: lk.sub(ring, a, b)
    mul3 = lambda a: lk.mul3(ring, a)
    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t2 = mul(z1, z2)
    t3 = sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1))
    t4 = sub(mul(add(y1, z1), add(y2, z2)), add(t1, t2))
    y3 = sub(mul(add(x1, z1), add(x2, z2)), add(t0, t2))
    t0 = mul3(t0)
    t2 = mul3(t2)                   # b3 * t2
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = mul3(y3)                   # b3 * y3
    return (
        sub(mul(t3, t1), mul(t4, y3)),
        add(mul(t1, z3), mul(y3, t0)),
        add(mul(z3, t4), mul(t0, t3)),
    )


def _double_plain(x, y, z):
    """RCB16 Algorithm 9 (a = 0, b3 = 3): 8 products, 2 mul3."""
    ring = _fq()
    mul = lambda a, b: lk.mont_mul(ring, a, b)
    add = lambda a, b: lk.add(ring, a, b)
    t0 = mul(y, y)
    t1 = mul(y, z)
    t2 = mul(z, z)
    txy = mul(x, y)
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)                # 8 y^2
    t2 = lk.mul3(ring, t2)          # b3 z^2
    y3 = add(t0, t2)
    t0 = lk.sub(ring, t0, lk.mul3(ring, t2))
    xt = mul(t0, txy)
    return add(xt, xt), add(mul(t2, z3), mul(t0, y3)), mul(t1, z3)


def _madd_plain(x1, y1, z1, x2, y2):
    """RCB16 Algorithm 8 (complete mixed addition, a = 0, b3 = 3, Z2 = 1):
    11 products and no Z2 operand. The bucket stream of the MSM always adds
    affine table points."""
    ring = _fq()
    mul = lambda a, b: lk.mont_mul(ring, a, b)
    add = lambda a, b: lk.add(ring, a, b)
    sub = lambda a, b: lk.sub(ring, a, b)
    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t3 = sub(mul(add(x2, y2), add(x1, y1)), add(t0, t1))
    t4 = add(mul(y2, z1), y1)
    y3 = add(mul(x2, z1), x1)
    t0 = add(add(t0, t0), t0)
    t2 = lk.mul3(ring, z1)          # b3 * z1
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = lk.mul3(ring, y3)          # b3 * y3
    return (
        sub(mul(t3, t1), mul(t4, y3)),
        add(mul(t1, z3), mul(y3, t0)),
        add(mul(z3, t4), mul(t0, t3)),
    )


def _add_sel_plain(x1, y1, z1, x2, y2, sign, valid):
    """acc (+)= (sign ? -P : P) where valid, else acc unchanged; P affine.

    sign/valid are (1, M) rows. P == (0, 0) is the identity sentinel of the
    MSM's table and is masked like an invalid lane; it is tested on the
    stored limbs of y2 before the negation (neg(0) = 2p != 0)."""
    p_ident = y2.amax(dim=0, keepdim=True) == 0
    y2n = torch.where(sign != 0, lk.neg(_fq(), y2), y2)
    rx, ry, rz = _madd_plain(x1, y1, z1, x2, y2n)
    keep = (valid != 0) & ~p_ident
    return torch.where(keep, rx, x1), torch.where(keep, ry, y1), torch.where(keep, rz, z1)


def _add_sel_proj_plain(x1, y1, z1, x2, y2, z2, sign, valid):
    """acc (+)= (sign ? -P : P) where valid, else acc unchanged; P
    projective. No sentinel: an identity addend has z = 0."""
    y2n = torch.where(sign != 0, lk.neg(_fq(), y2), y2)
    rx, ry, rz = _add_plain(x1, y1, z1, x2, y2n, z2)
    keep = valid != 0
    return torch.where(keep, rx, x1), torch.where(keep, ry, y1), torch.where(keep, rz, z1)


def _normalize_plain(x, y, z):
    ring = _fq()
    return lk.normalize(ring, x), lk.normalize(ring, y), lk.normalize(ring, z)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def _coords(p):
    return tuple(c.contiguous() for c in p)


def _flag(t, m):
    return t.reshape(1, m).to(STORE).contiguous()


def _run(name, coords, flags=()):
    """Launch kernel `name` on CUDA coordinates (and flag rows); three fresh
    output coordinates. Raises on anything the kernel does not take."""
    L, m = _fq().L, coords[0].shape[1]
    for i, t in enumerate(coords):
        _check(f"{name} coordinate {i}", t, L, m)
    for i, t in enumerate(flags):
        _check(f"{name} flag {i}", t, 1, m)
    out = [torch.empty((L, m), dtype=STORE, device=coords[0].device) for _ in range(3)]
    launch = getattr(_build.library(), name + "_launch")
    rc = launch(*(t.data_ptr() for t in (*coords, *flags, *out)), m, _stream())
    _launched(name, rc)
    return G1LF(*out)


def add_lf(p: G1LF, q: G1LF) -> G1LF:
    """Complete projective addition, batched. Inputs and outputs < 2p."""
    coords = _coords(p) + _coords(q)
    if not coords[0].is_cuda:
        return G1LF(*_add_plain(*coords))
    return _run("g1_add", coords)


def double_lf(p: G1LF) -> G1LF:
    coords = _coords(p)
    if not coords[0].is_cuda:
        return G1LF(*_double_plain(*coords))
    return _run("g1_double", coords)


def add_sel_lf(acc: G1LF, px, py, sign, valid) -> G1LF:
    """Masked accumulate: acc + (sign ? -p : p) where valid, else acc, bit
    for bit.

    p = (px, py) affine limbs-first (L, M): the table points of the
    Pippenger bucket stream are affine, so the round primitive is the mixed
    complete addition. (0, 0) is the identity sentinel. sign, valid: (M,) or
    (1, M) integer or bool rows.
    """
    m = acc.x.shape[1]
    coords = _coords(acc) + (px.contiguous(), py.contiguous())
    flags = (_flag(sign, m), _flag(valid, m))
    if not coords[0].is_cuda:
        return G1LF(*_add_sel_plain(*coords, *flags))
    return _run("g1_add_sel", coords, flags)


def add_sel_proj_lf(acc: G1LF, p: G1LF, sign, valid) -> G1LF:
    """Masked accumulate with a projective addend (full complete add): the
    merge of the top window's sub-accumulators, where both sides are bucket
    accumulators."""
    m = acc.x.shape[1]
    coords = _coords(acc) + _coords(p)
    flags = (_flag(sign, m), _flag(valid, m))
    if not coords[0].is_cuda:
        return G1LF(*_add_sel_proj_plain(*coords, *flags))
    return _run("g1_add_sel_proj", coords, flags)


def normalize_lf(p: G1LF) -> G1LF:
    """Reduce all coordinates to canonical (< p) form."""
    coords = _coords(p)
    if not coords[0].is_cuda:
        return G1LF(*_normalize_plain(*coords))
    return _run("g1_normalize", coords)


# ---------------------------------------------------------------------------
# layout converters / host IO
# ---------------------------------------------------------------------------


def select_lf(cond, p: G1LF, q: G1LF) -> G1LF:
    """cond: (M,) bool -> per-lane select (tensor glue, not a kernel)."""
    c = cond.reshape(1, -1)
    return G1LF(torch.where(c, p.x, q.x), torch.where(c, p.y, q.y), torch.where(c, p.z, q.z))


def identity_lf(m: int, device=None) -> G1LF:
    device = limbs.resolve_device(device)
    L = _fq().L
    one = _fq().consts(device)["one"].to(STORE)
    return G1LF(
        torch.zeros((L, m), dtype=STORE, device=device),
        one.expand(L, m).contiguous(),
        torch.zeros((L, m), dtype=STORE, device=device),
    )


def from_points(p) -> G1LF:
    """curves.g1.G1Points (N, 24) limbs-last -> G1LF (24, N)."""
    return G1LF(p.x.T, p.y.T, p.z.T)


def to_points(p: G1LF):
    from .g1 import G1Points

    return G1Points(p.x.T, p.y.T, p.z.T)


def decode_lf(p: G1LF):
    """Device batch (possibly lazy) -> host affine [(x, y) | None]. One
    normalize of the three coordinates, and the three planes come back in
    one device->host transfer."""
    Q = params.Q
    L = p.x.shape[0]
    all3 = limbs.to_numpy(torch.cat(normalize_lf(p), dim=0))
    xs = limbs.from_mont_host(all3[:L].T, Q)
    ys = limbs.from_mont_host(all3[L : 2 * L].T, Q)
    zs = limbs.from_mont_host(all3[2 * L :].T, Q)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def encode_lf(pts, device=None) -> G1LF:
    """Host affine [(x, y) | None] -> G1LF (canonical Montgomery)."""
    from .g1 import encode_points

    return from_points(encode_points(pts, device=device))
