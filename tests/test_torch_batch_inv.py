"""The batch inversion of the port (aleo_tpu_torch.curves.g1_affine) on the
CPU: a host model of fq_fermat's safegcd (csrc/fq_inv.cuh), step for step,
against pow(v, -1, Q), and the tiled batch_inv_lf (fq_inv_up, fq_fermat,
fq_inv_down, which take their plain versions here) against host integers.
Its widths against aleo_tpu.curves.g1_affine.batch_inv_lf are in
tests/test_torch_g1_affine.py. Tolerance 0 after normalize (field
elements)."""

import random

import pytest
import torch

from aleo_tpu import params
from aleo_tpu_torch.curves import g1_affine as tga
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs

torch.set_num_threads(2)        # several test workers share the machine

Q = params.Q
L = params.FQ_LIMBS
RM = (1 << 384) % Q             # Montgomery one
T = tga.INV_TILE


# host model of fq_fermat's safegcd

_M30 = (1 << 30) - 1
_U32 = (1 << 32) - 1


def _s30(x: int) -> list:
    """Integer 0 <= x < 2^390 -> 13 limbs of 30 bits."""
    return [(x >> (30 * i)) & _M30 for i in range(tga.S30_LIMBS)]


def _s30_value(v) -> int:
    """13 limbs, the top one signed -> the integer."""
    return sum(limb << (30 * i) for i, limb in enumerate(v))


def _fits(x: int, bits: int) -> int:
    assert -(1 << (bits - 1)) <= x < 1 << (bits - 1), f"int{bits} overflow"
    return x


def _divsteps_30(delta, f, g):
    """30 divsteps on uint32 words, as the kernel spells them -> (delta,
    (u, v, q, r))."""
    U = _U32
    u, v, q, r = 1, 0, 0, 1
    for _ in range(30):
        c1 = ((-delta) >> 31) & U                     # delta > 0
        c2 = (-(g & 1)) & U                           # g odd
        g = (g + (((f ^ c1) - c1) & c2)) & U
        q = (q + (((u ^ c1) - c1) & c2)) & U
        r = (r + (((v ^ c1) - c1) & c2)) & U
        c1 &= c2
        delta = ((delta ^ c1) - c1 + 1) & U
        delta -= (delta >> 31) << 32                  # back to int32
        f = (f + (g & c1)) & U
        u = ((u + (q & c1)) << 1) & U
        v = ((v + (r & c1)) << 1) & U
        g >>= 1
    signed = [w - ((w >> 31) << 32) for w in (u, v, q, r)]
    assert all(abs(w) <= 1 << 30 for w in signed) and abs(delta) < 1 << 30
    return delta, signed


def _update_30(a, b, t, p=None):
    """(a, b) <- (u a + v b, q a + r b) / 2^30 over 13 limbs; with the
    modulus' limbs `p` (the update of d, e) a multiple of p is added first
    so that the division is exact. int64 accumulators, int32 limbs, as in
    the kernel."""
    u, v, q, r = t
    ma = mb = 0
    ca = u * a[0] + v * b[0]
    cb = q * a[0] + r * b[0]
    if p is not None:
        sa, sb = -(a[-1] < 0), -(b[-1] < 0)
        ma, mb = (u & sa) + (v & sb), (q & sa) + (r & sb)
        ma = _fits(ma - ((ca + ma) & _M30), 32)     # p^-1 mod 2^30 is 1
        mb = _fits(mb - ((cb + mb) & _M30), 32)
        ca, cb = ca + p[0] * ma, cb + p[0] * mb
    assert ca & _M30 == 0 and cb & _M30 == 0
    ca, cb = ca >> 30, cb >> 30
    na, nb = [0] * tga.S30_LIMBS, [0] * tga.S30_LIMBS
    peak = 0
    for i in range(1, tga.S30_LIMBS):
        ca += u * a[i] + v * b[i]
        cb += q * a[i] + r * b[i]
        if p is not None:
            ca += p[i] * ma
            cb += p[i] * mb
        peak = max(peak, ca, -ca, cb, -cb)
        na[i - 1], nb[i - 1] = ca & _M30, cb & _M30
        ca, cb = ca >> 30, cb >> 30
    _fits(peak, 64)
    na[-1], nb[-1] = _fits(ca, 32), _fits(cb, 32)
    return na, nb


def _normalize_30(r, sign, p):
    """r in (-2p, p) -> (sign < 0 ? -r : r) mod p, canonical limbs."""
    r = list(r)
    for _ in range(2):
        if r[-1] < 0:
            r = [a + b for a, b in zip(r, p)]
        if sign < 0:
            r, sign = [-a for a in r], 0
        for i in range(tga.S30_LIMBS - 1):
            r[i + 1] += r[i] >> 30
            r[i] &= _M30
    return r


def _safegcd_host(x: int):
    """fq_fermat's algorithm on host integers, step for step: x (a lazy
    Montgomery value aR < 2p, nonzero mod p) -> (R / a mod p, canonical; the
    number of batches after which g was 0)."""
    p = _s30(Q)
    f, g, d, e = list(p), _s30(x), [0] * tga.S30_LIMBS, _s30((1 << 768) % Q)
    delta, g_zero_at = 1, None
    for b in range(tga.SAFEGCD_BATCHES):
        delta, t = _divsteps_30(delta, f[0], g[0])
        d, e = _update_30(d, e, t, p)
        f, g = _update_30(f, g, t)
        assert -2 * Q < _s30_value(d) < Q and -2 * Q < _s30_value(e) < Q
        if g_zero_at is None and not any(g):
            g_zero_at = b + 1
    assert abs(_s30_value(f)) == 1, "g did not reach 0"
    return _s30_value(_normalize_30(d, f[-1], p)), g_zero_at


def _mont_inv(x):
    """The Montgomery form of 1/a for the Montgomery value x = aR."""
    return pow(x, -1, Q) * RM * RM % Q


def _edge_values():
    """1, 2, p - 1, p + 1, 2p - 1, powers of two below 2p, R mod p."""
    vals = [1, 2, Q - 1, Q + 1, 2 * Q - 1, RM, RM + Q]
    vals += [1 << k for k in range(2 * Q.bit_length()) if 1 << k < 2 * Q]
    return vals


def test_safegcd_model_edge_values():
    for v in _edge_values():
        inv, batches = _safegcd_host(v)
        assert inv == _mont_inv(v), v
        assert batches is not None and batches <= tga.SAFEGCD_BATCHES


@pytest.mark.parametrize("chunk", range(4))
def test_safegcd_model_matches_pow(chunk):
    """500 seeded lazy values per chunk (2000 in all), each < 2p: the
    inverse, and g at 0 within the fixed count of batches."""
    rng = random.Random(1000 + chunk)
    worst = 0
    for _ in range(500):
        v = rng.randrange(1, 2 * Q)
        if v == Q:
            continue
        inv, batches = _safegcd_host(v)
        assert inv == _mont_inv(v), v
        assert batches is not None
        worst = max(worst, batches)
    assert worst <= tga.SAFEGCD_BATCHES


def test_safegcd_count_covers_the_bound():
    """37 batches of 30 divsteps cover ceil((49 d + 57) / 17) = 1093
    divsteps for d = 378 (lazy inputs < 2p < 2^378, f = p), the paper's
    bound; and the limbs hold a signed 379-bit value."""
    d = 378
    bound = -(-(49 * d + 57) // 17)
    assert bound == 1093
    assert 2 * Q < 1 << d
    assert Q ** 2 + 4 * (2 * Q) ** 2 <= 5 * (1 << (2 * d))
    assert tga.SAFEGCD_BATCHES * 30 >= bound
    assert (tga.SAFEGCD_BATCHES - 1) * 30 < bound
    assert 30 * tga.S30_LIMBS >= d + 1


def _lazy_inputs(width, seed):
    """width lazy Montgomery values (< 2p, nonzero mod p) with the edge
    values planted at the front."""
    rng = random.Random(seed)
    vals = [rng.randrange(1, 2 * Q) for _ in range(width)]
    vals = [v if v % Q else 1 for v in vals]
    edge = _edge_values()
    vals[: len(edge)] = edge[:width]
    return vals


def _t(vals):
    return torch.from_numpy(limbs.ints_to_limbs(vals, L).T.copy())


def _ints(t):
    return limbs.limbs_to_ints(lk.normalize(lk.get_fq(), t).numpy().T)


def test_tiled_batch_inv_two_levels():
    """FERMAT_W * INV_TILE + 1 lanes: 129 tile products, tiled again. Held
    against host integers by the products x * (1/x), each the Montgomery
    one."""
    width = tga.FERMAT_W * T + 1
    vals = _lazy_inputs(width, 7)
    d = _t(vals)
    roots = tga.fq_inv_up(d)
    assert roots.shape == (L, tga.FERMAT_W + 1)
    got = _ints(tga.batch_inv_lf(d))
    assert len(got) == width
    assert all(x * y % Q == RM * RM % Q for x, y in zip(vals, got))


def test_tree_pieces_on_ragged_tiles():
    """fq_inv_up and fq_inv_down (plain versions) alone: tile products are
    the products of the tiles' lanes, padding reads as one, a tile's
    pushdown from its true inverse gives every lane's inverse."""
    width = 2 * T + 37
    vals = _lazy_inputs(width, 3)
    d = _t(vals)
    roots = _ints(tga.fq_inv_up(d))
    r_inv = pow(RM, -1, Q)
    for k, root in enumerate(roots):
        prod = RM
        for v in vals[k * T : (k + 1) * T]:
            prod = prod * v * r_inv % Q
        assert root == prod, k
    rinv = _t([_mont_inv(r) for r in roots])
    got = _ints(tga.fq_inv_down(d, rinv))
    assert got == [_mont_inv(v) for v in vals]


def test_batch_inv_launches_nothing_on_the_cpu():
    d = _t(_lazy_inputs(300, 5))
    before = dict(tga.LAUNCHES)
    tga.batch_inv_lf(d)
    assert tga.LAUNCHES == before
