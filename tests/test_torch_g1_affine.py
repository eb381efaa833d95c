"""Batch-affine adds of the port (aleo_tpu_torch.curves.g1_affine) on the CPU,
where the wrappers take their plain versions, against
aleo_tpu.curves.g1_affine (which on the CPU runs its plain reference
`_madd_cpu`) and the host curve oracle. Tolerance 0 (group elements)."""

import pathlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1_affine as jga
from aleo_tpu.reference.curve import G1
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.curves import g1_affine as tga
from aleo_tpu_torch.curves import g1_fused as tgf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs

Q = params.Q
L = params.FQ_LIMBS
GEN = G1.generator()


def _mont_lf(ints):
    """Host ints -> (24, N) canonical Montgomery limbs (numpy int64)."""
    return limbs.to_mont_host(ints, Q, L).T.astype(np.int64)


def _batch(pts):
    """Host affine points -> the numpy planes both packages take; identity
    lanes are (0, 0) with the flag set."""
    xs = _mont_lf([0 if p is None else p[0] for p in pts])
    ys = _mont_lf([0 if p is None else p[1] for p in pts])
    inf = np.asarray([[1 if p is None else 0 for p in pts]], dtype=np.int64)
    return xs, ys, inf


def _j(a):
    return jnp.asarray(a.astype(np.uint32))


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _cases(rng):
    """(acc, addend, sign, valid) lanes covering all four cases + padding."""
    pts = [G1.mul(rng.randrange(1, 10_000), GEN) for _ in range(12)]
    acc = [pts[0], pts[1], pts[2], None, pts[4], pts[5], None, pts[7], pts[8], pts[9], pts[10]]
    add = [pts[1], pts[1], G1.neg(pts[2]), pts[3], None, pts[6], None, pts[0],
           G1.neg(pts[8]), pts[9], G1.neg(pts[10])]
    # lanes: chord, tangent, cancel, take, keep (addend identity), chord with
    # a negated addend, keep (both identity), invalid, tangent by sign,
    # cancel by sign, tangent by sign
    sign = [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1]
    valid = [1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1]
    return acc, add, sign, valid


def _expected(acc, add, sign, valid):
    out = []
    for p, q, s, v in zip(acc, add, sign, valid):
        out.append(G1.add(p, G1.neg(q) if s else q) if v else p)
    return out


def test_madd_all_cases_matches_jax_and_oracle():
    rng = random.Random(41)
    acc, add, sign, valid = _cases(rng)
    ax, ay, ainf = _batch(acc)
    px, py, pinf = _batch(add)
    sg = np.asarray([sign], dtype=np.int64)
    vd = np.asarray([valid], dtype=np.int64)

    jr = jga.madd(jga.G1AF(_j(ax), _j(ay), _j(ainf)), _j(px), _j(py), _j(pinf), _j(sg), _j(vd))
    tr = tga.madd(tga.G1AF(_t(ax), _t(ay), _t(ainf)), _t(px), _t(py), _t(pinf), _t(sg), _t(vd))
    want = _expected(acc, add, sign, valid)
    assert tga.decode_af(tr) == want
    assert jga.decode_af(jr) == want
    # same limbs after normalize on every lane that holds a point, same flags
    ring = lk.get_fq()
    live = (tr.inf == 0)
    tx = (lk.normalize(ring, tr.x) * live).numpy().astype(np.int64)
    ty = (lk.normalize(ring, tr.y) * live).numpy().astype(np.int64)
    assert np.array_equal(tx, np.asarray(jr.x).astype(np.int64) * live.numpy())
    assert np.array_equal(ty, np.asarray(jr.y).astype(np.int64) * live.numpy())
    assert np.array_equal(tr.inf.numpy().astype(np.int64), np.asarray(jr.inf).astype(np.int64))


def test_case_codes_and_inversion_safe_denominators():
    rng = random.Random(42)
    acc, add, sign, valid = _cases(rng)
    ax, ay, ainf = _batch(acc)
    px, py, pinf = _batch(add)
    d, num, case = tga.fq_prepare(
        _t(ax), _t(ay), _t(ainf), _t(px), _t(py), _t(pinf),
        _t(np.asarray([sign])), _t(np.asarray([valid])),
    )
    K, F, I, T = tga.CASE_KEEP, tga.CASE_FORMULA, tga.CASE_IDENT, tga.CASE_TAKE
    assert case[0].tolist() == [F, F, I, T, K, F, K, K, F, I, F]
    # no lane of d is zero mod p, and every non-FORMULA lane holds one
    assert not lk.is_zero_mod_p(lk.get_fq(), d).any()
    one = tga._one_mont("cpu")
    for lane, c in enumerate(case[0].tolist()):
        if c != F:
            assert torch.equal(d[:, lane : lane + 1], one)


def test_lazy_representatives_are_recognised():
    """x2 = x1 + p and y2 = y1 + p are the same point: tangent law."""
    p = G1.mul(77, GEN)
    x = limbs.ints_to_limbs([p[0] * (1 << 384) % Q], L).T
    y = limbs.ints_to_limbs([p[1] * (1 << 384) % Q], L).T
    xl = limbs.ints_to_limbs([p[0] * (1 << 384) % Q + Q], L).T
    yl = limbs.ints_to_limbs([p[1] * (1 << 384) % Q + Q], L).T
    zero = torch.zeros((1, 1), dtype=torch.int32)
    one = torch.ones((1, 1), dtype=torch.int32)
    r = tga.madd(tga.G1AF(_t(x), _t(y), zero), _t(xl), _t(yl), zero, zero, one)
    assert tga.decode_af(r) == [G1.double(p)]
    r = tga.madd(tga.G1AF(_t(x), _t(y), zero), _t(xl), _t(yl), zero, one, one)
    assert tga.decode_af(r) == [None]


# the lazy Montgomery inputs planted at the front of each width: 1, 2, p - 1,
# p + 1, 2p - 1, R mod p (Montgomery one) and its lazy form, 2^377
_INV_EDGE = [1, 2, Q - 1, Q + 1, 2 * Q - 1, (1 << 384) % Q, (1 << 384) % Q + Q, 1 << 377]


_INV_WIDTHS = [1, 2, 127, 128, 129, 1000, 1001, tga.INV_TILE, tga.INV_TILE + 1]


def _inv_inputs(width):
    """(24, width) Montgomery limbs of seeded values, _INV_EDGE planted."""
    rng = random.Random(width)
    d = _mont_lf([rng.randrange(1, Q) for _ in range(width)])
    edge = np.asarray(limbs.ints_to_limbs(_INV_EDGE[:width], L).T, dtype=np.int64)
    d[:, : edge.shape[1]] = edge
    return d


@pytest.fixture(scope="module")
def jax_inverses():
    """The JAX package's inverses of every width's inputs, from one call over
    all widths side by side (the inversion is lane by lane; one call
    compiles once)."""
    ds = [_inv_inputs(w) for w in _INV_WIDTHS]
    ji = np.asarray(jga.batch_inv_lf(_j(np.concatenate(ds, axis=1)))).astype(np.int64)
    cut = np.cumsum([0] + _INV_WIDTHS)
    return {w: ji[:, cut[k] : cut[k + 1]] for k, w in enumerate(_INV_WIDTHS)}


@pytest.mark.parametrize("width", _INV_WIDTHS)
def test_batch_inv_lf_matches_jax(width, jax_inverses):
    """Widths around the root's 128 lanes and the tile's INV_TILE lanes."""
    d = _inv_inputs(width)
    ti = lk.normalize(lk.get_fq(), tga.batch_inv_lf(_t(d)))
    assert ti.shape == (L, width)
    assert np.array_equal(ti.numpy().astype(np.int64), jax_inverses[width])
    r2 = (1 << 768) % Q
    want = [pow(x, -1, Q) * r2 % Q for x in limbs.limbs_to_ints(d.T)]
    assert limbs.limbs_to_ints(ti.numpy().T) == want


def test_batch_inv_lf_takes_lazy_inputs():
    rng = random.Random(5)
    vals = [rng.randrange(1, Q) for _ in range(300)]
    lazy = [v * (1 << 384) % Q + Q for v in vals]
    d = torch.from_numpy(limbs.ints_to_limbs(lazy, L).T.copy())
    ti = lk.normalize(lk.get_fq(), tga.batch_inv_lf(d))
    assert limbs.from_mont_host(ti.numpy().T, Q) == [pow(v, -1, Q) for v in vals]


def test_add_pairs_double_and_converters():
    rng = random.Random(6)
    pts = [G1.mul(rng.randrange(1, 1000), GEN) for _ in range(5)] + [None]
    x, y, inf = _batch(pts)
    a = tga.G1AF(_t(x), _t(y), _t(inf))
    assert tga.decode_af(tga.double_af(a)) == [G1.double(p) for p in pts]
    b = tga.G1AF(_t(x).flip(1), _t(y).flip(1), _t(inf).flip(1))
    want = [G1.add(p, q) for p, q in zip(pts, reversed(pts))]
    assert tga.decode_af(tga.add_pairs(a, b)) == want
    mask = torch.tensor([[1, 0, 1, 0, 1, 0]], dtype=torch.int32)
    got = tga.decode_af(tga.add_pairs(a, b, valid=mask))
    assert got == [w if m else p for w, m, p in zip(want, mask[0].tolist(), pts)]
    assert tgf.decode_lf(tga.to_lf(a)) == pts
    enc = tg1.encode_points(pts, device="cpu")
    assert tgf.decode_lf(tgf.from_points(enc)) == pts
    ident = tga.identity_af(3, device="cpu")
    assert tga.decode_af(ident) == [None] * 3


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CPU the wrappers take the plain versions; the checks that
    guard a launch are exercised directly."""
    good = torch.zeros((L, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tga._check("x", good, L, 8)
    with pytest.raises(ValueError, match="int32"):
        tga._check("x", good.to(torch.int64), L, 8)
    with pytest.raises(ValueError, match="int32"):
        tga._check("x", good, L, 9)
    with pytest.raises(RuntimeError, match="launch failed"):
        tga._launched("fq_mul", 9)
    before = dict(tga.LAUNCHES)
    tga.fq_mul(good, good)              # CPU tensors: no launch is counted
    assert tga.LAUNCHES == before


def test_cuda_constants_match_params():
    """The constants hard-coded in csrc/fq.cuh are those of params.Q."""
    src = (pathlib.Path(tga.__file__).parent.parent / "csrc" / "fq.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[FQ_WORDS\] = \{(.*?)\};", src, re.S).group(1)
        ws = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]
        assert len(ws) == 12
        return sum(w << (32 * i) for i, w in enumerate(ws))

    def s30(name):
        n = int(re.search(r"#define FQ_S30_LIMBS (\d+)", src).group(1))
        body = re.search(name + r"\[FQ_S30_LIMBS\] = \{(.*?)\};", src, re.S).group(1)
        ls = [int(w, 16) for w in re.findall(r"0x[0-9a-f]+", body)]
        assert len(ls) == n == tga.S30_LIMBS
        assert all(0 <= x < 1 << 30 for x in ls)
        return sum(x << (30 * i) for i, x in enumerate(ls))

    assert words("FQ_P") == Q
    assert words("FQ_P2") == 2 * Q
    assert words("FQ_ONE") == (1 << 384) % Q
    assert s30("FQ_P_S30") == Q
    assert s30("FQ_R2_S30") == (1 << 768) % Q
    pinv = int(re.search(r"#define FQ_PINV30 (0x[0-9a-f]+)u", src).group(1), 16)
    assert pinv * Q % (1 << 30) == 1
    inv_src = (pathlib.Path(tga.__file__).parent.parent / "csrc" / "fq_inv.cuh").read_text()
    batches = int(re.search(r"#define SAFEGCD_BATCHES (\d+)", inv_src).group(1))
    assert batches == tga.SAFEGCD_BATCHES
    g1_src = (pathlib.Path(tga.__file__).parent.parent / "csrc" / "g1_affine.cu").read_text()
    threads = int(re.search(r"#define INV_THREADS (\d+)", g1_src).group(1))
    assert re.search(r"#define INV_TILE \(4 \* INV_THREADS\)", g1_src)
    assert 4 * threads == tga.INV_TILE
    np0 = int(re.search(r"#define FQ_NP0 (0x[0-9a-f]+)u", src).group(1), 16)
    assert np0 == (-pow(Q, -1, 1 << 32)) % (1 << 32)
