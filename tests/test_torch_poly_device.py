"""The limbs-last device API of the port on the CPU against the JAX package:
polynomial algebra (aleo_tpu_torch.pcs.poly_device against
aleo_tpu.pcs.poly_device), the coset NTT (ntt.coset_ntt / coset_intt), the
sparse mat-vec (snark.sparse.spmv) and the limbs-last KZG (pcs.kzg commit,
commit_host, open_at, batch_open_at) over one degree-31 SRS generated by the
JAX package and carried across with `srs_from_numpy`.

Tolerance 0: equal limbs (both sides canonical), equal group elements. The
polynomial lengths repeat (16 coefficients for most) so that the JAX
functions compile few shapes.
"""

import pickle
import random

import jax
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields.modring import FR_RING as JF
from aleo_tpu.ntt import ntt as jntt
from aleo_tpu.pcs import kzg as jkzg
from aleo_tpu.pcs import poly_device as jpd
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference import polynomial as rpoly
from aleo_tpu.reference.msm import msm_naive
from aleo_tpu.snark import sparse as jsparse
from aleo_tpu_torch import config
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.fields.modring import FR_RING as TF
from aleo_tpu_torch.ntt import ntt as tntt
from aleo_tpu_torch.pcs import kzg as tkzg
from aleo_tpu_torch.pcs import poly_device as tpd
from aleo_tpu_torch.pcs.srs import srs_from_numpy
from aleo_tpu_torch.snark import sparse as tsparse

R = params.R
DEG = 31
N = 16


@pytest.fixture(scope="module")
def srs_pair(tmp_path_factory):
    jsrs = JSrs.generate(DEG, seed=b"test-torch-poly-device")
    path = tmp_path_factory.mktemp("srs") / "srs.pkl"
    jsrs.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return jsrs, srs_from_numpy(blob, device="cpu")


def _poly(rng, n):
    xs = [rng.randrange(R) for _ in range(n)]
    return xs, JF.encode(xs), TF.encode(xs, device="cpu")


def _scalar(x):
    return JF.const(x), TF.const(x, device="cpu")


def _same(jv, tv):
    a = np.asarray(jv).astype(np.int64)
    b = tv.numpy().astype(np.int64)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("axis", [0, 1])
def test_tree_sum_matches_jax(axis):
    rng = random.Random(10 + axis)
    rows = [[rng.randrange(R) for _ in range(N)] for _ in range(5)]
    js = np.stack([np.asarray(JF.encode(r)) for r in rows])          # (5, N, L)
    ts = torch.stack([TF.encode(r, device="cpu") for r in rows])
    got = tpd.tree_sum(ts, axis=axis)
    _same(jpd.tree_sum(js, axis=axis), got)
    want = [sum(c) % R for c in zip(*rows)] if axis == 0 else [sum(r) % R for r in rows]
    assert TF.decode(got).tolist() == want


def test_powers_and_eval_coeffs_match_jax():
    rng = random.Random(20)
    xs, jp, tp = _poly(rng, N)
    z = rng.randrange(R)
    jz, tz = _scalar(z)
    for n in (1, 5, N):
        got = tpd.powers(tz, n)
        _same(jpd.powers(jz, n), got)
        assert TF.decode(got).tolist() == [pow(z, i, R) for i in range(n)]
    y = tpd.eval_coeffs(tp, tz)
    _same(jpd.eval_coeffs(jp, jz), y)
    assert TF.decode(y) == rpoly.evaluate(xs, z)


def test_pad_to_matches_jax():
    _, jp, tp = _poly(random.Random(30), 11)
    _same(jpd.pad_to(jp, N), tpd.pad_to(tp, N))
    assert torch.equal(tpd.pad_to(tp, 11), tp)


def test_poly_mul_matches_jax():
    rng = random.Random(40)
    xa, ja, ta = _poly(rng, 9)
    xb, jb, tb = _poly(rng, 8)
    got = tpd.poly_mul(ta, tb)
    # poly_mul runs its product op by op, seconds of XLA compilation on the
    # CPU: jit it whole, after one eager transform of its size has put the
    # domain's tables in the JAX package's cache (made inside a trace, they
    # would leak its tracers into that cache)
    jntt.intt(jntt.ntt(jpd.pad_to(ja, 16)))
    _same(jax.jit(jpd.poly_mul)(ja, jb), got)
    want = [0] * 16
    for i, a in enumerate(xa):
        for j, b in enumerate(xb):
            want[i + j] = (want[i + j] + a * b) % R
    assert TF.decode(got).tolist() == want[:16]
    assert tpd.poly_mul(ta, tb, out_len=5).shape == (5, TF.L)


@pytest.mark.parametrize("m", [12, 2 * N + 5])
def test_divide_by_vanishing_matches_jax(m):
    xs, jp, tp = _poly(random.Random(50 + m), m)
    tq, tr = tpd.divide_by_vanishing(tp, N)
    jq, jr = jpd.divide_by_vanishing(jp, N)
    _same(jq, tq)
    _same(jr, tr)
    q_host, r_host = rpoly.divide_by_vanishing(xs, N)
    assert TF.decode(tr).tolist() == (r_host + [0] * N)[:N]
    assert TF.decode(tq).tolist() == q_host[: max(0, m - N)]


def test_divide_by_linear_via_domain_matches_jax():
    rng = random.Random(60)
    xs, jp, tp = _poly(rng, N)
    z = rng.randrange(R)
    jz, tz = _scalar(z)
    tq, ty = tpd.divide_by_linear_via_domain(tp, tz)
    jq, jy = jpd.divide_by_linear_via_domain(jp, jz)
    _same(jq, tq)
    _same(jy, ty)
    # p(X) - y = q(X) (X - z) at a random point
    x = rng.randrange(R)
    q = TF.decode(tq).tolist()
    y = TF.decode(ty)
    assert (rpoly.evaluate(q, x) * (x - z) + y - rpoly.evaluate(xs, x)) % R == 0


@pytest.mark.parametrize("n,matntt_min", [(16, 1 << 14), (32, 16)])
def test_coset_ntt_matches_jax(n, matntt_min, monkeypatch):
    """n = 32 runs the port's MatNTT (threshold lowered), the JAX package
    its butterfly on the CPU: the values must agree."""
    monkeypatch.setattr(config, "MATNTT_MIN_N", matntt_min)
    rng = random.Random(70 + n)
    xs, jp, tp = _poly(rng, n)
    shift = params.FR_GENERATOR
    ev = tntt.coset_ntt(tp, shift)
    _same(jntt.coset_ntt(jp, shift), ev)
    w = tntt.domain(n).w
    assert TF.decode(ev[3]) == rpoly.evaluate(xs, shift * pow(w, 3, R) % R)
    back = tntt.coset_intt(ev, shift)
    _same(jntt.coset_intt(jntt.coset_ntt(jp, shift), shift), back)
    assert torch.equal(back, tp)


@pytest.mark.parametrize("by", ["row", "col"])
def test_spmv_matches_jax(by):
    rng = random.Random(80)
    n, m_pad = N, 64
    pairs = sorted({(rng.randrange(n), rng.randrange(n)) for _ in range(50)})
    coo = [(r, c, rng.randrange(R)) for r, c in pairs]
    key, gat = ((lambda e: e[0]), (lambda e: e[1])) if by == "row" else (
        (lambda e: e[1]), (lambda e: e[0]))
    jt = jsparse.build_tables(coo, key_of=key, gather_of=gat, out_size=n, m_pad=m_pad, n_limbs=16)
    tt = tsparse.build_tables(coo, key_of=key, gather_of=gat, out_size=n, m_pad=m_pad, device="cpu")
    xs, jx, tx = _poly(rng, n)
    got = tsparse.spmv(tt, tx)
    _same(jsparse.spmv(jt, jx), got)
    want = [0] * n
    for e in coo:
        want[key(e)] = (want[key(e)] + e[2] * xs[gat(e)]) % R
    assert TF.decode(got).tolist() == want


@pytest.mark.parametrize("n", [5, N, DEG + 1])
def test_commit_host_matches_jax_and_host(srs_pair, n):
    jsrs, tsrs = srs_pair
    xs, jp, tp = _poly(random.Random(90 + n), n)
    want = msm_naive(xs, jsrs.host_affine()[:n])
    assert jkzg.commit_host(jsrs, jp) == want
    assert tkzg.commit_host(tsrs, tp) == want


def test_commit_matches_jax_and_host(srs_pair):
    """The device MSM with its device window combine (~250 doublings of
    the plain group law here: seconds on the CPU, so one size)."""
    jsrs, tsrs = srs_pair
    n = 13                                     # padded to 16 points
    xs, jp, tp = _poly(random.Random(95), n)
    want = msm_naive(xs, jsrs.host_affine()[:n])
    assert jkzg.commit_host(jsrs, jp) == want
    point = tkzg.commit(tsrs, tp)
    assert isinstance(point, tg1.G1Points) and point.x.shape == (params.FQ_LIMBS,)
    assert tg1.decode_points(point)[0] == want


def test_open_at_matches_jax_and_verifies(srs_pair):
    jsrs, tsrs = srs_pair
    rng = random.Random(100)
    xs, jp, tp = _poly(rng, N)
    z = rng.randrange(R)
    jz, tz = _scalar(z)
    tw, ty = tkzg.open_at(tsrs, tp, tz)
    jw, jy = jkzg.open_at(jsrs, jp, jz)
    assert tw == jw
    _same(jy, ty)
    y = TF.decode(ty)
    assert y == rpoly.evaluate(xs, z)
    cm = tkzg.commit_host(tsrs, tp)
    assert jkzg.verify(jsrs, cm, z, y, tw)
    assert not jkzg.verify(jsrs, cm, z, (y + 1) % R, tw)


def test_batch_open_at_matches_jax_and_verifies(srs_pair):
    jsrs, tsrs = srs_pair
    rng = random.Random(110)
    polys = [_poly(rng, N) for _ in range(3)]
    z, gamma = rng.randrange(R), rng.randrange(R)
    (jz, tz), (jg, tg) = _scalar(z), _scalar(gamma)
    tw, tys = tkzg.batch_open_at(tsrs, [p[2] for p in polys], tz, tg)
    jw, jys = jkzg.batch_open_at(jsrs, [p[1] for p in polys], jz, jg)
    assert tw == jw
    for jy, ty in zip(jys, tys):
        _same(jy, ty)
    ys = [TF.decode(y) for y in tys]
    assert ys == [rpoly.evaluate(p[0], z) for p in polys]
    cms = [tkzg.commit_host(tsrs, p[2]) for p in polys]
    assert jkzg.batch_verify(jsrs, cms, z, ys, gamma, tw)
    assert not jkzg.batch_verify(jsrs, cms, z, [ys[0] + 1] + ys[1:], gamma, tw)
