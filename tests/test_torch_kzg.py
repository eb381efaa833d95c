"""KZG commitments, openings, polynomial algebra and the sparse mat-vec of
the port on the CPU against aleo_tpu (pcs.kzg, pcs.poly_lf, snark.sparse),
over one degree-64 SRS generated by the JAX package and carried across with
`srs_from_numpy`. Tolerance 0 (group and field elements)."""

import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu.pcs import kzg as jkzg
from aleo_tpu.pcs import poly_lf as jpl
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference import polynomial as rpoly
from aleo_tpu.snark import sparse as jsparse
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.msm import msm as tmsm
from aleo_tpu_torch.pcs import kzg as tkzg
from aleo_tpu_torch.pcs import poly_lf as tpl
from aleo_tpu_torch.pcs.srs import Srs as TSrs
from aleo_tpu_torch.pcs.srs import srs_from_numpy
from aleo_tpu_torch.snark import sparse as tsparse
from aleo_tpu_torch.utils import profiling

R = params.R
DEG = 64


@pytest.fixture(scope="module")
def srs_pair(tmp_path_factory):
    jsrs = JSrs.generate(DEG, seed=b"test-torch-srs")
    path = tmp_path_factory.mktemp("srs") / "srs.pkl"
    jsrs.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)          # the numpy dictionary the JAX package writes
    return jsrs, srs_from_numpy(blob, device="cpu")


def _poly(rng, n):
    xs = [rng.randrange(R) for _ in range(n)]
    return xs, jlf.encode(xs), tlf.encode(xs, device="cpu")


def test_srs_carried_across_is_the_same_srs(srs_pair):
    jsrs, tsrs = srs_pair
    assert tsrs.max_degree == DEG and tsrs.seed == jsrs.seed
    assert tsrs.host_affine() == jsrs.host_affine()
    assert tsrs.g2_tau == jsrs.g2_tau and tsrs.g2_power(3) == jsrs.g2_power(3)
    for k in "xyz":
        assert np.array_equal(
            getattr(tsrs.powers, k).numpy().astype(np.int64),
            np.asarray(getattr(jsrs.powers, k)).astype(np.int64),
        )
    # and back: the port writes the same layout
    blob = tsrs.to_numpy()
    assert np.array_equal(blob["x"], np.asarray(jsrs.powers.x))
    again = srs_from_numpy(blob, device="cpu")
    assert again.host_affine() == jsrs.host_affine()


def test_srs_generated_by_the_port_matches():
    t = TSrs.generate(6, seed=b"test-torch-srs", device="cpu")
    j = JSrs.generate(6, seed=b"test-torch-srs")
    assert t.host_affine() == j.host_affine()
    assert np.array_equal(t.powers.y.numpy().astype(np.int64),
                          np.asarray(j.powers.y).astype(np.int64))


@pytest.mark.parametrize("n", [1, 5, 16, 33, 65])
def test_commit_lf_matches_jax(srs_pair, n):
    jsrs, tsrs = srs_pair
    _, jp, tp = _poly(random.Random(n), n)
    assert tkzg.commit_lf(tsrs, tp) == jkzg.commit_lf(jsrs, jp)


@pytest.mark.parametrize("n,shift", [(7, 3), (16, 48), (31, 34)])
def test_commit_shifted_lf_matches_jax_and_dense(srs_pair, n, shift):
    jsrs, tsrs = srs_pair
    xs, jp, tp = _poly(random.Random(n * shift), n)
    got = tkzg.commit_shifted_lf(tsrs, tp, shift)
    assert got == jkzg.commit_shifted_lf(jsrs, jp, shift)
    dense = tlf.encode([0] * shift + xs, device="cpu")
    assert got == tkzg.commit_lf(tsrs, dense)


# (sizes, index of an all-zero polynomial or None, shift): the mixed list
# spans three padded sizes (16, 64 and 4; 35 at shift 30); the others are
# one size group of k = 1, 2 and 8, one with an all-zero member
MANY_CASES = [
    pytest.param([16, 9, 16, 33, 3], None, 0, id="0"),
    pytest.param([16, 9, 16, 33, 3], None, 30, id="30"),
    pytest.param([13], None, 0, id="k1-0"),
    pytest.param([13], None, 30, id="k1-30"),
    pytest.param([16, 9], None, 0, id="k2-0"),
    pytest.param([16, 9], None, 30, id="k2-30"),
    pytest.param([16, 9, 12, 16, 10, 15, 16, 11], None, 0, id="k8-0"),
    pytest.param([16, 9, 12, 16, 10, 15, 16, 11], None, 30, id="k8-30"),
    pytest.param([16, 9, 12], 1, 0, id="zero-0"),
    pytest.param([16, 9, 12], 1, 30, id="zero-30"),
]


def _many(sizes, zero, seed):
    rng = random.Random(seed)
    polys = [_poly(rng, n) for n in sizes]
    if zero is not None:
        zs = [0] * sizes[zero]
        polys[zero] = (zs, jlf.encode(zs), tlf.encode(zs, device="cpu"))
    return polys


@pytest.fixture
def profiled():
    """Profiling on and a clean report for the test; the former state after."""
    was = profiling.enabled()
    profiling.reset()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(was)
        profiling.reset()


@pytest.mark.parametrize("sizes,zero,shift", MANY_CASES)
def test_commit_many_lf_matches_jax(srs_pair, sizes, zero, shift):
    """One bucket pipeline per size group gives each polynomial's own
    commitment (`commit_lf` / `commit_shifted_lf`) and the JAX package's
    `commit_many_lf`, which runs a group's MSMs one after another."""
    jsrs, tsrs = srs_pair
    polys = _many(sizes, zero, 70 + shift + len(sizes))
    got = tkzg.commit_many_lf(tsrs, [p[2] for p in polys], shift=shift)
    assert got == [tkzg.commit_shifted_lf(tsrs, p[2], shift) for p in polys]
    if zero is not None:
        assert got[zero] is None                     # the identity
    want = jkzg.commit_many_lf(jsrs, [p[1] for p in polys], shift=shift)
    assert got == want


@pytest.mark.parametrize("sizes,pipelines", [
    pytest.param([13], [1], id="k1"),
    pytest.param([16, 9], [2], id="k2"),
    pytest.param([16, 9, 12, 16, 10, 15, 16, 11], [8], id="k8"),
    pytest.param([16, 9, 33, 3, 12], [3, 1, 1], id="three_groups"),
])
def test_commit_many_lf_runs_one_pipeline_per_size_group(srs_pair, monkeypatch, profiled,
                                                         sizes, pipelines):
    """With profiling on: one round count read, one `msm/setup` and one host
    combine per size group, and the counters `kzg/msms` / `kzg/pipelines`
    at (MSMs, pipelines); `pipelines` lists each group's k."""
    _, tsrs = srs_pair
    polys = [p[2] for p in _many(sizes, None, 90 + len(sizes))]
    reads = []
    round_count = tmsm._round_count
    monkeypatch.setattr(tmsm, "_round_count", lambda count: reads.append(1) or round_count(count))
    got = tkzg.commit_many_lf(tsrs, polys)
    report = profiling.report()
    assert len(reads) == len(pipelines)
    assert report["msm/setup"]["calls"] == report["msm/combine_host"]["calls"] == len(pipelines)
    assert report["kzg/commit"]["calls"] == len(pipelines)
    assert report["count/kzg/msms"]["total"] == len(sizes) == sum(pipelines)
    assert report["count/kzg/pipelines"]["total"] == len(pipelines)
    assert got == [tkzg.commit_lf(tsrs, p) for p in polys]


def test_commit_many_lf_splits_a_group_past_the_pipeline_cap(srs_pair, monkeypatch, profiled):
    """A size group of more than `MAX_PIPELINE_POINTS` points runs as several
    pipelines of at most that many points, in order: five polynomials of 16
    points under a cap of 32 run as pipelines of 2, 2 and 1 MSMs."""
    _, tsrs = srs_pair
    polys = [p[2] for p in _many([16, 9, 12, 16, 10], None, 95)]
    monkeypatch.setattr(tkzg, "MAX_PIPELINE_POINTS", 32)
    got = tkzg.commit_many_lf(tsrs, polys)
    report = profiling.report()
    assert report["count/kzg/msms"]["total"] == 5
    assert report["count/kzg/pipelines"]["total"] == 3
    assert got == [tkzg.commit_lf(tsrs, p) for p in polys]


def test_batch_open_at_lf_matches_jax_and_verifies(srs_pair):
    jsrs, tsrs = srs_pair
    rng = random.Random(80)
    polys = [_poly(rng, n) for n in (16, 11, 32)]
    z, gamma = rng.randrange(R), rng.randrange(R)
    tw, tys = tkzg.batch_open_at_lf(
        tsrs, [p[2] for p in polys], tlf.const(z, device="cpu"), tlf.const(gamma, device="cpu")
    )
    jw, jys = jkzg.batch_open_at_lf(
        jsrs, [p[1] for p in polys], jlf.const(z), jlf.const(gamma)
    )
    assert tw == jw
    ys = [tlf.decode(y)[0] for y in tys]
    assert ys == [int(jlf.decode(y)[0]) for y in jys]
    assert ys == [rpoly.evaluate(p[0], z) for p in polys]
    cms = [tkzg.commit_lf(tsrs, p[2]) for p in polys]
    assert tkzg.batch_verify(tsrs, cms, z, ys, gamma, tw)
    assert not tkzg.batch_verify(tsrs, cms, z, [ys[0] + 1] + ys[1:], gamma, tw)
    w2, y2 = tkzg.open_at_lf(tsrs, polys[0][2], tlf.const(z, device="cpu"))
    assert tkzg.verify(tsrs, cms[0], z, tlf.decode(y2)[0], w2)


def _same(j, t):
    assert [int(v) for v in jlf.decode(j)] == tlf.decode(t)


def test_poly_lf_matches_jax():
    rng = random.Random(90)
    xs, jp, tp = _poly(rng, 37)
    z = rng.randrange(R)
    jz, tz = jlf.const(z), tlf.const(z, device="cpu")
    _same(jpl.pad_to(jp, 40), tpl.pad_to(tp, 40))
    _same(jpl.eval_coeffs(jp, jz), tpl.eval_coeffs(tp, tz))
    jq, jr = jpl.divide_by_vanishing(jp, 8)
    tq, tr = tpl.divide_by_vanishing(tp, 8)
    _same(jq, tq)
    _same(jr, tr)
    q_host, r_host = rpoly.divide_by_vanishing(xs, 8)
    assert tlf.decode(tr) == (r_host + [0] * 8)[:8]
    jq, jy = jpl.divide_by_linear_via_domain(jp, jz)
    tq, ty = tpl.divide_by_linear_via_domain(tp, tz)
    _same(jq, tq)
    _same(jy, ty)
    stack_xs = [[rng.randrange(R) for _ in range(12)] for _ in range(5)]
    g = [rng.randrange(R) for _ in range(5)]
    jst = jnp.stack([jlf.encode(s) for s in stack_xs], axis=1)
    tst = torch.stack([tlf.encode(s, device="cpu") for s in stack_xs], dim=1)
    _same(jpl.fold_stack(jst, jlf.encode(g)), tpl.fold_stack(tst, tlf.encode(g, device="cpu")))
    for nd, nv in ((32, 8), (16, 16), (64, 2)):
        _same(jpl._coset_vh_inv(nd, nv, params.FR_GENERATOR),
              tpl._coset_vh_inv(nd, nv, params.FR_GENERATOR, torch.device("cpu")))


@pytest.mark.parametrize("by", ["row", "col"])
def test_spmv_lf_matches_jax(by):
    rng = random.Random(91)
    n, m_pad = 16, 64
    coo = [(rng.randrange(n), rng.randrange(n), rng.randrange(R)) for _ in range(50)]
    coo = sorted(set((r, c) for r, c, _ in coo))
    coo = [(r, c, rng.randrange(R)) for r, c in coo]
    key, gat = ((lambda e: e[0]), (lambda e: e[1])) if by == "row" else (
        (lambda e: e[1]), (lambda e: e[0]))
    jt = jsparse.build_tables(coo, key_of=key, gather_of=gat, out_size=n, m_pad=m_pad, n_limbs=16)
    tt = tsparse.build_tables(coo, key_of=key, gather_of=gat, out_size=n, m_pad=m_pad, device="cpu")
    xs = [rng.randrange(R) for _ in range(n)]
    got = tlf.decode(tsparse.spmv_lf(tt, tlf.encode(xs, device="cpu")))
    assert got == [int(v) for v in jlf.decode(jsparse.spmv_lf(jt, jlf.encode(xs)))]
    want = [0] * n
    for e in coo:
        want[key(e)] = (want[key(e)] + e[2] * xs[gat(e)]) % R
    assert got == want
