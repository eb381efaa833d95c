"""The projective MSM pipeline of the port (aleo_tpu_torch.msm.msm with
MSM_AFFINE_MODE = "0") on the CPU: the bucket reductions against a host sum,
the cases of tests/test_torch_msm.py in both modes, the device entry point
`msm` against the oracle, and KZG commitments in both modes against
aleo_tpu.pcs.kzg. Tolerance 0 (group elements)."""

import random

import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu.msm import msm as jmsm
from aleo_tpu.pcs import kzg as jkzg
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference.curve import G1
from aleo_tpu.reference.msm import msm_naive, msm_pippenger_jac
from aleo_tpu_torch import config as tconfig
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.curves import g1_affine as tga
from aleo_tpu_torch.curves import g1_fused as tgf
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.msm import msm as tmsm
from aleo_tpu_torch.pcs import kzg as tkzg
from aleo_tpu_torch.pcs.srs import Srs as TSrs
from test_torch_msm import CASES

torch.set_num_threads(2)        # several test workers share the machine

R = params.R
GEN = G1.generator()
MODES = {"projective": "0", "affine": "1"}


@pytest.fixture(params=sorted(MODES))
def mode(request, monkeypatch):
    monkeypatch.setattr(tconfig, "MSM_AFFINE_MODE", MODES[request.param])
    assert tmsm._use_affine() == (request.param == "affine")
    return request.param


def _chain(rng, n):
    p = G1.mul(rng.randrange(1, R), GEN)
    pts = []
    for _ in range(n):
        pts.append(p)
        p = G1.add(p, GEN)
    return pts


def _raw(scalars):
    return limbs.to_tensor(limbs.ints_to_limbs(scalars, 16), "cpu")


# -- the mode switch --------------------------------------------------------------


def test_default_mode_is_affine_and_is_read_at_call_time(monkeypatch):
    assert tconfig.MSM_AFFINE_MODE == "1" and tmsm._use_affine()
    # the same lane grids as the reference, whatever the mode
    assert tmsm._top_window_split(12, tmsm._nwin(12)) == jmsm._top_window_split(12, jmsm._nwin(12))
    for value, affine in (("0", False), ("false", False), ("1", True), ("auto", True)):
        monkeypatch.setattr(tconfig, "MSM_AFFINE_MODE", value)
        assert tmsm._use_affine() is affine


# -- (c) the bucket reductions against host sums ----------------------------------


def _buckets(rng, w, b):
    """w * b lanes of small multiples of the generator with identities among
    them -> host points and the G1LF batch (lazy: the sum of two batches)."""
    ks = [rng.randrange(0, 50) for _ in range(w * b)]
    pts = [G1.mul(k, GEN) if k else None for k in ks]
    halves = [(rng.randrange(1, 40), k) for k in ks]
    a = tgf.encode_lf([G1.mul(h, GEN) for h, _ in halves], device="cpu")
    bb = tgf.encode_lf([G1.add(G1.mul(k, GEN) if k else None, G1.neg(G1.mul(h, GEN)))
                        for h, k in halves], device="cpu")
    return ks, pts, tgf.add_lf(a, bb)


def test_scan_add_buckets_is_a_suffix_sum():
    rng = random.Random(31)
    w, b = 3, 8
    ks, _, p = _buckets(rng, w, b)
    got = tgf.decode_lf(tmsm._scan_add_buckets(p, w, b))
    want = []
    for wi in range(w):
        for bi in range(b):
            k = sum(ks[wi * b + bi : (wi + 1) * b])
            want.append(G1.mul(k, GEN) if k else None)
    assert got == want


@pytest.mark.parametrize("pre,b,post", [(3, 8, 1), (2, 4, 4), (1, 16, 2)])
def test_tree_sum_axis_sums_the_middle_axis(pre, b, post):
    rng = random.Random(pre * b * post)
    ks, _, p = _buckets(rng, pre, b * post)
    got = tgf.decode_lf(tmsm._tree_sum_axis(p, params.FQ_LIMBS, pre, b, post))
    k3 = np.asarray(ks).reshape(pre, b, post).sum(axis=1).reshape(-1)
    assert got == [G1.mul(int(k), GEN) if k else None for k in k3]


@pytest.mark.parametrize("w,b", [(3, 8), (2, 64), (2, 128), (1, 512)])
def test_weighted_bucket_sum_matches_host_sum(w, b):
    """sum_i (i + 1) * S_i per window: the double suffix scan for b <= 64,
    the chunked tree formulation above."""
    rng = random.Random(w * b)
    ks, _, p = _buckets(rng, w, b)
    got = tmsm._weighted_bucket_sum(p, w, b)
    assert got.x.shape == (params.FQ_LIMBS, w)
    want = []
    for wi in range(w):
        k = sum((i + 1) * ks[wi * b + i] for i in range(b)) % R
        want.append(G1.mul(k, GEN) if k else None)
    assert tgf.decode_lf(got) == want


def test_weighted_bucket_sum_matches_the_affine_twin():
    rng = random.Random(77)
    w, b = 2, 128
    _, pts, p = _buckets(rng, w, b)
    xs = limbs.to_tensor(limbs.to_mont_host([q[0] if q else 0 for q in pts], params.Q, 24).T, "cpu")
    ys = limbs.to_tensor(limbs.to_mont_host([q[1] if q else 0 for q in pts], params.Q, 24).T, "cpu")
    inf = torch.tensor([[0 if q else 1 for q in pts]], dtype=torch.int32)
    af = tmsm._weighted_bucket_sum_af(tga.G1AF(xs, ys, inf), w, b)
    assert tga.decode_af(af) == tgf.decode_lf(tmsm._weighted_bucket_sum(p, w, b))


# -- (d) the MSM's cases in both modes ----------------------------------------------


@pytest.mark.parametrize("c", [8, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_msm_matches_oracle_in_both_modes(mode, case, c):
    scalars, pts = CASES[case]()
    assert tmsm.msm_host(scalars, pts, c=c, device="cpu") == msm_naive(scalars, pts)


def test_msm_300_points_at_auto_c_in_both_modes(mode):
    rng = random.Random(301)
    pts = _chain(rng, 300)
    scalars = [rng.randrange(R) for _ in range(300)]
    scalars[0], scalars[1], pts[2] = 0, R - 1, None
    assert tmsm.msm_host(scalars, pts, device="cpu") == msm_naive(scalars, pts)


def test_projective_mode_runs_the_projective_functions(monkeypatch):
    """With the mode at "0" the rounds go through add_sel_lf, the top window's
    merge through add_sel_proj_lf, and nothing through madd."""
    calls = {"add_sel": 0, "add_sel_proj": 0, "madd": 0}
    real_sel, real_proj = tgf.add_sel_lf, tgf.add_sel_proj_lf

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tconfig, "MSM_AFFINE_MODE", "0")
    monkeypatch.setattr(tgf, "add_sel_lf", count("add_sel", real_sel))
    monkeypatch.setattr(tgf, "add_sel_proj_lf", count("add_sel_proj", real_proj))
    monkeypatch.setattr(tga, "madd", count("madd", tga.madd))
    scalars, pts = CASES["random"]()
    assert tmsm.msm_host(scalars, pts, c=8, device="cpu") == msm_naive(scalars, pts)
    _, s = tmsm._top_window_split(8, tmsm._nwin(8))
    assert calls["add_sel"] > 0 and calls["madd"] == 0
    assert calls["add_sel_proj"] == s.bit_length() - 1 > 0


def test_windows_agree_between_the_modes():
    """Per-window totals are group elements: the same in both pipelines."""
    scalars, pts = CASES["complete_law"]()
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    raw = _raw(scalars)
    out = {}
    for name, value in MODES.items():
        tconfig.MSM_AFFINE_MODE = value
        try:
            out[name] = tgf.decode_lf(tmsm.msm_windows(raw, table, c=8))
        finally:
            tconfig.MSM_AFFINE_MODE = "1"
    assert out["projective"] == out["affine"]
    assert len(out["affine"]) == tmsm._nwin(8)


# -- the device entry point ---------------------------------------------------------


def test_msm_device_entry_matches_oracle(mode):
    """msm(scalars, points, c=4): bucket pipeline and window combine without
    the host; one projective point, canonical limbs."""
    scalars, pts = CASES["random"]()
    acc = tmsm.msm(_raw(scalars), tg1.encode_points(pts, device="cpu"), c=4, device="cpu")
    assert acc.batch_shape == () and acc.x.dtype == torch.int32
    assert tg1.decode_points(acc) == [msm_naive(scalars, pts)]


def test_msm_device_entry_returns_canonical_limbs(monkeypatch):
    """The window combine ends every step in normalize_lf: the result is
    canonical, and to_affine gives the limbs of the encoded oracle point."""
    monkeypatch.setattr(tconfig, "MSM_AFFINE_MODE", "0")
    scalars, pts = CASES["duplicates"]()
    acc = tmsm.msm(_raw(scalars), tg1.encode_points(pts, device="cpu"), c=4, device="cpu")
    canon = tgf.normalize_lf(tgf.G1LF(*(a.reshape(1, -1).T for a in acc)))
    assert all(torch.equal(c[:, 0], a) for c, a in zip(canon, acc))
    want = tg1.encode_points([msm_naive(scalars, pts)], device="cpu")
    got = tg1.to_affine(tg1.G1Points(*(a[None] for a in acc)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- the path at the commit level, at a size that takes the chunked reduction ----------


@pytest.fixture(scope="module")
def srs_2048():
    return TSrs.generate(2047, seed=b"test-torch-msm-projective", device="cpu")


def test_commit_many_lf_gives_the_same_points_in_both_modes(srs_2048, monkeypatch):
    """kzg.commit_many_lf at 2048 points (c = 10: 512 buckets a window, the
    chunked reduction and a split top window) and at 700, with a shift."""
    rng = random.Random(2048)
    coeffs = [[rng.randrange(R) for _ in range(n)] for n in (2048, 700, 2048)]
    polys = [tlf.encode(xs, device="cpu") for xs in coeffs]
    out = {}
    for name, value in MODES.items():
        monkeypatch.setattr(tconfig, "MSM_AFFINE_MODE", value)
        out[name] = (tkzg.commit_many_lf(srs_2048, polys),
                     tkzg.commit_shifted_lf(srs_2048, polys[1], 1000))
    assert out["projective"] == out["affine"]
    assert out["projective"][0][0] != out["projective"][0][2]
    # the JAX package's commitments over its own SRS of the same seed
    jsrs = JSrs.generate(2047, seed=b"test-torch-msm-projective")
    jpolys = [jlf.encode(xs) for xs in coeffs]
    assert out["projective"][0] == jkzg.commit_many_lf(jsrs, jpolys)
    assert out["projective"][1] == jkzg.commit_shifted_lf(jsrs, jpolys[1], 1000)
    # and against the host oracle over the SRS's own points
    pts = srs_2048.host_affine()
    assert out["projective"][0][1] == msm_pippenger_jac(tlf.decode(polys[1]), pts[:700])
    assert out["projective"][1] == msm_pippenger_jac(tlf.decode(polys[1]), pts[1000:1700])
