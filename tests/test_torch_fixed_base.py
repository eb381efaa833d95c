"""The fixed-base MSM of the port (`aleo_tpu_torch.msm.fixed_base`, and the
fixed-base branches of `aleo_tpu_torch.pcs.kzg`) on the CPU, where the
kernels' plain versions run, against the JAX package and the host oracle.

Inputs are made from seeds. Tolerance 0 throughout: table rows as
normalized limbs, MSMs and commitments as decoded group elements.

The JAX package's own fixed-base MSM (`msm_fixed_host`, and its kzg with
FIXED_BASE_MODE "1") spends about five minutes in XLA compilation on a CPU
for one call at n = 32, more than this suite can give it (its own test,
tests/test_msm.py, is marked slow). So its table build is held here
directly, its lane-split functions too, and its MSMs through the yardstick
its own test uses: its host oracle `aleo_tpu.reference.msm.msm_naive`. The JAX package's
commitments are its kzg's on the CPU, which run the host Pippenger."""

import pickle
import random

import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1 as jg1
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu.msm import fixed_base as jfb
from aleo_tpu.pcs import kzg as jkzg
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference.msm import msm_naive
from aleo_tpu_torch import config
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.msm import fixed_base as tfb
from aleo_tpu_torch.pcs import kzg as tkzg
from aleo_tpu_torch.pcs.srs import srs_from_numpy
from aleo_tpu_torch.reference.curve import G1

torch.set_num_threads(2)        # several test workers share the machine

R, Q, L = params.R, params.Q, params.FQ_LIMBS
# F1's shape class at a CPU size: an SRS of 34 powers, so that a shifted
# commit of 31 coefficients at shift 3 clamps its padded size to 31 (a
# length one short of a power of two), k = 4, and c = 8 so that the
# sub-split is 2, as (n = 32767, k = 4, shift = 3, c = 13) is at full size.
F1_DEG, F1_N, F1_SHIFT, F1_C, F1_K = 33, 31, 3, 8, 4


@pytest.fixture(scope="module")
def srs_pair(tmp_path_factory):
    jsrs = JSrs.generate(F1_DEG, seed=b"test-torch-fixed-base")
    path = tmp_path_factory.mktemp("srs") / "srs.pkl"
    jsrs.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return jsrs, srs_from_numpy(blob, device="cpu")


def _points(rng, n):
    G = G1.generator()
    pts = [G1.mul(rng.randrange(1, 5000), G) for _ in range(n)]
    pts[3] = None                                   # an identity base
    return pts


def _raw(scalars):
    return limbs.to_tensor(limbs.ints_to_limbs(scalars, params.FR_LIMBS), "cpu")


def _norm_rows(rows):
    """(M, 2L) rows -> (2L, M) canonical limbs, int64."""
    t = torch.as_tensor(np.asarray(rows).astype(np.int64)).to(torch.int32).T
    ring = lk.get_fq()
    return torch.cat([lk.normalize(ring, t[:L].contiguous()),
                      lk.normalize(ring, t[L:].contiguous())], dim=0)


@pytest.fixture(scope="module")
def table32():
    """An n = 32, c = 6 table (43 windows, 1376 rows) over seeded points
    with an identity base planted."""
    pts = _points(random.Random(61), 32)
    return pts, tfb.build_table(tg1.encode_points(pts, device="cpu"), c=6)


def test_build_table_rows_match_the_jax_package_and_the_host(table32):
    """Rows of the port's table, normalized, equal the JAX package's
    build_table rows at n = 32, c = 6 with an identity base planted;
    sampled rows decode to 2^(6w) * P_i."""
    rng = random.Random(62)
    n, c = 32, 6
    pts, got = table32
    want = jfb.build_table(jg1.encode_points(pts), c=c)
    assert (got.n, got.c, got.w) == (want.n, want.c, want.w) == (n, c, 43)
    assert got.rows.shape == (43 * n, 2 * L) and got.rows.dtype == torch.int32
    assert torch.equal(_norm_rows(got.rows), _norm_rows(want.rows))
    assert torch.equal(_norm_rows(got.rows), got.rows.T), "rows are stored canonical"
    xs = limbs.from_mont_host(got.rows[:, :L].numpy(), Q)
    ys = limbs.from_mont_host(got.rows[:, L:].numpy(), Q)
    for row in [0, 3, n - 1, 5 * n + 3, 17 * n + 9] + [rng.randrange(43 * n) for _ in range(40)]:
        w, i = divmod(row, n)
        p = None if pts[i] is None else G1.mul(1 << (c * w), pts[i])
        assert (None if (xs[row], ys[row]) == (0, 0) else (xs[row], ys[row])) == p, row


def test_lane_split_matches_the_jax_package():
    """_nwin and _sub_split, and the constants behind them, equal the JAX
    package's over the sizes a proof commits and F1's."""
    assert (tfb.NBITS, tfb.DEFAULT_C, tfb.TARGET_LANES) == (jfb.NBITS, jfb.DEFAULT_C,
                                                            jfb.TARGET_LANES)
    for c in (6, 8, 13):
        assert tfb._nwin(c) == jfb._nwin(c)
        for n in (4, 31, 32, 2048, 8191, 8192, 32767, 32768):
            for k in (1, 2, 4, 8):
                assert tfb._sub_split(c, n, k) == jfb._sub_split(c, n, k), (c, n, k)
    assert tfb._sub_split(13, 32767, 4) == 2 and tfb._nwin(13) == 20
    assert tfb._sub_split(F1_C, F1_N, F1_K) == 2


@pytest.mark.parametrize("k", [1, 2])
def test_msm_fixed_matches_the_host_oracle(table32, k):
    """msm_fixed_host (k = 1) and msm_fixed_batch_host (k = 2) over the
    n = 32, c = 6 table with an identity base, scalars 0 and r - 1 planted
    (the JAX package's tests/test_msm.py case), against msm_naive."""
    rng = random.Random(70 + k)
    n = 32
    pts, ft = table32
    scal = [[rng.randrange(R) for _ in range(n)] for _ in range(k)]
    scal[0][1], scal[0][7] = 0, R - 1
    if k == 1:
        got = [tfb.msm_fixed_host(_raw(scal[0]), ft)]
    else:
        got = tfb.msm_fixed_batch_host(torch.stack([_raw(s) for s in scal]), ft)
    assert got == [msm_naive(s, pts) for s in scal]


def _polys(rng, n, k):
    xs = [[rng.randrange(R) for _ in range(n)] for _ in range(k)]
    return xs, [jlf.encode(x) for x in xs], [tlf.encode(x, device="cpu") for x in xs]


def test_f1_shape_class_agrees(srs_pair, monkeypatch):
    """F1's shape class: commit_many_lf of four polynomials of 31
    coefficients at shift 3 over 34 powers (n_pad clamps to 31, W = 32,
    s = 2: one sub-lane merge level) with the fixed-base mode on, against
    the same call with it off, the JAX package's commitments (its host
    Pippenger) and, for the member with 0 and r - 1 planted, msm_naive."""
    jsrs, tsrs = srs_pair
    monkeypatch.setattr(tfb, "DEFAULT_C", F1_C)
    assert tkzg._pad_size(tsrs, F1_N, F1_SHIFT) == F1_N
    xs, jp, tp = _polys(random.Random(31), F1_N, F1_K)
    xs[0][0], xs[1][F1_N - 1] = 0, R - 1
    tp[0] = tlf.encode(xs[0], device="cpu")
    tp[1] = tlf.encode(xs[1], device="cpu")
    jp[0], jp[1] = jlf.encode(xs[0]), jlf.encode(xs[1])
    monkeypatch.setattr(config, "FIXED_BASE_MODE", "1")
    fixed = tkzg.commit_many_lf(tsrs, tp, shift=F1_SHIFT)
    table = tfb._CACHE[(tsrs.seed, F1_DEG, F1_SHIFT, F1_N, F1_C, "cpu")]
    assert (table.n, table.c, table.w) == (F1_N, F1_C, 32)
    monkeypatch.setattr(config, "FIXED_BASE_MODE", "0")
    variable = tkzg.commit_many_lf(tsrs, tp, shift=F1_SHIFT)
    host = tsrs.host_affine()[F1_SHIFT : F1_SHIFT + F1_N]
    # the JAX package's commitments are its host Pippenger's on the CPU
    assert fixed == variable == jkzg.commit_many_lf(jsrs, jp, shift=F1_SHIFT)
    assert fixed[0] == msm_naive(xs[0], host)


@pytest.mark.parametrize("call", ["commit_lf", "commit_shifted_lf", "commit_many_lf"])
def test_kzg_fixed_base_commits_match(srs_pair, monkeypatch, call):
    """The port's kzg with FIXED_BASE_MODE "1" equals its mode "0" and the
    JAX package's kzg, over sizes that pad (5 -> 8, 13 -> 16), that fill a
    class (16), that clamp (31 at shift 3), and a group of three (13, 16, 9)
    in one batch of three. c = 8, as in F1's shape class (tables are cached across
    these tests, as they are across the commits of a proof)."""
    jsrs, tsrs = srs_pair
    monkeypatch.setattr(tfb, "DEFAULT_C", F1_C)
    rng = random.Random(len(call))
    if call == "commit_many_lf":
        sizes, shift = [13, 5, 16, 9], 0
    elif call == "commit_lf":
        sizes, shift = [5, 16], 0
    else:
        sizes, shift = [F1_N, 30], F1_SHIFT
    polys = [_polys(rng, n, 1) for n in sizes]
    jp = [p[1][0] for p in polys]
    tp = [p[2][0] for p in polys]

    def run(mod, srs, ps):
        if call == "commit_many_lf":
            return mod.commit_many_lf(srs, ps, shift=shift)
        if call == "commit_lf":
            return [mod.commit_lf(srs, p) for p in ps]
        return [mod.commit_shifted_lf(srs, p, shift) for p in ps]

    monkeypatch.setattr(config, "FIXED_BASE_MODE", "1")
    fixed = run(tkzg, tsrs, tp)
    for n in sizes:
        n_pad = tkzg._pad_size(tsrs, n, shift)
        assert tfb._CACHE[(tsrs.seed, F1_DEG, shift, n_pad, F1_C, "cpu")].n == n_pad
    monkeypatch.setattr(config, "FIXED_BASE_MODE", "0")
    variable = run(tkzg, tsrs, tp)
    assert fixed == variable == run(jkzg, jsrs, jp)


def test_fixed_base_is_off_by_default_and_auto_follows_the_size(monkeypatch):
    """The default is "0"; "auto" takes the fixed-base MSM from
    FIXED_BASE_MIN_N points on, whatever the device; "1" always; "0" and
    "false" never. The table cache keys on the SRS, the slice and c."""
    assert config.FIXED_BASE_MODE == "0" and tfb.FIXED_BASE_MIN_N == 2048
    assert not tkzg._use_fixed_base(1 << 20)
    monkeypatch.setattr(config, "FIXED_BASE_MODE", "auto")
    assert not tkzg._use_fixed_base(2047) and tkzg._use_fixed_base(2048)
    monkeypatch.setattr(tfb, "FIXED_BASE_MIN_N", 16)
    assert not tkzg._use_fixed_base(15) and tkzg._use_fixed_base(16)
    monkeypatch.setattr(config, "FIXED_BASE_MODE", "1")
    assert tkzg._use_fixed_base(1)
    for off in ("0", "false"):
        monkeypatch.setattr(config, "FIXED_BASE_MODE", off)
        assert not tkzg._use_fixed_base(1 << 20)


def test_srs_table_cache(srs_pair):
    """One table per (SRS, shift, size, c, device), built once; a table of
    the first 8 powers is the first 8 rows of every window of the table of
    the first 16; window 0 holds the SRS points themselves."""
    _, tsrs = srs_pair
    a = tfb.srs_table(tsrs, 8, 0, c=F1_C)
    assert tfb.srs_table(tsrs, 8, 0, c=F1_C) is a
    b = tfb.srs_table(tsrs, 16, 0, c=F1_C)
    assert b is not a and (a.w, b.w) == (32, 32)
    for w in range(32):
        assert torch.equal(a.rows[w * 8 : w * 8 + 8], b.rows[w * 16 : w * 16 + 8]), w
    assert a.rows[:8, :L].tolist() == tsrs.powers.x[:8].tolist()
    assert a.rows[:8, L:].tolist() == tsrs.powers.y[:8].tolist()
    assert tfb.cached_bytes() == sum(t.rows.numel() * 4 for t in tfb._CACHE.values())
    assert tfb.cached_bytes() >= (8 + 16) * 32 * 2 * L * 4
