"""The port's MatNTT (aleo_tpu_torch.ntt.matntt) on the CPU against
aleo_tpu.ntt.matntt, the port's butterfly network and the host oracle, and
the size dispatch of aleo_tpu_torch.ntt.ntt.

Tolerance 0: the plans' banks are equal byte for byte and the transforms'
raw 16-bit limbs are equal (the same lazy representative, not only the same
value mod p)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.ntt import matntt as jmat
from aleo_tpu.reference import polynomial as rpoly
from aleo_tpu_torch import config
from aleo_tpu_torch.fields import fmat as tfmat
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.ntt import matntt as tmat
from aleo_tpu_torch.ntt import ntt as tntt

torch.set_num_threads(2)        # several test workers share the machine

R = params.R
SHIFT = params.FR_GENERATOR


def _encode(xs):
    """Host ints -> the port's (16, n) int32 tensor and the same limbs for jnp."""
    t = tlf.encode(xs, device="cpu")
    return jnp.asarray(t.numpy().astype(np.uint32)), t


def _same_limbs(j, t):
    assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def _butterfly(monkeypatch):
    """Send every size to the butterfly network."""
    monkeypatch.setattr(config, "MATNTT_MIN_N", 1 << 40)


# -- plans -------------------------------------------------------------------------------


def test_factorize_and_plan_groups_match_the_reference():
    for k in range(1, 25):
        dims = tmat._factorize(1 << k)
        assert dims == jmat._factorize(1 << k) and max(dims) <= 64
        assert int(np.prod(dims)) == 1 << k
    assert tmat._factorize(1 << 17) == [64, 64, 32]
    for d in (4, 16, 32, 64):
        for m_next in (1, 4, 64, 2048, 1 << 13):
            for bpre in (1, 3, 64, 4096):
                assert tmat._plan_groups(d, m_next, bpre) == jmat._plan_groups(d, m_next, bpre)
    assert (tmat.MIN_LANES, tmat.MAX_TW_BATCH) == (jmat.MIN_LANES, jmat.MAX_TW_BATCH)


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_plan_banks_equal_the_references(n, inverse):
    fold = pow(n, -1, R) if inverse else 1
    pj, pt = jmat.Plan(n, inverse, fold), tmat.Plan(n, inverse, fold)
    assert (pj.n, pj.dims, pj.w) == (pt.n, pt.dims, pt.w)
    assert len(pj.dft_banks) == len(pt.dft_banks) == len(pt.dims)
    for a, b in zip(pj.dft_banks, pt.dft_banks):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes() and a.shape == b.shape
    assert len(pj.tw) == len(pt.tw) == len(pt.dims) - 1
    for (gj, fj), (gt, ft) in zip(pj.tw, pt.tw):
        assert gj == gt and len(fj) == len(ft)
        for a, b in zip(fj, ft):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes() and a.shape == b.shape


@pytest.mark.parametrize("n", [256, 4096])
def test_scale_plan_banks_equal_the_references(n):
    dims = tuple(tmat._factorize(n))
    for base in (SHIFT, pow(SHIFT, -1, R)):
        sj, st = jmat.ScalePlan(n, base, dims), tmat.ScalePlan(n, base, dims)
        assert len(sj.banks) == len(st.banks) == len(dims)
        for a, b in zip(sj.banks, st.banks):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_banks_are_uploaded_once_per_device():
    n = 256
    xs = list(range(n))
    _, t = _encode(xs)
    tmat.coset_ntt_lf16(t, SHIFT)
    p, sp = tmat._plans(n, False, SHIFT)
    held = {k: v.data_ptr() for k, v in list(p._dev.items()) + list(sp._dev.items())}
    assert len(p._dev) == len(p.dft_banks) + sum(len(f) for _, f in p.tw)
    assert len(sp._dev) == len(sp.banks)
    tmat.coset_ntt_lf16(t, SHIFT)
    p2, sp2 = tmat._plans(n, False, SHIFT)
    assert p2 is p and sp2 is sp
    assert held == {k: v.data_ptr() for k, v in list(p._dev.items()) + list(sp._dev.items())}
    assert p.dev(("dft", 0), p.dft_banks[0], "cpu").dtype == torch.int8
    assert p.dev(("tw", 0, 0), p.tw[0][1][0], "cpu", torch.float32).dtype == torch.float32


# -- the transforms ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize(
    "name,args",
    [("ntt_lf16", ()), ("intt_lf16", ()),
     ("coset_ntt_lf16", (SHIFT,)), ("coset_intt_lf16", (SHIFT,))],
)
def test_lf16_matches_the_reference_and_the_butterfly(n, name, args, monkeypatch):
    rng = random.Random(9300 + n)
    xs = [rng.randrange(R) for _ in range(n)]
    j, t = _encode(xs)
    got = getattr(tmat, name)(t, *args)
    assert got.dtype == torch.int32 and got.shape == (16, n)
    _same_limbs(getattr(jmat, name)(j, *args), got)
    # lazy output below 1.1 p
    vals = [int(v) for v in tfmat.from7_np(tfmat.pack7(got).numpy().T)]
    assert max(vals) * 10 < 11 * R
    _butterfly(monkeypatch)
    want = getattr(tntt, name.replace("_lf16", "_lf"))(t, *args)
    assert torch.equal(tlf.normalize(got), tlf.normalize(want))


def test_ntt_lf16_matches_the_host_oracle():
    n = 256
    rng = random.Random(9305)
    xs = [rng.randrange(R) for _ in range(n)]
    _, t = _encode(xs)
    assert tlf.decode(tmat.ntt_lf16(t)) == rpoly.ntt(xs)
    assert tlf.decode(tmat.coset_ntt_lf16(t, SHIFT)) == rpoly.coset_ntt(xs, SHIFT)
    assert tlf.decode(tmat.intt_lf16(tmat.ntt_lf16(t))) == xs
    assert tlf.decode(tmat.coset_intt_lf16(tmat.coset_ntt_lf16(t, SHIFT), SHIFT)) == xs


def test_lazy_input_below_2p_is_accepted():
    """The butterfly hands lazy values (< 2p) on; MatNTT re-slices the raw bits."""
    n = 256
    rng = random.Random(9306)
    xs = [rng.randrange(R) for _ in range(n)]
    _, t = _encode(xs)
    lazy = tlf.add(t, tlf.zero(n, device="cpu"))        # same values
    # add p to every raw value: the same field elements, another representative
    raw = [sum(int(t[i, k]) << (16 * i) for i in range(16)) + R for k in range(n)]
    t2 = torch.from_numpy(np.array(
        [[(v >> (16 * i)) & 0xFFFF for v in raw] for i in range(16)], dtype=np.int32))
    assert tlf.decode(tmat.ntt_lf16(t2)) == tlf.decode(tmat.ntt_lf16(lazy)) == rpoly.ntt(xs)
    _same_limbs(jmat.ntt_lf16(jnp.asarray(t2.numpy().astype(np.uint32))), tmat.ntt_lf16(t2))


@pytest.mark.parametrize(
    "name,args",
    [("ntt", ()), ("intt", ()), ("coset_ntt", (SHIFT,)), ("coset_intt", (SHIFT,))],
)
def test_batch_lf16_matches_the_reference_and_the_single_transform(name, args):
    n, k = 256, 3
    rng = random.Random(9006)
    cols = [[rng.randrange(R) for _ in range(n)] for _ in range(k)]
    pairs = [_encode(c) for c in cols]
    jb = jnp.stack([p[0] for p in pairs])                # (k, 16, n)
    tb = torch.stack([p[1] for p in pairs])
    got = getattr(tmat, f"{name}_batch_lf16")(tb, *args)
    assert got.shape == (k, 16, n) and got.is_contiguous()
    _same_limbs(getattr(jmat, f"{name}_batch_lf16")(jb, *args), got)
    for i in range(k):
        one = getattr(tmat, f"{name}_lf16")(pairs[i][1], *args)
        assert tlf.decode(got[i]) == tlf.decode(one)
    one_wide = getattr(tmat, f"{name}_batch_lf16")(tb[:1], *args)
    assert one_wide.shape == (1, 16, n) and torch.equal(one_wide[0], got[0])


# -- dispatch ------------------------------------------------------------------------------


def test_use_matntt_is_decided_by_size_alone(monkeypatch):
    assert config.MATNTT_MIN_N == 1 << 14 and config.FUSED_REDUCE
    assert tntt._use_matntt(1 << 14) and tntt._use_matntt(1 << 17)
    assert not tntt._use_matntt(1 << 13) and not tntt._use_matntt((1 << 14) + 8)
    monkeypatch.setattr(config, "MATNTT_MIN_N", 256)
    assert tntt._use_matntt(256) and not tntt._use_matntt(128)


def test_entry_points_dispatch_to_matntt_above_the_threshold(monkeypatch):
    n = 256
    rng = random.Random(9307)
    xs = [rng.randrange(R) for _ in range(n)]
    _, t = _encode(xs)
    _butterfly(monkeypatch)
    want = [tntt.ntt_lf(t), tntt.intt_lf(t), tntt.coset_ntt_lf(t, SHIFT),
            tntt.coset_intt_lf(t, SHIFT)]
    want_ll = tntt.intt(t.T.contiguous())
    monkeypatch.setattr(config, "MATNTT_MIN_N", n)
    calls = []
    real = tmat._run
    monkeypatch.setattr(tmat, "_run", lambda *a, **k: calls.append(a[1:]) or real(*a, **k))
    got = [tntt.ntt_lf(t), tntt.intt_lf(t), tntt.coset_ntt_lf(t, SHIFT),
           tntt.coset_intt_lf(t, SHIFT)]
    assert calls == [(False, None), (True, None), (False, SHIFT), (True, SHIFT)]
    for g, w in zip(got, want):
        assert torch.equal(tlf.normalize(g), tlf.normalize(w))
    # the limbs-last entry (the indexer's) hands MatNTT a transposed view
    assert torch.equal(tntt.intt(t.T.contiguous()), want_ll)
    assert len(calls) == 5
    # below the threshold nothing reaches MatNTT
    tntt.ntt_lf(t[:, :128].contiguous())
    assert len(calls) == 5


@pytest.mark.parametrize("n", [8, 64])
def test_one_stage_plan_with_a_single_lane(n, monkeypatch):
    """A transform of one stage hands `dft_apply` a single lane, whose row
    stride is not the plain one: the product must not read it."""
    rng = random.Random(31 + n)
    _, t = _encode([rng.randrange(R) for _ in range(n)])
    want = tlf.normalize(tntt.ntt_lf(t))                 # the butterfly network
    assert len(tmat.plan(n, False, 1).dims) == 1
    monkeypatch.setattr(config, "MATNTT_MIN_N", 4)
    assert torch.equal(tlf.normalize(tntt.ntt_lf(t)), want)
    assert torch.equal(tlf.normalize(tntt.intt_lf(tntt.coset_intt_lf(
        tntt.coset_ntt_lf(tntt.ntt_lf(t), SHIFT), SHIFT))), tlf.normalize(t))
