"""The port's int8 field engine (aleo_tpu_torch.fields.fmat, fmat_kernels) on
the CPU against aleo_tpu.fields.fmat, the fused reduce body of
aleo_tpu.fields.fmat_pallas (run as plain jnp, as tests/test_fmat.py runs it)
and host bigints.

Tolerance 0 on the raw limbs: both sides do the same integer arithmetic, so
even the lazy representative is equal, not only the value mod p."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields import fmat as jfmat
from aleo_tpu.fields import fmat_pallas as jpallas
from aleo_tpu_torch import config
from aleo_tpu_torch.fields import fmat as tfmat
from aleo_tpu_torch.fields import fmat_kernels as tk

R = params.R
L7, K7 = tfmat.L7, tfmat.K7


def _same(j, t):
    """A jnp array and a torch tensor hold the same integers."""
    j = np.asarray(j).astype(np.int64)
    t = t.numpy().astype(np.int64)
    assert j.shape == t.shape
    assert np.array_equal(j, t)


def _limbs16(vals):
    return np.array(
        [[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(16)], dtype=np.uint32
    )


def _both(a: np.ndarray, ttype=torch.int32):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a)).to(ttype)


# -- constants and host-side banks -------------------------------------------------


def test_constants_match_the_reference():
    for name in ("LIMB_BITS", "BASE", "L7", "K7", "R7", "P", "NPRIME", "R7_MOD"):
        assert getattr(tfmat, name) == getattr(jfmat, name), name


def test_to7_and_from7_match_the_reference():
    rng = random.Random(9100)
    xs = [0, 1, tfmat.R7 - 1, R, 2 * R - 1] + [rng.randrange(tfmat.R7) for _ in range(40)]
    got = tfmat.to7_np(xs)
    assert got.dtype == np.int8 and np.array_equal(got, jfmat.to7_np(xs))
    assert list(tfmat.from7_np(got)) == xs
    assert list(tfmat.from7_np(got)) == list(jfmat.from7_np(got))
    wide = np.concatenate([got, got], axis=1)           # K7 limbs per row
    assert list(tfmat.from7_np(wide)) == list(jfmat.from7_np(wide))
    with pytest.raises(AssertionError):
        tfmat.to7_np([tfmat.R7])


@pytest.mark.parametrize("out_cols", [L7, K7])
def test_band_np_matches_the_reference(out_cols):
    rng = random.Random(9101)
    for c in (0, 1, tfmat.NPRIME, tfmat.P, rng.randrange(tfmat.R7)):
        got = tfmat.band_np(c, out_cols)
        want = jfmat.band_np(c, out_cols)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_reduce_mats_match_the_reference():
    for got, want in zip(tfmat._reduce_mats(), jfmat._reduce_mats()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bank_functions_match_the_reference():
    rng = random.Random(9102)
    consts = [0, 1, R - 1, R + 5] + [rng.randrange(R) for _ in range(13)]
    got, want = tfmat.toeplitz_bank_np(consts), jfmat.toeplitz_bank_np(consts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    mat = [[rng.randrange(R) for _ in range(5)] for _ in range(3)]     # R x M, not square
    got, want = tfmat.dft_bank_np(mat), jfmat.dft_bank_np(mat)
    assert got.dtype == want.dtype and got.shape == (K7 * 3, L7 * 5)
    assert np.array_equal(got, want)


def test_reduce_kernel_constants_are_the_limbs_of_nprime_and_p():
    c = tk._reduce_consts()
    assert c.dtype == np.int32 and c.flags["C_CONTIGUOUS"] and c.shape == (2 * L7,)
    assert np.array_equal(c[:L7], tfmat.to7_np([tfmat.NPRIME])[0])
    assert np.array_equal(c[L7:], tfmat.to7_np([tfmat.P])[0])


# -- repacking ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64,), (3, 16)])
def test_pack7_unpack7_round_trip_and_match_the_reference(shape):
    rng = random.Random(9001)
    count = int(np.prod(shape))
    vals = [0, 1, 2 * R - 1, (1 << 256) - 1][: min(4, count)]
    vals += [rng.randrange(2 * R) for _ in range(count - len(vals))]   # lazy range < 2p
    x16 = _limbs16(vals).reshape((16,) + shape)
    jx, tx = _both(x16.astype(np.int32))
    jx = jx.astype(jnp.uint32)
    t7 = tfmat.pack7(tx)
    assert t7.dtype == torch.int8 and t7.shape == (L7,) + shape
    _same(jfmat.pack7(jx), t7)
    back = tfmat.unpack7(t7)
    assert back.dtype == torch.int32
    _same(jfmat.unpack7(jnp.asarray(t7.numpy())), back)
    assert torch.equal(back, tx)


def test_pack7_takes_a_transposed_view():
    rng = random.Random(9002)
    vals = [rng.randrange(2 * R) for _ in range(32)]
    tx = torch.from_numpy(_limbs16(vals).astype(np.int32))
    view = tx.T.contiguous().T                      # (16, 32), lanes strided
    assert not view.is_contiguous()
    assert torch.equal(tfmat.pack7(view), tfmat.pack7(tx))


def test_encode7_decode7():
    rng = random.Random(9003)
    xs = [rng.randrange(R) for _ in range(20)]
    t = tfmat.encode7(xs, device="cpu")
    _same(jfmat.encode7(xs), t)
    assert tfmat.decode7(t) == xs == jfmat.decode7(jnp.asarray(t.numpy()))


# -- carries -------------------------------------------------------------------------


def _planted_columns(K, peels, rng, width=96):
    """Random column sums inside the carry's contract with the hard cases
    among them: zeros, all 127 (a ripple through every limb once a carry
    enters), all 127 with a carry entering at the bottom, the largest sums a
    radix-64 stage can produce."""
    top = (1 << 26) if peels == 4 else 38 * 127 * 127 + 1
    cols = np.array(
        [[rng.randrange(top) for _ in range(width)] for _ in range(K)], dtype=np.int32
    )
    cols[:, 0] = 0
    cols[:, 1] = 127
    cols[:, 2] = 127
    cols[0, 2] = 128
    cols[:, 3] = top - 1
    cols[:, 4] = 127
    cols[K // 2, 4] = 255
    return cols


@pytest.mark.parametrize("peels", [3, 4])
@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_carry_cols_matches_the_reference(peels, layout):
    rng = random.Random(9200 + peels)
    for K in (K7, L7):
        cols = _planted_columns(K, peels, rng)
        axis = 0
        if layout == "3d":
            cols = np.ascontiguousarray(cols.reshape(K, 4, 24).transpose(1, 0, 2))
            axis = 1
        jc, tc = _both(cols)
        want = jfmat.carry_cols(jc, peels, axis)
        _same(want, tfmat.carry_cols(tc, peels, axis))
        got8 = tk.carry8(tc, peels, axis)            # CPU tensor: the plain version
        assert got8.dtype == torch.int8
        _same(want, got8)
        _same(jpallas._carry_body(jc if axis == 0 else jc[1], peels),
              got8 if axis == 0 else got8[1])


def test_carry_gives_the_digits_of_the_column_value():
    """What the sequential carry of the CUDA kernels computes: the base-128
    digits of the column's value mod 128^K."""
    rng = random.Random(9210)
    cols = _planted_columns(K7, 4, rng, width=16)
    got = tk.carry8(torch.from_numpy(cols), 4, 0).numpy()
    for m in range(cols.shape[1]):
        v = sum(int(cols[k, m]) << (7 * k) for k in range(K7)) % (1 << (7 * K7))
        assert int(tfmat.from7_np(got[:, m])) == v


# -- the reduction ---------------------------------------------------------------------


def _real_columns(rng, d=8, T=16):
    """Raw convolution columns from a real bank product, and their host values."""
    mat = [[rng.randrange(R) for _ in range(d)] for _ in range(d)]
    xs = [rng.randrange(R) for _ in range(d * T)]
    bank = tfmat.dft_bank_np(mat)
    x7 = np.ascontiguousarray(tfmat.to7_np(xs).T).reshape(L7 * d, T)
    t_cols = (bank.astype(np.int32) @ x7.astype(np.int32)).reshape(K7, d * T)
    return t_cols, mat, xs


def _reduce_sequential_np(x):
    """The algorithm of the CUDA kernel fmat_reduce, in numpy: sequential
    carries, t from the low 38 rows only, both band products from the limbs
    of N' and p, the low half of u only handing its carry on."""
    c = tk._reduce_consts().astype(np.int64)
    npl, pl = c[:L7], c[L7:]
    x = x.astype(np.int64)
    M = x.shape[1]
    t = np.zeros((L7, M), dtype=np.int64)
    carry = np.zeros(M, dtype=np.int64)
    for k in range(L7):
        v = x[k] + carry
        t[k], carry = v & 127, v >> 7
    m = np.zeros((L7, M), dtype=np.int64)
    carry = np.zeros(M, dtype=np.int64)
    for k in range(L7):
        acc = carry + sum(npl[k - j] * t[j] for j in range(k + 1))
        m[k], carry = acc & 127, acc >> 7
    out = np.zeros((L7, M), dtype=np.int8)
    carry = np.zeros(M, dtype=np.int64)
    for k in range(K7):
        acc = x[k] + carry + sum(
            pl[k - j] * m[j] for j in range(L7) if 0 <= k - j < L7
        )
        assert acc.max() < 1 << 31
        if k >= L7:
            out[k - L7] = acc & 127
        else:
            assert not (acc & 127).any()
        carry = acc >> 7
    return out


def test_mont_reduce_matches_the_reference_and_the_fused_body(monkeypatch):
    rng = random.Random(9004)
    t_cols, _, _ = _real_columns(rng)
    # the largest sums a radix-64 stage can produce, and zeros
    t_cols[:, 0] = np.minimum(np.arange(1, K7 + 1), K7 - np.arange(K7)) * 64 * 127 * 127
    t_cols[:, 1] = 0
    jt, tt = _both(t_cols)
    want = jfmat.mont_reduce_cols(jt)                 # CPU backend: the plain chain
    Wnp, Wp = jfmat._reduce_mats()
    _same(want, torch.from_numpy(np.array(
        jpallas._reduce_body(jt, jnp.asarray(Wnp), jnp.asarray(Wp)))))
    plain = tk._reduce_plain(tt)
    assert plain.dtype == torch.int8 and plain.is_contiguous()
    _same(want, plain)
    assert config.FUSED_REDUCE
    _same(want, tfmat.mont_reduce_cols(tt))           # -> mont_reduce8 -> plain on the CPU
    assert np.array_equal(_reduce_sequential_np(t_cols), plain.numpy())
    monkeypatch.setattr(config, "FUSED_REDUCE", False)
    unfused = tfmat.mont_reduce_cols(tt)              # the chain with carry8
    assert unfused.dtype == torch.int8 and unfused.is_contiguous()
    _same(want, unfused)
    assert all(v == 0 for v in tk.LAUNCHES.values())  # no kernel on a CPU tensor


def test_mont_reduce_along_axis_1_matches_the_reference():
    rng = random.Random(9005)
    t_cols, _, _ = _real_columns(rng, d=4, T=8)
    cols3 = np.ascontiguousarray(t_cols.reshape(K7, 4, 8).transpose(1, 0, 2))
    jt, tt = _both(cols3)
    _same(jfmat.mont_reduce_cols(jt, axis=1), tfmat.mont_reduce_cols(tt, axis=1))


def test_mont_reduce_is_the_montgomery_reduction():
    """u = t / R7 mod p, u < 1.1 p, for columns of a real product."""
    rng = random.Random(9006)
    t_cols, _, _ = _real_columns(rng, d=8, T=4)
    u = tk._reduce_plain(torch.from_numpy(t_cols)).numpy()
    r7_inv = pow(tfmat.R7, -1, R)
    for m in range(t_cols.shape[1]):
        t = sum(int(t_cols[k, m]) << (7 * k) for k in range(K7))
        got = int(tfmat.from7_np(u[:, m]))
        assert got % R == t * r7_inv % R
        assert got * 10 < 11 * R


# -- the two products ------------------------------------------------------------------


def test_dft_apply_matches_the_reference_and_host():
    rng = random.Random(9007)
    d, T = 4, 8
    t_cols, mat, xs = _real_columns(rng, d, T)
    bank = tfmat.dft_bank_np(mat)
    x7 = tfmat.encode7(xs, device="cpu").reshape(L7 * d, T)
    y = tfmat.dft_apply(torch.from_numpy(bank), x7, d)
    assert y.dtype == torch.int8 and y.shape == (L7 * d, T)
    _same(jfmat.dft_apply(jnp.asarray(bank), jnp.asarray(x7.numpy()), d), y)
    got = tfmat.decode7(y.reshape(L7, d * T))
    for r in range(d):
        for t in range(T):
            assert got[r * T + t] == sum(mat[r][m] * xs[m * T + t] for m in range(d)) % R


def test_int_mm_is_exact_at_a_radix_64_column_sum():
    """A radix-64 stage's sums pass 2^24: the int8 product must not round."""
    a = torch.full((32, 38 * 64), 127, dtype=torch.int8)
    b = torch.full((38 * 64, 8), 127, dtype=torch.int8)
    assert int(torch._int_mm(a, b).max()) == 38 * 64 * 127 * 127 > 1 << 24


@pytest.mark.parametrize("as_float", [False, True])
def test_toeplitz_apply_matches_the_reference_and_host(as_float):
    rng = random.Random(9008)
    B, T = 4, 8
    consts = [rng.randrange(R) for _ in range(B)]
    xs = [rng.randrange(R) for _ in range(B * T)]
    bank = tfmat.toeplitz_bank_np(consts)
    x = torch.stack(
        [tfmat.encode7(xs[b * T : (b + 1) * T], device="cpu") for b in range(B)]
    )                                                   # (B, L7, T)
    tb = torch.from_numpy(bank)
    y = tfmat.toeplitz_apply(tb.float() if as_float else tb,
                             x.float() if as_float else x)
    assert y.dtype == torch.int8 and y.shape == (B, L7, T)
    _same(jfmat.toeplitz_apply(jnp.asarray(bank), jnp.asarray(x.numpy())), y)
    for b in range(B):
        assert tfmat.decode7(y[b]) == [consts[b] * v % R for v in xs[b * T : (b + 1) * T]]


# -- the wrappers -------------------------------------------------------------------------


def test_wrappers_check_what_a_kernel_is_given():
    good = torch.zeros((K7, 8), dtype=torch.int32)
    tk._check("x", good, True)
    with pytest.raises(ValueError):
        tk._check("x", good.to(torch.int64), True)
    with pytest.raises(ValueError):
        tk._check("x", good.T, True)
    with pytest.raises(ValueError):
        tk._check("x", good[:, :0], True)
    with pytest.raises(ValueError):
        tk._check("x", good, good.shape[0] == L7)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        tk._launched("fmat_reduce", 9)
    tk._launched("fmat_carry3d", 0)
    assert tk.LAUNCHES["fmat_carry3d"] == 1
    tk.reset_launches()
    assert set(tk.LAUNCHES) == {"fmat_reduce", "fmat_carry2d", "fmat_carry3d"}
    assert all(v == 0 for v in tk.LAUNCHES.values())
