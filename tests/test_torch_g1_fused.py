"""The projective group law of the port on the CPU, where the wrappers of
aleo_tpu_torch.curves.g1_fused take their plain versions, against
aleo_tpu.curves.g1_fused as it runs on the CPU (its detour through the einsum
law of aleo_tpu.curves.g1, which returns canonical limbs), against
aleo_tpu.curves.g1 for the limbs-last law of aleo_tpu_torch.curves.g1, and
against the host curve oracle. Tolerance 0: field and group elements; limbs
are compared after normalize, masked lanes bit for bit."""

import pathlib
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1 as jg1
from aleo_tpu.curves import g1_fused as jgf
from aleo_tpu.reference.curve import G1
from aleo_tpu_torch import _build
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.curves import g1_fused as tgf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs

torch.set_num_threads(2)        # several test workers share the machine

Q, R = params.Q, params.R
L = params.FQ_LIMBS
GEN = G1.generator()
M = 64
ONE = (1 << 384) % Q

KINDS = ("P+P", "P+(-P) by value", "P+(-P) by sign", "identity+P", "P+identity",
         "identity+identity", "sentinel addend, sign set", "invalid lane")


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def _jlf(p):
    return jgf.G1LF(*(_j(c.numpy()) for c in p))


def _norm(p):
    return [c.numpy().astype(np.int64) for c in tgf.normalize_lf(tgf.G1LF(*p))]


def _same_limbs(t, j):
    for a, b in zip(_norm(t), j):
        assert np.array_equal(a, np.asarray(b).astype(np.int64))


@pytest.fixture(scope="module")
def lanes():
    """64 lanes of real curve points, every kind of KINDS planted in turn.
    The accumulator is a sum, so its z is generic; it is handed to both
    packages in canonical form. -> host points, tensors, flags."""
    rng = random.Random(64)
    base = [G1.mul(rng.randrange(1, 10_000), GEN) for _ in range(M)]
    other = [G1.mul(rng.randrange(1, 10_000), GEN) for _ in range(M)]
    addend = [G1.mul(rng.randrange(1, 10_000), GEN) for _ in range(M)]
    sign = [rng.randrange(2) for _ in range(M)]
    valid = [1] * M
    acc_pts = [G1.add(p, q) for p, q in zip(base, other)]
    planted = {}
    for k in range(0, M, 6):
        kind = KINDS[(k // 6) % len(KINDS)]
        planted.setdefault(kind, []).append(k)
        sign[k] = 0
        if kind == "P+P":
            addend[k] = acc_pts[k]
        elif kind == "P+(-P) by value":
            addend[k] = G1.neg(acc_pts[k])
        elif kind == "P+(-P) by sign":
            addend[k], sign[k] = acc_pts[k], 1
        elif kind == "identity+P":
            base[k], other[k], acc_pts[k] = None, None, None
        elif kind == "P+identity":
            addend[k] = None
        elif kind == "identity+identity":
            base[k], other[k], acc_pts[k], addend[k] = None, None, None, None
        elif kind == "sentinel addend, sign set":
            addend[k], sign[k] = None, 1
        else:
            valid[k] = 0
    assert set(planted) == set(KINDS)
    acc = tgf.add_lf(tgf.encode_lf(base, device="cpu"), tgf.encode_lf(other, device="cpu"))
    acc = tgf.normalize_lf(acc)
    add = tgf.encode_lf(addend, device="cpu")
    return {
        "acc_pts": acc_pts, "add_pts": addend, "sign": sign, "valid": valid,
        "acc": acc, "add": tgf.G1LF(*(c.contiguous() for c in add)),
        "sg": torch.tensor(sign, dtype=torch.int32),
        "vd": torch.tensor(valid, dtype=torch.int32), "planted": planted,
    }


def _want_sel(d):
    return [G1.add(p, G1.neg(q) if s else q) if v else p
            for p, q, s, v in zip(d["acc_pts"], d["add_pts"], d["sign"], d["valid"])]


def _table_xy(add: tgf.G1LF):
    """Affine addend planes with the (0, 0) sentinel on identity lanes, as
    msm.make_table stores them."""
    ident = (add.z == 0).all(dim=0, keepdim=True)
    zero = torch.zeros_like(add.x)
    return torch.where(ident, zero, add.x), torch.where(ident, zero, add.y)


# -- (a) the five functions against aleo_tpu.curves.g1_fused -------------------


def test_double_lf_matches_jax_and_oracle(lanes):
    got = tgf.double_lf(lanes["acc"])
    _same_limbs(got, jgf.double_lf(_jlf(lanes["acc"])))
    assert tgf.decode_lf(got) == [G1.double(p) for p in lanes["acc_pts"]]


def test_add_lf_matches_jax_and_oracle(lanes):
    got = tgf.add_lf(lanes["acc"], lanes["add"])
    _same_limbs(got, jgf.add_lf(_jlf(lanes["acc"]), _jlf(lanes["add"])))
    want = [G1.add(p, q) for p, q in zip(lanes["acc_pts"], lanes["add_pts"])]
    assert tgf.decode_lf(got) == want


def test_add_sel_lf_matches_jax_and_oracle(lanes):
    """The reference's CPU detour adds (x, y, 1) with the full law; Algorithm
    8 is Algorithm 7 at Z2 = 1 term by term, so the coordinates agree, not
    only the points."""
    px, py = _table_xy(lanes["add"])
    got = tgf.add_sel_lf(lanes["acc"], px, py, lanes["sg"], lanes["vd"])
    jgot = jgf.add_sel_lf(_jlf(lanes["acc"]), _j(px.numpy()), _j(py.numpy()),
                          _j(lanes["sg"].numpy()), _j(lanes["vd"].numpy()))
    _same_limbs(got, jgot)
    assert tgf.decode_lf(got) == _want_sel(lanes)
    # masked lanes (invalid, or the sentinel) hold the accumulator bit for bit
    masked = [k for kind in ("invalid lane", "sentinel addend, sign set", "P+identity",
                             "identity+identity") for k in lanes["planted"][kind]]
    for g, a in zip(got, lanes["acc"]):
        assert torch.equal(g[:, masked], a[:, masked])


def test_add_sel_proj_lf_matches_jax_and_oracle(lanes):
    got = tgf.add_sel_proj_lf(lanes["acc"], lanes["add"], lanes["sg"], lanes["vd"])
    jgot = jgf.add_sel_proj_lf(_jlf(lanes["acc"]), _jlf(lanes["add"]),
                               _j(lanes["sg"].numpy()), _j(lanes["vd"].numpy()))
    _same_limbs(got, jgot)
    assert tgf.decode_lf(got) == _want_sel(lanes)
    masked = lanes["planted"]["invalid lane"]
    for g, a in zip(got, lanes["acc"]):
        assert torch.equal(g[:, masked], a[:, masked])


def test_normalize_lf_matches_jax():
    rng = random.Random(12)
    vals = [rng.randrange(2 * Q) for _ in range(3 * M)]
    vals[:6] = [0, Q - 1, Q, Q + 1, 2 * Q - 1, ONE + Q]
    p = tgf.G1LF(*(
        limbs.to_tensor(limbs.ints_to_limbs(vals[i * M : (i + 1) * M], L).T, "cpu")
        for i in range(3)
    ))
    got = tgf.normalize_lf(p)
    for g, j in zip(got, jgf.normalize_lf(_jlf(p))):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(j).astype(np.int64))
    flat = [v for c in got for v in limbs.limbs_to_ints(c.numpy().T)]
    assert flat == [v % Q for v in vals]
    # 2p, the value neg(0) stores, reduces to 0
    two_p = limbs.to_tensor(limbs.ints_to_limbs([2 * Q], L).T, "cpu")
    assert int(tgf.normalize_lf(tgf.G1LF(two_p, two_p, two_p)).y.abs().max()) == 0


# -- lazy representatives: same values mod p, so the same limbs after normalize ---


def _lazy(p: tgf.G1LF, rng):
    """Add p to about half of the canonical values (every result stays < 2p)."""
    ring = lk.get_fq()
    out = []
    for c in p:
        plus = lk._lift(lambda cc, v: lk._carry(cc, v + cc["p"]), 1)(ring, c)
        pick = torch.tensor([rng.randrange(2) for _ in range(c.shape[1])]).bool()[None, :]
        out.append(torch.where(pick, plus, c))
    return tgf.G1LF(*out)


@pytest.mark.parametrize("fn", ["double", "add", "add_sel", "add_sel_proj"])
def test_lazy_inputs_give_the_same_values(lanes, fn):
    rng = random.Random(len(fn))
    acc, add = lanes["acc"], tgf.normalize_lf(lanes["add"])
    lacc, ladd = _lazy(acc, rng), _lazy(add, rng)
    assert not torch.equal(lacc.z, acc.z)
    px, py = _table_xy(add)
    # the sentinel is recognised by its stored limbs: it stays (0, 0)
    ident = (py.amax(dim=0, keepdim=True) == 0)
    lpx, lpy = torch.where(ident, px, ladd.x), torch.where(ident, py, ladd.y)
    sg, vd = lanes["sg"], lanes["vd"]
    calls = {
        "double": lambda a, b, bx, by: tgf.double_lf(a),
        "add": lambda a, b, bx, by: tgf.add_lf(a, b),
        "add_sel": lambda a, b, bx, by: tgf.add_sel_lf(a, bx, by, sg, vd),
        "add_sel_proj": lambda a, b, bx, by: tgf.add_sel_proj_lf(a, b, sg, vd),
    }
    want = _norm(calls[fn](acc, add, px, py))
    got = _norm(calls[fn](lacc, ladd, lpx, lpy))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_identity_with_z_stored_as_p_is_the_identity():
    """z = 0 may arrive as the limbs of p: the complete law needs no case."""
    pt = G1.mul(99, GEN)
    p_limbs = limbs.to_tensor(limbs.ints_to_limbs([Q], L).T, "cpu")
    one = limbs.to_tensor(limbs.ints_to_limbs([ONE], L).T, "cpu")
    ident = tgf.G1LF(p_limbs, one, p_limbs)
    P = tgf.encode_lf([pt], device="cpu")
    sg, vd = torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    assert tgf.decode_lf(tgf.add_lf(ident, P)) == [pt]
    assert tgf.decode_lf(tgf.add_lf(P, ident)) == [pt]
    assert tgf.decode_lf(tgf.add_lf(ident, ident)) == [None]
    assert tgf.decode_lf(tgf.double_lf(ident)) == [None]
    assert tgf.decode_lf(tgf.add_sel_proj_lf(P, ident, sg, vd)) == [pt]
    assert tgf.decode_lf(tgf.add_sel_lf(ident, P.x, P.y, sg, vd)) == [pt]


def test_converters_match_jax():
    rng = random.Random(13)
    pts = [G1.mul(rng.randrange(1, 1000), GEN) for _ in range(5)] + [None]
    t, j = tgf.encode_lf(pts, device="cpu"), jgf.encode_lf(pts)
    for a, b in zip(t, j):
        assert a.shape == (L, 6) and a.dtype == torch.int32
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    assert tgf.decode_lf(t) == pts == jgf.decode_lf(j)
    ti, ji = tgf.identity_lf(3, device="cpu"), jgf.identity_lf(3)
    for a, b in zip(ti, ji):
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    assert t.n == 6
    back = tgf.from_points(tgf.to_points(t))
    assert all(torch.equal(a, b) for a, b in zip(back, t))
    cond = torch.tensor([1, 0, 1, 0, 1, 0]).bool()
    sel = tgf.select_lf(cond, t, tgf.identity_lf(6, device="cpu"))
    assert tgf.decode_lf(sel) == [p if c else None for p, c in zip(pts, cond.tolist())]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CPU the wrappers take the plain versions; the checks that
    guard a launch are exercised directly."""
    p = tgf.identity_lf(8, device="cpu")
    before = dict(tgf.LAUNCHES)
    tgf.add_lf(p, p)
    tgf.normalize_lf(p)
    assert tgf.LAUNCHES == before          # CPU tensors: no launch is counted
    with pytest.raises(ValueError, match="CUDA"):
        tgf._run("g1_add", tuple(p) + tuple(p))
    with pytest.raises(ValueError, match="int32"):
        tgf._run("g1_double", (p.x.to(torch.int64), p.y, p.z))
    with pytest.raises(ValueError, match="int32"):
        tgf._run("g1_double", (p.x[:23].contiguous(), p.y, p.z))
    with pytest.raises(RuntimeError, match="launch failed"):
        tgf._launched("g1_add", 9)
    assert tgf.LAUNCHES == before
    tgf.LAUNCHES["g1_add"] += 2
    tgf.reset_launches()
    assert set(tgf.LAUNCHES.values()) == {0}
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is present: device=None runs on it")
        tgf.identity_lf(4)


# -- (e) the CUDA source: launchers, formulas ------------------------------------

POINTERS = {"g1_double": 6, "g1_add": 9, "g1_add_sel": 10, "g1_add_sel_proj": 11,
            "g1_normalize": 6}
SPREAD = ("g1_add", "g1_add_sel", "g1_add_sel_proj")


@pytest.mark.parametrize("name", sorted(POINTERS))
def test_cuda_launcher_signature_matches_its_binding(name):
    """Each launcher takes the device pointers its wrapper passes, then the
    lane count and the stream, and `_build.py` declares exactly that."""
    csrc = pathlib.Path(_build.CSRC_DIR)
    src = (csrc / "g1_fused.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"_launch\((.*?)\)", src, re.S).group(1)
    args = [a.strip() for a in sig.replace("\n", " ").split(",")]
    assert args[-2:] == ["int M", "void* stream"]
    assert all(re.fullmatch(r"(const )?int\* \w+", a) for a in args[:-2]), args
    assert len(args) - 2 == POINTERS[name]
    outs = [a for a in args[:-2] if not a.startswith("const")]
    assert [a.split()[-1] for a in outs] == ["ox", "oy", "oz"]
    build = pathlib.Path(_build.__file__).read_text()
    k = POINTERS[name]
    assert f"lib.{name}_launch.argtypes = [P] * {k} + [I, P]" in build
    assert name in tgf.LAUNCHES
    # the doubling and the three adders spread a lane over several threads
    # (G1S_*, the doubling with roles of its own); g1_normalize runs one
    # thread a lane
    if name == "g1_double":
        bounds, grid = "G1S_DBL_THREADS, G1S_DBL_MIN_BLOCKS", "g1s_blocks(M), G1S_DBL_THREADS"
    elif name in SPREAD:
        bounds, grid = "G1S_THREADS, G1S_MIN_BLOCKS", "g1s_blocks(M), G1S_THREADS"
    else:
        bounds, grid = "G1_THREADS", "g1_blocks(M), G1_THREADS"
    assert f"__launch_bounds__({bounds})\n{name}_kernel(" in src
    assert f"{name}_kernel<<<{grid}, 0, (cudaStream_t)stream>>>(" in src


def test_cuda_formulas_have_the_products_of_their_algorithms():
    src = (pathlib.Path(_build.CSRC_DIR) / "g1_fused.cu").read_text()

    def body(fn):
        return re.search(r"void " + fn + r"\((?:.*?)\) \{(.*?)\n\}", src, re.S).group(1)

    # Alg. 9 (g1_double), Alg. 7 (g1_add, g1_add_sel_proj) and Alg. 8
    # (g1_add_sel) on the role split: a product of each level is one row of
    # its operand table, the sums between the levels are derive jobs
    def rows(table):
        return len(re.findall(r"\{-?\d+(?:, -?\d+)+\}", re.search(
            r"int8_t " + table + r"\[\d+\]\[\d+\] = \{(.*?)\};", src, re.S).group(1)))

    for l1, l2, derive, products, mul3s in (
            ("G1S_DBL_L1", "G1S_DBL_L2", "g1s_dbl_derive", 8, 2),
            ("G1S_ADD_L1", "G1S_L2", "g1s_add_derive", 12, 3),
            ("G1S_MADD_L1", "G1S_L2", "g1s_madd_derive", 11, 2)):
        assert rows(l1) + rows(l2) == products, l1
        assert body(derive).count("fq_mul3(") == mul3s, derive
        assert "fq_mul(" not in body(derive)
    spread = re.search(r"void g1s_body\((?:.*?)\) \{(.*?)\n\}", src, re.S).group(1)
    assert spread.count("fq_mul_ptx(") == 2 and "fq_mul(" not in spread
    assert spread.count("__syncthreads()") == 3
    # every source that includes the field header keeps its own constants
    hdr = (pathlib.Path(_build.CSRC_DIR) / "fq.cuh").read_text()
    assert len(re.findall(r"^static __constant__ u?int32_t FQ_", hdr, re.M)) == 5
    assert not re.findall(r"^__constant__", hdr, re.M)


# -- (b) the limbs-last law of curves/g1.py against aleo_tpu.curves.g1 ----------------


def _rand_points(rng, n):
    return [G1.mul(rng.randrange(1, R), GEN) for _ in range(n)]


def _same_points(t, j):
    for a, b in zip(t, j):
        assert a.shape == tuple(b.shape)
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


def test_g1_add_matches_jax_and_oracle():
    rng = random.Random(200)
    n = 8
    pa = _rand_points(rng, n - 3) + [None, None, None]
    pb = _rand_points(rng, n - 4) + [pa[4], None, None, None]
    pb[0], pb[1] = pa[0], G1.neg(pa[1])                 # doubling, inverse pair
    ta, tb = tg1.encode_points(pa, device="cpu"), tg1.encode_points(pb, device="cpu")
    got = tg1.add(ta, tb)
    _same_points(got, jax.jit(jg1.add)(jg1.encode_points(pa), jg1.encode_points(pb)))
    assert tg1.decode_points(got) == [G1.add(p, q) for p, q in zip(pa, pb)]
    assert got.batch_shape == (n,)


def test_g1_double_neg_select_identity_match_jax():
    rng = random.Random(202)
    pts = _rand_points(rng, 4) + [None]
    t, j = tg1.encode_points(pts, device="cpu"), jg1.encode_points(pts)
    got = tg1.double(t)
    _same_points(got, jax.jit(jg1.double)(j))
    assert tg1.decode_points(got) == [G1.double(p) for p in pts]
    _same_points(tg1.neg(got), jg1.neg(jax.jit(jg1.double)(j)))
    assert tg1.decode_points(tg1.neg(t)) == [G1.neg(p) if p else None for p in pts]
    cond = np.asarray([1, 0, 0, 1, 1], dtype=bool)
    _same_points(tg1.select(torch.from_numpy(cond), t, got),
                 jg1.select(jnp.asarray(cond), j, jax.jit(jg1.double)(j)))
    _same_points(tg1.identity((3,), device="cpu"), jg1.identity((3,)))
    _same_points(tg1.identity(device="cpu"), jg1.identity())
    assert tg1.is_identity(t).tolist() == np.asarray(jg1.is_identity(j)).tolist()
    assert tg1.is_identity(tg1.identity((), device="cpu")).item() is True


def test_g1_scale_matches_jax_and_oracle():
    rng = random.Random(203)
    pts = _rand_points(rng, 2)
    k = rng.randrange(1, 1 << 32)
    bits = tg1.scalar_bits(k, 32)
    assert bits == np.asarray(jg1.scalar_bits(k, 32)).tolist()
    assert len(tg1.scalar_bits(5)) == R.bit_length()
    got = tg1.scale(bits, tg1.encode_points(pts, device="cpu"))
    _same_points(got, jax.jit(jg1.scale)(jg1.scalar_bits(k, 32), jg1.encode_points(pts)))
    assert tg1.decode_points(got) == [G1.mul(k, p) for p in pts]


def test_g1_to_affine_matches_jax_and_oracle():
    rng = random.Random(204)
    pts = _rand_points(rng, 3) + [None]
    t, j = tg1.encode_points(pts, device="cpu"), jg1.encode_points(pts)
    ts, js = tg1.add(t, t), jax.jit(jg1.add)(j, j)          # non-trivial Z
    got = tg1.to_affine(ts)
    _same_points(got, jax.jit(jg1.to_affine)(js))
    assert tg1.decode_points(got) == [G1.double(p) for p in pts]
    one = limbs.ints_to_limbs([ONE], L)[0]
    assert np.array_equal(got.z[:3].numpy(), np.tile(one, (3, 1)))
    assert int(got.z[3].abs().max()) == 0 and np.array_equal(got.y[3].numpy(), one)
