"""The three Montgomery-product functions of `aleo_tpu_torch.fields.proto_mul`
against the JAX package's stand-alone tools, tolerance 0.

  (a) `fq_mul_canon`, `fq_mul_chain12` against the kernel bodies of
      `tools/proto_pallas_mul.py` (`_mont_mul_tile`, `_cond_sub_p`, run as
      plain jnp: the script is loaded by path) and against
      `aleo_tpu.fields.modring.FQ_RING.mul`, the script's own reference;
  (b) `fr_mul` against `aleo_tpu.fields.limb_kernels.mont_mul` on the raw
      lazy limbs (operands up to 4r - 1) and against `FR_RING.mul`;
  (c) Python integers; wrapper checks; the CUDA source's constants and
      launcher signatures; the two tool scripts on the CPU.
"""

import importlib.util
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields import limb_kernels as jlk
from aleo_tpu.fields.modring import FQ_RING, FR_RING
from aleo_tpu_torch import _build
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.fields import proto_mul as pm

ROOT = pathlib.Path(__file__).resolve().parent.parent
Q, R = params.Q, params.R
N = 256


@pytest.fixture(scope="module")
def proto():
    """tools/proto_pallas_mul.py as a module (it has no interpret switch; its
    kernel bodies are plain jnp functions)."""
    spec = importlib.util.spec_from_file_location(
        "proto_pallas_mul", ROOT / "tools" / "proto_pallas_mul.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fq_operands(seed, n=N, bound=2 * Q):
    """(24, n) limb arrays of values < bound with the edge values planted."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % bound for _ in range(2 * n)]
    edge = [0, 1, Q - 1, Q % bound, bound - 1]
    a, b = vals[:n], vals[n:]
    for i, u in enumerate(edge):
        for j, v in enumerate(edge):
            a[i * len(edge) + j], b[i * len(edge) + j] = u, v
    return a, b


def _arr(vals, L):
    return limbs.ints_to_limbs(vals, L).T.copy()          # (L, n) int32


def _t(vals, L):
    return limbs.to_tensor(_arr(vals, L), "cpu")


def _same(t, j):
    assert t.shape == tuple(j.shape)
    assert np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


# -- (a) Fq: canonical product and the chain -------------------------------------


def test_fq_mul_canon_matches_the_pallas_kernel_body(proto):
    a, b = _fq_operands(1)
    pL = jnp.asarray(np.broadcast_to(proto.P_NP[:, None], (24, N)).copy())
    npL = jnp.asarray(np.broadcast_to(proto.NP_NP[:, None], (24, N)).copy())
    body = jax.jit(lambda x, y: proto._cond_sub_p(proto._mont_mul_tile(x, y, pL, npL), pL))
    want = body(jnp.asarray(_arr(a, 24).astype(np.uint32)), jnp.asarray(_arr(b, 24).astype(np.uint32)))
    _same(pm.fq_mul_canon(_t(a, 24), _t(b, 24)), want)


def test_fq_mul_canon_matches_modring_and_integers():
    a, b = _fq_operands(2, bound=Q)             # FQ_RING.mul takes canonical operands
    got = pm.fq_mul_canon(_t(a, 24), _t(b, 24))
    want = jax.jit(FQ_RING.mul)(jnp.asarray(_arr(a, 24).T.astype(np.uint32)),
                                jnp.asarray(_arr(b, 24).T.astype(np.uint32)))
    _same(got.T, want)
    r_inv = pow(1 << 384, -1, Q)
    assert limbs.limbs_to_ints(got.numpy().T) == [x * y * r_inv % Q for x, y in zip(a, b)]


def test_fq_mul_chain12_matches_the_pallas_kernel_body(proto):
    a, b = _fq_operands(3)
    pL = jnp.asarray(np.broadcast_to(proto.P_NP[:, None], (24, N)).copy())
    npL = jnp.asarray(np.broadcast_to(proto.NP_NP[:, None], (24, N)).copy())

    @jax.jit
    def body(x, y):
        for _ in range(6):
            x2 = proto._mont_mul_tile(x, y, pL, npL)
            y = proto._mont_mul_tile(y, x, pL, npL)
            x = x2
        return proto._cond_sub_p(x, pL)

    want = body(jnp.asarray(_arr(a, 24).astype(np.uint32)), jnp.asarray(_arr(b, 24).astype(np.uint32)))
    _same(pm.fq_mul_chain12(_t(a, 24), _t(b, 24)), want)


def test_fq_mul_chain12_matches_integers():
    """Twelve products mod q on Python integers, the Montgomery factor
    tracked (no pow): the final x is canonical, so it is unique."""
    a, b = _fq_operands(4)
    r_inv = pow(1 << 384, -1, Q)
    x, y = a, b
    for _ in range(pm.CHAIN_ROUNDS):
        x, y = ([u * v * r_inv % Q for u, v in zip(x, y)],
                [v * u * r_inv % Q for u, v in zip(x, y)])
    got = pm.fq_mul_chain12(_t(a, 24), _t(b, 24))
    assert limbs.limbs_to_ints(got.numpy().T) == x
    assert max(x) < Q


# -- (b) Fr: the lazy product ----------------------------------------------------


def _fr_operands(seed, n=N, bound=4 * R):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(2 * n)]
    edge = [0, 1, R - 1, R % bound, (2 * R - 1) % bound, bound - 1]
    a, b = vals[:n], vals[n:]
    for i, u in enumerate(edge):
        for j, v in enumerate(edge):
            a[i * len(edge) + j], b[i * len(edge) + j] = u, v
    return a, b


def _jax_fr_consts():
    ring = jlk.get_fr()
    return {k: jnp.asarray(v[:, None]) for k, v in ring.rows.items()}


@pytest.mark.parametrize("bound", [R, 2 * R, 4 * R], ids=["canonical", "lt_2r", "lt_4r"])
def test_fr_mul_raw_limbs_match_limb_kernels_mont_mul(bound):
    """Raw lazy limbs, no normalize: the same integer (ab + m r) / R."""
    a, b = _fr_operands(5, bound=bound)
    c = _jax_fr_consts()
    want = jax.jit(lambda x, y: jlk.mont_mul(c, x, y))(
        jnp.asarray(_arr(a, 16).astype(np.uint32)), jnp.asarray(_arr(b, 16).astype(np.uint32)))
    got = pm.fr_mul(_t(a, 16), _t(b, 16))
    _same(got, want)
    big = 1 << 256
    n_prime = (-pow(R, -1, big)) % big
    ints = [(x * y + (x * y * n_prime % big) * R) >> 256 for x, y in zip(a, b)]
    assert limbs.limbs_to_ints(got.numpy().T) == ints
    # the carry-out word never overflows: the result fits the 16 limbs
    assert max(ints) < (2 * R if bound <= 2 * R else 5 * R // 2)


def test_fr_mul_matches_modring_after_normalize():
    a, b = _fr_operands(6, bound=R)
    c = _jax_fr_consts()
    got = pm.fr_mul(_t(a, 16), _t(b, 16))
    norm = jax.jit(lambda x: jlk.normalize(c, x))(jnp.asarray(got.numpy().astype(np.uint32)))
    want = jax.jit(FR_RING.mul)(jnp.asarray(_arr(a, 16).T.astype(np.uint32)),
                                jnp.asarray(_arr(b, 16).T.astype(np.uint32)))
    assert np.array_equal(np.asarray(norm).T, np.asarray(want))
    from aleo_tpu_torch.fields import fr_lf

    assert torch.equal(fr_lf.normalize(got), fr_lf.normalize(fr_lf.mul(_t(a, 16), _t(b, 16))))


# -- (c) wrappers, source, scripts -------------------------------------------------


@pytest.mark.parametrize("name,L", [("fq_mul_canon", 24), ("fq_mul_chain12", 24), ("fr_mul", 16)])
def test_wrapper_takes_the_plain_version_only_on_cpu_tensors(name, L):
    fn = getattr(pm, name)
    good = torch.zeros((L, 4), dtype=torch.int32)
    before = dict(pm.LAUNCHES)
    out = fn(good, good)                   # CPU tensors: no launch is counted
    assert out.shape == (L, 4) and out.dtype == torch.int32
    assert pm.LAUNCHES == before
    with pytest.raises(ValueError):
        fn(good[:-1], good[:-1])           # wrong limb count
    with pytest.raises(ValueError):
        fn(good, good[:, :2])
    src = pathlib.Path(pm.__file__).read_text()
    assert "try:" not in src               # a CUDA tensor launches or raises
    assert f"lib.{name}_launch.argtypes = [P] * 3 + [I, P]" in pathlib.Path(_build.__file__).read_text()
    cu = (pathlib.Path(_build.CSRC_DIR) / "proto_mul.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"_launch\((.*?)\)", cu, re.S).group(1)
    assert [s.strip() for s in sig.split(",")] == [
        "const int* a", "const int* b", "int* out", "int M", "void* stream"]
    assert f"{name}_kernel<<<" in cu


def test_cuda_fr_constants_match_params():
    src = (pathlib.Path(_build.CSRC_DIR) / "fr.cuh").read_text()
    body = re.search(r"FR_P\[FR_WORDS\] = \{(.*?)\};", src, re.S).group(1)
    ws = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u", body)]
    assert len(ws) == 8 and sum(w << (32 * i) for i, w in enumerate(ws)) == R
    np0 = int(re.search(r"#define FR_NP0 (0x[0-9a-f]+)u", src).group(1), 16)
    assert np0 == (-pow(R, -1, 1 << 32)) % (1 << 32)
    assert not re.findall(r"^__constant__", src, re.M)
    # one product for both fields: the headers forward to the same template
    fq = (pathlib.Path(_build.CSRC_DIR) / "fq.cuh").read_text()
    assert "mw_mont_mul<FQ_WORDS>" in fq and "mw_mont_mul<FR_WORDS>" in src
    mont = (pathlib.Path(_build.CSRC_DIR) / "mont.cuh").read_text()
    assert mont.count("void mw_mont_mul(") == 1


@pytest.mark.parametrize("script,args", [
    ("torch_proto_mul.py", ["--log2n", "7"]),
    ("torch_microbench_fr_mul.py", ["8", "--iters", "2"]),
])
def test_tool_script_runs_on_the_cpu(script, args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), *args, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout and "Mmul/s" in proc.stdout


@pytest.mark.parametrize("script", ["torch_proto_mul.py", "torch_microbench_fr_mul.py"])
def test_tool_script_raises_without_cuda(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script runs on it")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / script), "6"] if "fr" in script
        else [sys.executable, str(ROOT / "tools" / script), "--log2n", "6"],
        cwd=ROOT, capture_output=True, text=True,
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr
