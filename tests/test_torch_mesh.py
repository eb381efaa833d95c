"""The port's multi-device layer (`aleo_tpu_torch.parallel.mesh`) over gloo
ranks on the CPU, against the JAX package's (`aleo_tpu.parallel.mesh`) on
the virtual CPU mesh of the same shard count and against the host oracles.
Tolerance 0: equal field values, equal affine points.

Ranks are processes started by `torch.multiprocessing` (spawn) and joined
in one gloo group through a file under the test's `tmp_path`: no TCP port,
so test workers cannot collide. Each rank's group times out after 120 s and
the whole run after RANKS_TIMEOUT_S, so a hang fails instead of eating the
suite's limit. The functions the ranks run live at the top level of their
test file, which imports only torch and the port at the top: the ranks
never import JAX, and the JAX side runs in the parent.

This file: two ranks as (dp, field) = (1, 2), four as (2, 2), against the
JAX functions at two shards; `_mid_twiddles_np` and `_batch_ntt_lf` (both
implementations) against theirs. tests/test_torch_mesh_four.py holds four
ranks as (1, 4). The JAX `sharded_msm` compiles for several minutes on the
CPU, so the sharded MSM is held against the JAX package's host oracle
(`aleo_tpu.reference.msm.msm_naive`, plain Python, run in this process on
inputs drawn with the JAX package's `G1`), and the port's own oracle must
agree with it.
"""

import os
import pickle
import random
import time
import uuid

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from aleo_tpu_torch import config, params
from aleo_tpu_torch.curves import g1
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.fields.modring import FR_RING as F, ints_to_limbs
from aleo_tpu_torch.parallel import mesh as tmesh
from aleo_tpu_torch.reference import polynomial as rpoly
from aleo_tpu_torch.reference.curve import G1
from aleo_tpu_torch.reference.msm import msm_naive

R = params.R
RANKS_TIMEOUT_S = 240
N1, N2 = 16, 32
N_POINTS = 32
IMPLS = ("vpu", "matntt")


# -- running ranks ---------------------------------------------------------------


def _rank_main(rank, world, init_file, out_dir, worker, args):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout=120)
    try:
        result = worker(rank, *args)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


class Ranks:
    """worker(rank, *args) running in `world` gloo ranks; `results()` waits
    for them and returns each rank's result, in rank order. A rank's
    exception fails the run with its traceback."""

    def __init__(self, tmp_path, world, worker, *args):
        self.world = world
        self.dir = tmp_path / f"ranks-{world}-{uuid.uuid4().hex[:8]}"
        self.dir.mkdir()
        self.deadline = time.monotonic() + RANKS_TIMEOUT_S
        self.ctx = mp.start_processes(
            _rank_main, args=(world, str(self.dir / "init"), str(self.dir), worker, args),
            nprocs=world, join=False, start_method="spawn")

    def results(self):
        while not self.ctx.join(timeout=max(1.0, self.deadline - time.monotonic())):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                pytest.fail(f"{self.world} ranks did not finish within {RANKS_TIMEOUT_S} s")
        out = []
        for rank in range(self.world):
            with open(self.dir / f"rank{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def run_ranks(tmp_path, world, worker, *args):
    return Ranks(tmp_path, world, worker, *args).results()


# -- the ranks' work ------------------------------------------------------------------


def ntt_input():
    rng = random.Random(700)
    return [rng.randrange(R) for _ in range(N1 * N2)]


def msm_input():
    """The inputs of tests/test_parallel.py's sharded MSM test."""
    rng = random.Random(701)
    G = G1.generator()
    pts = [G1.mul(rng.randrange(1, 5000), G) for _ in range(N_POINTS)]
    scalars = [rng.randrange(R) for _ in range(N_POINTS)]
    return scalars, pts


def mesh_worker(rank, dp):
    """sharded_ntt in each implementation and sharded_msm on a (dp, *) mesh
    -> host values."""
    mesh = tmesh.make_mesh(dp, device="cpu")
    a = ntt_input()
    ntts = {impl: [int(v) for v in F.decode(tmesh.sharded_ntt(mesh, F.encode(a, device="cpu"),
                                                             N1, N2, impl=impl))]
            for impl in IMPLS}
    scalars, pts = msm_input()
    sc = torch.from_numpy(ints_to_limbs(scalars, F.L).astype(np.int32))
    point = tmesh.sharded_msm(mesh, sc, g1.encode_points(pts, device="cpu"))
    uneven = None
    if mesh["field"].size() > 1:
        try:
            tmesh.sharded_msm(mesh, sc[:-1], g1.encode_points(pts[:-1], device="cpu"))
            uneven = "accepted"
        except AssertionError:
            uneven = "refused"
    return {"coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("field")),
            "ntt": ntts, "msm": g1.decode_points(point)[0], "uneven": uneven}


# -- the JAX side, in this process -------------------------------------------------------


def jax_sharded_ntt(shards):
    import jax

    from aleo_tpu.fields.modring import FR_RING as JF
    from aleo_tpu.parallel import mesh as jmesh

    m = jmesh.make_mesh(dp=1, field=shards, devices=jax.devices()[:shards])
    return [int(v) for v in JF.decode(jmesh.sharded_ntt(m, JF.encode(ntt_input()), N1, N2))]


def jax_msm_naive():
    """The JAX package's host oracle on msm_input()'s draws, made with the
    JAX package's curve."""
    from aleo_tpu.reference.curve import G1 as JG1
    from aleo_tpu.reference.msm import msm_naive as jax_naive

    rng = random.Random(701)
    G = JG1.generator()
    pts = [JG1.mul(rng.randrange(1, 5000), G) for _ in range(N_POINTS)]
    scalars = [rng.randrange(R) for _ in range(N_POINTS)]
    return jax_naive(scalars, pts)


def check_mesh_results(results, dp, jax_ntt):
    world = len(results)
    field = world // dp
    assert [r["coords"] for r in results] == [(r // field, r % field) for r in range(world)]
    want_ntt = rpoly.ntt(ntt_input())
    assert jax_ntt == want_ntt
    want_msm = jax_msm_naive()
    assert want_msm is not None
    assert msm_naive(*msm_input()) == want_msm
    for r in results:
        for impl in IMPLS:
            assert r["ntt"][impl] == want_ntt, impl
        assert r["msm"] == want_msm
        assert r["uneven"] == ("refused" if field > 1 else None)


# -- tests ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ntt_two():
    return jax_sharded_ntt(2)


@pytest.mark.parametrize("world,dp", [(2, 1), (4, 2)], ids=["1x2", "2x2"])
def test_sharded_ntt_and_msm_match_jax_and_host(tmp_path, world, dp, jax_ntt_two):
    check_mesh_results(run_ranks(tmp_path, world, mesh_worker, dp), dp, jax_ntt_two)


@pytest.mark.parametrize("n1,n2", [(N1, N2), (8, 4)])
def test_mid_twiddles_match_jax(n1, n2):
    from aleo_tpu.parallel import mesh as jmesh

    got = tmesh._mid_twiddles_np(n1, n2)
    assert got.shape == (16, n1, n2)
    assert np.array_equal(got.astype(np.int64), np.asarray(jmesh._mid_twiddles_np(n1, n2)).astype(np.int64))


@pytest.mark.parametrize("impl", ["vpu", "matntt"])
def test_batch_ntt_lf_matches_jax(impl):
    """Three transforms of 16 lanes; values after normalize (the butterfly
    networks return different lazy representatives)."""
    import jax.numpy as jnp

    from aleo_tpu.fields import fr_lf as jlf
    from aleo_tpu.parallel import mesh as jmesh

    rng = random.Random(3)
    x = torch.stack([tlf.encode([rng.randrange(R) for _ in range(16)], device="cpu")
                     for _ in range(3)])
    got = tmesh._batch_ntt_lf(x, impl)
    want = jmesh._batch_ntt_lf(jnp.asarray(x.numpy().astype(np.uint32)), impl)
    assert got.shape == (3, 16, 16)
    for b in range(3):
        assert np.array_equal(tlf.normalize(got[b]).numpy().astype(np.int64),
                              np.asarray(jlf.normalize(want[b])).astype(np.int64))


def test_matntt_batch_rule(monkeypatch):
    """The reference's rule without its test of the backend: a power of two
    of at least 256 lanes, and the batch's lanes past MATNTT_MIN_N."""
    monkeypatch.setattr(config, "MATNTT_MIN_N", 1 << 14)
    assert tmesh._matntt_batch_ok(256, 64)
    assert not tmesh._matntt_batch_ok(256, 63)
    assert not tmesh._matntt_batch_ok(128, 1024)
    assert not tmesh._matntt_batch_ok(384, 1024)
    assert tmesh._matntt_batch_ok(1 << 14, 1)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError):
        tmesh.make_mesh(1, device="cpu")
