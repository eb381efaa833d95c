"""Entry points of the port over its flagship workload.

Counterpart of the JAX package's root entry-point file (`__graft_entry__.py`).

`entry(device=None)` returns `(step, args)`: `step` is a plain function on
tensors with the compute shape of one AHP round of the Varuna prover at
n = 256 (iNTT, coset NTT to 2n, elementwise square, one Pippenger MSM; see
`snark/prover.py`), and `args` its inputs on the device.

`dryrun_multichip(n)` runs one batch-proving step on a (dp, field) mesh over
the n ranks of the process group (`parallel.mesh`), with the shardings of
the reference's dry run:
  dp    — independent instances,
  field — the polynomial domain and the MSM's point range: a 4-step NTT
          whose local batched transforms are forced onto MatNTT, with one
          all-to-all, and the MSM partials reduced by the butterfly of
          group-law adds,
then an all-gather over dp of every instance's evaluations. It checks the
MSM and one instance's NTT against the host oracles and raises on a
mismatch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import params
from .curves import g1
from .curves.g1 import G1Points
from .fields import fr_lf
from .fields import limbs
from .fields.modring import FR_RING as F, ints_to_limbs
from .msm import msm as msm_mod
from .ntt import ntt as dntt
from .parallel import mesh as pmesh
from .pcs import poly_device as pd
from .reference import polynomial as rpoly
from .reference.curve import G1

R = params.R


def _gen_points(n):
    """n host affine points: small multiples of the BLS12-377 generator."""
    base = G1.generator()
    pts, cur = [], base
    for _ in range(min(n, 64)):
        pts.append(cur)
        cur = G1.add(cur, base)
    reps = -(-n // len(pts))
    return (pts * reps)[:n]


def _random_fr(rng, n):
    return [int(x) % R for x in rng.integers(1, 2**63, size=n)]


def _scalars(ints, device) -> torch.Tensor:
    return limbs.to_tensor(ints_to_limbs(ints, F.L), device)


def entry(device=None):
    """(step, args): one AHP round's compute shape at n = 256 and its inputs
    (the reference's, from the same seed) on `device` (None: CUDA)."""
    device = limbs.resolve_device(device)
    n = 256
    rng = np.random.default_rng(0xA1E0)
    z_evals = F.encode(_random_fr(rng, n), device=device)
    scalars = _scalars(_random_fr(rng, n), device)
    pts = g1.encode_points(_gen_points(n), device=device)
    shift = params.FR_GENERATOR

    def step(z_evals, scalars, px, py, pz):
        # interpolate the witness, lift it to a 2n coset, square there
        # (rowcheck-style elementwise work), and commit (one MSM)
        z_poly = dntt.intt(z_evals)
        z_coset = dntt.coset_ntt(pd.pad_to(z_poly, 2 * n), shift)
        h = fr_lf.normalize(fr_lf.sq(z_coset.T)).T
        acc = msm_mod.msm(scalars, G1Points(px, py, pz), c=4, device=px.device)
        return h, acc.x, acc.y, acc.z

    return step, (z_evals, scalars, pts.x, pts.y, pts.z)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded batch-proving step over the process group's n_devices
    ranks (`parallel.mesh.init_distributed` first), checked against the host
    oracles on every rank."""
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs inside a process group of "
            f"{n_devices} ranks (parallel.mesh.init_distributed)")
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    fshards = n_devices // dp
    mesh = pmesh.make_mesh(dp=dp, field=fshards, device=device)
    dev = torch.device(mesh.device_type)
    di, fi = mesh.get_local_rank("dp"), mesh.get_local_rank("field")
    fgroup = mesh.get_group("field")

    # every shard holds several rows and columns, and the all-to-all moves
    # blocks of several rows
    n1 = max(8 * fshards, 8)
    n2 = max(4 * fshards, 4)
    n = n1 * n2
    batch = 2 * dp
    npts = 32 * fshards
    bloc, n2loc, nploc = batch // dp, n2 // fshards, npts // fshards

    rng = np.random.default_rng(7)
    xs_ints = _random_fr(rng, batch * n)
    sc_ints = _random_fr(rng, npts)
    host_pts = _gen_points(npts)

    # dp over instances, field over the columns of each n1 x n2 instance
    cols = slice(fi * n2loc, (fi + 1) * n2loc)
    xs = F.encode(xs_ints[di * bloc * n:(di + 1) * bloc * n], device=dev)
    x16 = xs.reshape(bloc, n1, n2, F.L)[:, :, cols].permute(0, 3, 1, 2)
    tw = limbs.to_tensor(pmesh._mid_twiddles_np(n1, n2)[:, :, cols], dev)
    evals = pmesh._four_step(x16, tw, fgroup, impl="matntt")   # (B', 16, n1/f, n2)

    # field-sharded MSM: a local partial, then the butterfly
    mine = slice(fi * nploc, (fi + 1) * nploc)
    pts = g1.encode_points(host_pts[mine], device=dev)
    part = msm_mod.msm(_scalars(sc_ints[mine], dev), pts, c=4, device=dev)
    acc = pmesh._butterfly_sum(part, fgroup)

    # dp collective: every instance's evaluations (this rank's rows)
    full = pmesh._all_gather(evals, mesh.get_group("dp"))
    full = full.reshape((batch,) + tuple(evals.shape[1:]))   # (batch, 16, n1/f, n2)

    got = g1.decode_points(acc)[0]
    expect = None
    for s, p in zip(sc_ints, host_pts):
        expect = G1.add(expect, G1.mul(s, p))
    if got != expect:
        raise AssertionError(f"sharded MSM mismatch: {got} != {expect}")

    # instance 0 against the host NTT: its rows from every field rank;
    # rows[:, i, k] = X_0[k*n1 + i]
    rows = pmesh._all_gather(full[0], fgroup).transpose(0, 1).reshape(F.L, n1, n2)
    got_ntt = [int(v) for v in F.decode(rows.transpose(1, 2).reshape(F.L, n).T)]
    if got_ntt != rpoly.ntt(xs_ints[:n]):
        raise AssertionError("sharded NTT mismatch")
