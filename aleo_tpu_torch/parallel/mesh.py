"""Device-mesh parallelism for the proving stack, on `torch.distributed`.

Counterpart of the JAX package's `parallel/mesh.py`. A 2-D `DeviceMesh`
over the ranks of the process group, with axes

  "dp"    — data parallel over independent proofs (batch proving,
            `snark.batch.prove_batch(mesh=...)`), and
  "field" — parallel inside one transform or MSM: the 4-step NTT exchanges
            its blocks with one all-to-all, and MSM partials are reduced by
            a recursive-doubling butterfly of group-law adds (points are not
            summable by an all-reduce; the adds are exact, so every rank ends
            with the same point, though possibly another projective
            representative of it).

Each rank is one process on one device. Where the reference's `shard_map`
functions take global arrays and shard them, the functions here take the
whole input on every rank, work on their rank's shard, and return the whole
result on every rank.

The process group's backend follows the device that was asked for: NCCL for
CUDA, gloo for the CPU (the tests spawn gloo ranks on the CPU). NCCL takes
one rank to a card, so on one card the mesh is (1, 1): the butterfly runs no
step and the all-to-all moves one block.
"""

from __future__ import annotations

import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import config, params
from ..curves import g1
from ..curves.g1 import G1Points
from ..fields import fr_lf as lf
from ..fields import limbs
from ..fields.modring import FR_RING as F
from ..msm import msm as msm_mod
from ..ntt import matntt
from ..ntt import ntt as dntt

L = F.L


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout: float | None = None) -> None:
    """Join the process group: NCCL on CUDA (`device=None` means CUDA and
    raises without it), gloo on the CPU. `coordinator` is the init method
    (`tcp://host:port` or `file:///path`). Nothing happens on one process
    unless a coordinator asks for a group. On CUDA the rank takes card
    `process_id` modulo the cards of its host. `timeout` in seconds bounds
    each collective (the backend's default when None)."""
    dev = limbs.resolve_device(device)
    if coordinator is None and (num_processes or 1) <= 1:
        return
    if dev.type == "cuda":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=coordinator,
        world_size=num_processes or 1, rank=process_id or 0, **kw,
    )


def make_mesh(dp: int = 1, field: int | None = None, device=None) -> DeviceMesh:
    """The (dp, field) mesh over every rank of the process group, rank-major
    (rank r at (r // field, r % field))."""
    dev = limbs.resolve_device(device)
    world = dist.get_world_size()
    field = field or world // dp
    assert dp * field == world, "mesh shape must cover all ranks"
    return DeviceMesh(dev.type, torch.arange(world).reshape(dp, field),
                      mesh_dim_names=("dp", "field"))


# ---------------------------------------------------------------------------
# Sharded MSM: points and scalars split over the "field" axis; each rank runs
# the whole Pippenger pipeline on its slice, and the partials are reduced by
# a recursive-doubling butterfly (log2(S) steps, one projective point sent
# and one received by each rank a step).
# ---------------------------------------------------------------------------


def _butterfly_sum(p: G1Points, group) -> G1Points:
    """The sum of every rank's point over `group` (a power-of-two size), on
    every rank: at step d each rank adds its partner's (rank ^ d) point."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    d = 1
    while d < size:
        peer = dist.get_global_rank(group, rank ^ d)
        send = torch.stack([p.x, p.y, p.z]).contiguous()
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, group),
                                           dist.P2POp(dist.irecv, recv, peer, group)]):
            req.wait()
        p = g1.add(p, G1Points(recv[0], recv[1], recv[2]))
        d *= 2
    return p


def sharded_msm(mesh: DeviceMesh, scalars_raw: torch.Tensor, points: G1Points,
                c: int | None = None) -> G1Points:
    """MSM over points sharded along `field`; returns the sum (a projective
    point, batch shape ()) on every rank.

    scalars_raw: (n, 16) standard-form limbs, points: (n, 24) each, the whole
    input on every rank. n must be a multiple of the field axis, itself a
    power of two (the butterfly's pairing), as in the reference."""
    group = mesh.get_group("field")
    shards, rank = mesh["field"].size(), mesh.get_local_rank("field")
    n = scalars_raw.shape[0]
    assert shards & (shards - 1) == 0, "the field axis must be a power of two"
    assert n % shards == 0, "the points must divide over the field axis"
    n_shard = n // shards
    mine = slice(rank * n_shard, (rank + 1) * n_shard)
    c_eff = c if c is not None else msm_mod.auto_c(n_shard)
    part = msm_mod.msm(scalars_raw[mine], G1Points(*(a[mine] for a in points)), c=c_eff,
                       device=mesh.device_type)
    return _butterfly_sum(part, group)


# ---------------------------------------------------------------------------
# Sharded NTT (4-step): N = n1 * n2 viewed as an (n1, n2) matrix.
#   1) size-n1 NTTs along the columns (each rank holds n2/S of them),
#   2) twiddle by W_N^{i*j},
#   3) all-to-all transpose (each coefficient crosses the mesh once),
#   4) size-n2 NTTs along the rows (each rank then holds n1/S of them).
# ---------------------------------------------------------------------------


def _matntt_batch_ok(n: int, batch: int) -> bool:
    """MatNTT when the batch supplies the lanes one small transform lacks:
    batch * n past the single-transform threshold, a power-of-two length big
    enough to factorize. The reference adds a test of its backend; the port
    takes the same path on every device."""
    return n >= 256 and n & (n - 1) == 0 and batch * n >= config.MATNTT_MIN_N


def _batch_ntt_lf(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(B, 16, n) batched forward NTTs, lazy in and out.

    impl: "auto" (MatNTT where `_matntt_batch_ok`), "matntt" (forced), "vpu"
    (the butterfly network of `ntt/ntt.py`, the B rows side by side)."""
    B, _, n = x.shape
    if impl == "matntt" or (impl == "auto" and _matntt_batch_ok(n, B)):
        return matntt.ntt_batch_lf16(x)
    d = dntt.domain(n)
    rows = dntt._transform_lf(x.transpose(0, 1), d.wpow_lf(x.device), d.bitrev(x.device))
    return rows.transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=16)
def _mid_twiddles_np(n1: int, n2: int) -> np.ndarray:
    """(16, n1, n2) numpy Montgomery table of W_N^{i*j}."""
    R = params.R
    big = dntt.domain(n1 * n2)
    rows = []
    for i in range(n1):
        wi = pow(big.w, i, R)
        acc = 1
        for _ in range(n2):
            rows.append(acc)
            acc = acc * wi % R
    enc = F.to_mont_host(rows)                    # (n1*n2, 16)
    return np.ascontiguousarray(enc.reshape(n1, n2, L).transpose(2, 0, 1))


def _four_step(x16: torch.Tensor, tw: torch.Tensor, group, impl: str) -> torch.Tensor:
    """The 4-step transform of B instances on one rank of `group` (S ranks).

    x16: (B, 16, n1, n2/S), this rank's columns of each instance's (n1, n2)
    matrix; tw: (16, n1, n2/S), the same columns of `_mid_twiddles_np`.
    Returns (B, 16, n1/S, n2), canonical: this rank's rows r*n1/S + a of the
    evaluations, out[b, :, a, k] = X_b[k*n1 + r*n1/S + a]."""
    B, _, n1, n2_loc = x16.shape
    shards = dist.get_world_size(group)
    cols = x16.permute(0, 3, 1, 2).reshape(B * n2_loc, L, n1)
    cols = _batch_ntt_lf(cols, impl)                         # size-n1 NTTs
    x2 = lf.mul(tw[:, None], cols.reshape(B, n2_loc, L, n1).permute(2, 0, 3, 1))
    # (16, B, n1, n2/S): block s of the rows goes to rank s; the block from
    # rank s holds its columns s*n2/S.. of this rank's rows
    send = x2.reshape(L, B, shards, n1 // shards, n2_loc).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    rows = recv.permute(2, 3, 1, 0, 4).reshape(B * (n1 // shards), L, shards * n2_loc)
    rows = _batch_ntt_lf(rows, impl)                         # size-n2 NTTs
    out = lf.normalize(rows.transpose(0, 1))                 # (16, B*n1/S, n2)
    return out.reshape(L, B, n1 // shards, -1).transpose(0, 1)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, *t.shape): every rank's t in rank order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def sharded_ntt(mesh: DeviceMesh, x: torch.Tensor, n1: int, n2: int,
                impl: str = "auto") -> torch.Tensor:
    """NTT of length n1*n2 sharded over the `field` axis.

    x: (n1*n2, 16) natural order (row-major (i, j) -> i*n2 + j), Montgomery
    limbs, the whole input on every rank. Returns the evaluations in natural
    order, canonical, on every rank."""
    group = mesh.get_group("field")
    shards, rank = mesh["field"].size(), mesh.get_local_rank("field")
    assert n2 % shards == 0 and n1 % shards == 0
    dev = torch.device(mesh.device_type)
    n2_loc = n2 // shards
    mine = slice(rank * n2_loc, (rank + 1) * n2_loc)
    x16 = x.to(dev).T.reshape(L, n1, n2)[:, :, mine]
    tw = limbs.to_tensor(_mid_twiddles_np(n1, n2)[:, :, mine], dev)
    out = _four_step(x16[None], tw, group, impl)[0]          # (16, n1/S, n2)
    full = _all_gather(out, group).transpose(0, 1).reshape(L, n1, n2)
    # full[:, i, k] = X[k*n1 + i]
    return full.transpose(1, 2).reshape(L, n1 * n2).T.contiguous()
