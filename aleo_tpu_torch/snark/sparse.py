"""Static sparse matrix-vector products over Fr on the device.

Counterpart of the JAX package's `snark/sparse.py`: the limbs-first path,
and `spmv`, its limbs-last adapter. R1CS matrices are fixed per circuit, so
the indexer presorts the COO entries (by row for M z, by col for M^T u) and
the device side is a gather + segmented Hillis-Steele scan + scatter over Fr
scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import fr_lf as lf
from ..fields import limbs
from ..fields.limbs import STORE


class SparseTables(NamedTuple):
    """Device tables for one orientation (row- or col-sorted) of a matrix."""

    vals: torch.Tensor        # (m, L) Montgomery coefficients, sorted
    gather_idx: torch.Tensor  # (m,) int64 index into the input vector
    flags: torch.Tensor       # (m,) bool segment starts
    ends: torch.Tensor        # (m,) bool segment ends
    out_idx: torch.Tensor     # (m,) int64 output position (valid at ends)
    out_size: int


def build_tables(coo, key_of, gather_of, out_size: int, m_pad: int, device=None):
    """Host: COO entries -> SparseTables sorted by key_of(entry).

    coo: list of (row, col, val); key_of/gather_of: entry -> int.
    Padded entries have val=0 and gather/out index 0.
    """
    device = limbs.resolve_device(device)
    entries = sorted(coo, key=key_of)
    keys = [key_of(e) for e in entries] + [out_size] * (m_pad - len(entries))
    gidx = [gather_of(e) for e in entries] + [0] * (m_pad - len(entries))
    vals = [e[2] for e in entries] + [0] * (m_pad - len(entries))
    keys_np = np.asarray(keys, dtype=np.int64)
    flags = np.ones(m_pad, dtype=bool)
    flags[1:] = keys_np[1:] != keys_np[:-1]
    ends = np.ones(m_pad, dtype=bool)
    ends[:-1] = flags[1:]
    return SparseTables(
        vals=lf.encode(vals, device=device).T.contiguous(),
        gather_idx=torch.from_numpy(np.asarray(gidx, dtype=np.int64)).to(device),
        flags=torch.from_numpy(flags).to(device),
        ends=torch.from_numpy(ends).to(device),
        out_idx=torch.from_numpy(np.minimum(keys_np, out_size)).to(device),
        out_size=out_size,
    )


def _segscan_add_lf(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix sum over Fr, limbs-first (L, ..., m); the
    segments (flags, (m,)) are shared by every batch row."""
    m = vals.shape[-1]
    v, f = vals, flags
    o = 1
    while o < m:
        s = lf.add(v[..., o:], v[..., : m - o])
        tail = torch.where(f[o:], v[..., o:], s)
        v = torch.cat([v[..., :o], tail], dim=-1)
        f = torch.cat([f[:o], f[o:] | f[: m - o]])
        o *= 2
    return v


def spmv_lf(tables: SparseTables, x: torch.Tensor) -> torch.Tensor:
    """Limbs-first spmv: x (L, ..., n) lazy -> y (L, ..., out_size) lazy, with
    y[out_idx] = sum over the segment of vals * x[gather_idx]. Batch axes
    between limbs and lanes (k witnesses against one matrix) share the
    tables."""
    vals = tables.vals.T
    vals = vals.reshape((vals.shape[0],) + (1,) * (x.dim() - 2) + (vals.shape[1],))
    prod = lf.mul(vals, x[..., tables.gather_idx])
    seg = _segscan_add_lf(prod, tables.flags)
    size = tables.out_size
    idx = torch.where(tables.ends, tables.out_idx, size)
    out = torch.zeros(x.shape[:-1] + (size + 1,), dtype=STORE, device=x.device)
    # every non-end lane lands on the dummy lane `size`, which is dropped
    out[..., idx] = seg
    return out[..., :size].contiguous()


def spmv(tables: SparseTables, x: torch.Tensor) -> torch.Tensor:
    """Limbs-last spmv: x (n, L) -> y (out_size, L), canonical."""
    return lf.normalize(spmv_lf(tables, x.T)).T.contiguous()
