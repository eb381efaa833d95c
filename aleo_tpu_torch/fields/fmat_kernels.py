"""The three hand-written kernels of the MatNTT reduction, and their wrappers.

Counterpart of the JAX package's `fields/fmat_pallas.py` (its Pallas TPU
kernels `_build_reduce_2d`, `_build_2d`, `_build_3d` behind `mont_reduce8`
and `carry8`). The kernels are CUDA C++ in `csrc/fmat.cu`:

  fmat_reduce   <- mont_reduce8   (76, M) int32 -> (38, M) int8: the whole
                   R7-Montgomery reduction, three carries and both band
                   products, in one launch
  fmat_carry2d  <- carry8, 2-D    (K, M) int32 -> (K, M) int8 along axis 0
  fmat_carry3d  <- carry8, 3-D    (B, K, T) int32 -> int8 along axis 1

Beside each wrapper stands its plain PyTorch version (`_reduce_plain`,
`_carry_plain`), which the wrapper takes only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises. `LAUNCHES` counts
the launches of each kernel.

The kernels carry sequentially (one thread owns a column), the plain
versions with peel rounds and a Kogge-Stone pass as the reference does. Both
leave the base-128 digits of the column's value mod 128^K, which are unique,
so they agree exactly on every input inside the carry's contract: column
sums below 2^26 for 4 peels, below 2^20 for 3.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from . import fmat

L7, K7 = fmat.L7, fmat.K7

LAUNCHES = {"fmat_reduce": 0, "fmat_carry2d": 0, "fmat_carry3d": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _carry_plain(cols: torch.Tensor, peels: int, axis: int) -> torch.Tensor:
    return fmat.carry_cols(cols, peels, axis).to(torch.int8)


def _reduce_plain(t_cols: torch.Tensor) -> torch.Tensor:
    """(K7, M) int32 raw convolution columns -> (L7, M) int8 reduced limbs:
    m = t * N' mod R7, u = (t + m * p) / R7, with t, m and u carried to 7-bit
    limbs. The band products run in float32, where they are exact (sums
    <= 38 * 127^2 < 2^24); torch has no integer matrix product on the GPU."""
    Wnp, Wp = fmat._reduce_mats_dev(str(t_cols.device))
    t_lo = _carry_plain(t_cols[:L7], 4, 0)     # the low digits need no more
    m = _carry_plain(fmat._band_dot(Wnp, t_lo, 0), 3, 0)
    u_cols = fmat._band_dot(Wp, m, 0) + t_cols
    return _carry_plain(u_cols, 4, 0)[L7:].contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, t, shape_ok):
    if t.dtype != torch.int32 or not shape_ok:
        raise ValueError(f"{name}: unexpected {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"{name}: expected a contiguous tensor that is not empty")
    if t.numel() >= 1 << 31:
        raise ValueError(f"{name}: {t.numel()} elements do not fit the kernel's int index")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def _stream():
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _reduce_consts() -> np.ndarray:
    """The 38 limbs of N' and the 38 of p, int32, as the kernel's argument
    (it receives them by value, in its constant bank). Cached, so the buffer
    the launcher reads stays alive."""
    Wnp, Wp = fmat._reduce_mats()
    # column 0 of a Toeplitz band is the constant's limbs
    return np.ascontiguousarray(
        np.concatenate([Wnp[:, 0], Wp[:L7, 0]]).astype(np.int32)
    )


def mont_reduce8(t_cols: torch.Tensor) -> torch.Tensor:
    """Fused `fmat.mont_reduce_cols` for the 2-D limb-leading layout:
    (K7, M) int32 -> (L7, M) int8, values < 1.1p."""
    if not t_cols.is_cuda:
        return _reduce_plain(t_cols)
    _check("mont_reduce8", t_cols, t_cols.dim() == 2 and t_cols.shape[0] == K7)
    M = t_cols.shape[1]
    out = torch.empty((L7, M), dtype=torch.int8, device=t_cols.device)
    consts = _reduce_consts()
    rc = _build.library().fmat_reduce_launch(
        t_cols.data_ptr(), out.data_ptr(), M,
        consts.ctypes.data_as(ctypes.c_void_p), _stream(),
    )
    _launched("fmat_reduce", rc)
    return out


def carry8(cols: torch.Tensor, peels: int, axis: int) -> torch.Tensor:
    """Carry-to-int8 along `axis`, in the two layouts fmat uses: 2-D with
    axis=0 and 3-D with axis=1. `peels` is the plain version's number of
    magnitude-reduction rounds; the kernels carry sequentially and have no
    use for it (see the module docstring)."""
    if not cols.is_cuda:
        return _carry_plain(cols, peels, axis)
    lib = _build.library()
    if cols.dim() == 2 and axis == 0:
        _check("carry8", cols, True)
        K, M = cols.shape
        out = torch.empty((K, M), dtype=torch.int8, device=cols.device)
        rc = lib.fmat_carry2d_launch(cols.data_ptr(), out.data_ptr(), K, M, _stream())
        _launched("fmat_carry2d", rc)
        return out
    if cols.dim() == 3 and axis == 1:
        _check("carry8", cols, True)
        B, K, T = cols.shape
        out = torch.empty((B, K, T), dtype=torch.int8, device=cols.device)
        rc = lib.fmat_carry3d_launch(cols.data_ptr(), out.data_ptr(), B, K, T, _stream())
        _launched("fmat_carry3d", rc)
        return out
    raise ValueError(
        f"carry8: no kernel for {cols.dim()}-D columns along axis {axis} "
        "(2-D along 0 and 3-D along 1 are the layouts fmat uses)"
    )
