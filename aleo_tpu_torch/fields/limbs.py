"""Limb representation of the port: dtype policy, devices, host conversions.

A field batch is an (L, N) tensor of 16-bit limbs, little-endian along axis
0 (Fq: L = 24, Fr: L = 16), the same limbs-first layout as the JAX package,
so state carried across is a dtype cast.

  * STORE (int32): what public functions take and return and what lies in
    device memory. torch's uint32 lacks most CPU ops; limbs are < 2^16, so
    the sign bit is never used.
  * WORK (int64): inside the plain arithmetic, where column sums of 16x16-bit
    products pass 2^32.

CUDA kernels read STORE tensors and pack limb pairs into 32-bit words in
registers; the Montgomery radix (2^(16 L)) is the same either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

STORE = torch.int32
WORK = torch.int64


def resolve_device(device=None) -> torch.device:
    """device=None means the GPU, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "aleo_tpu_torch runs on a CUDA device; none is available "
                "(pass device='cpu' explicitly to run the plain versions)"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Host limb array (any integer dtype) -> STORE tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    return ints_to_limbs([x], n_limbs)[0]


def ints_to_limbs(xs: Sequence[int], n_limbs: int) -> np.ndarray:
    """List of ints -> (N, L) int32, limbs last (transpose for limbs-first)."""
    nbytes = n_limbs * 2
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return (
        np.frombuffer(buf, dtype="<u2").reshape(len(xs), n_limbs).astype(np.int32)
    )


def limbs_to_ints(a) -> list:
    """(N, L) limbs-last host array -> list of python ints."""
    a = np.ascontiguousarray(np.asarray(a).astype("<u2"))
    nbytes = a.shape[-1] * 2
    buf = a.tobytes()
    return [
        int.from_bytes(buf[i : i + nbytes], "little")
        for i in range(0, len(buf), nbytes)
    ]


def to_mont_host(xs: Sequence[int], p: int, n_limbs: int) -> np.ndarray:
    """Host ints -> (N, L) Montgomery limbs (radix 2^(16 L))."""
    r_mod = (1 << (LIMB_BITS * n_limbs)) % p
    return ints_to_limbs([(x % p) * r_mod % p for x in xs], n_limbs)


def from_mont_host(a, p: int) -> list:
    """(N, L) canonical Montgomery limbs -> list of python ints."""
    a = np.asarray(a)
    rinv = pow((1 << (LIMB_BITS * a.shape[-1])) % p, -1, p)
    return [v * rinv % p for v in limbs_to_ints(a)]
