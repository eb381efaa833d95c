"""Batched Poseidon permutation and sponge over Fr on the device.

Counterpart of the JAX package's `hash/poseidon.py`, with the parameters of
the port's host oracle `reference/poseidon.py` (see that module for their
provenance against snarkVM's `hash_psd2/4/8`,
`upstream:rust/src/account/encryptor.rs:47,66`). State and inputs are
limbs-last (..., t, L) Montgomery tensors on `FR_RING`
(`fields/modring.py`). A round is ARK, the x^17 S-box (4 squarings and a
product) on every lane of a full round and on lane 0 of a partial one, and
the MDS product new_i = sum_j mds[i, j] * s_j as one broadcast product and
t - 1 additions. The rounds are a host loop: the full/partial schedule is
fixed, so the loop carries no data-dependent branch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import limbs
from ..fields.modring import FR_RING as F
from ..reference import poseidon as ref

ALPHA = ref.ALPHA


class DeviceParams:
    """Round constants and MDS matrix of one rate, as Montgomery limbs on
    the host (numpy) with copies per device."""

    def __init__(self, rate: int):
        p = ref.PoseidonParams.standard(rate)
        self.rate = rate
        self.t = p.t
        self.full = p.full_rounds
        self.partial = p.partial_rounds
        n_rounds = p.full_rounds + p.partial_rounds
        self.ark = np.stack([F.to_mont_host(row) for row in p.ark])  # (rounds, t, L)
        self.mds = np.stack([F.to_mont_host(row) for row in p.mds])  # (t, t, L)
        half = p.full_rounds // 2
        self.full_flag = np.asarray(
            [1 if (r < half or r >= half + p.partial_rounds) else 0 for r in range(n_rounds)],
            dtype=np.uint32,
        )
        self._dev = {}

    def tensors(self, device):
        """(ark, mds) on `device`, made once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (limbs.to_tensor(self.ark, device),
                              limbs.to_tensor(self.mds, device))
        return self._dev[key]


@functools.lru_cache(maxsize=None)
def device_params(rate: int) -> DeviceParams:
    return DeviceParams(rate)


def _x17(x):
    y = F.sq(F.sq(F.sq(F.sq(x))))  # x^16
    return F.mul(y, x)


def permute(state: torch.Tensor, rate: int) -> torch.Tensor:
    """Poseidon permutation; state (..., t, L) Montgomery limbs."""
    dp = device_params(rate)
    ark, mds = dp.tensors(state.device)
    s = state
    for r, full in enumerate(dp.full_flag):
        s = F.add(s, ark[r])
        if full:
            s = _x17(s)
        else:
            s = torch.cat([_x17(s[..., :1, :]), s[..., 1:, :]], dim=-2)
        prod = F.mul(mds, s[..., None, :, :])  # (..., t, t, L): mds[i, j] * s_j
        acc = prod[..., 0, :]
        for j in range(1, dp.t):
            acc = F.add(acc, prod[..., j, :])
        s = acc
    return s


def hash_batch(rate: int, inputs: torch.Tensor, domain: str = "AleoPoseidon") -> torch.Tensor:
    """Batched fixed-length hash: inputs (B, k, L) -> (B, L).

    Matches reference.poseidon.hash_psd(rate, row, domain) per batch row:
    snarkVM's hash_many convention, a zero state into whose rate section the
    preimage [domain, len, in_0, ...] is absorbed.
    """
    dp = device_params(rate)
    b, k, L = inputs.shape
    dev = inputs.device
    dom = F.const(ref.domain_fe(f"{domain}{rate}"), device=dev)
    length = F.const(k, device=dev)
    state = torch.zeros((b, dp.t, L), dtype=inputs.dtype, device=dev)
    elems = torch.cat([dom.expand(b, 1, L), length.expand(b, 1, L), inputs], dim=1)
    pos = 0
    for i in range(elems.shape[1]):
        if pos == rate:
            state = permute(state, rate)
            pos = 0
        lane = F.add(state[:, 1 + pos : 2 + pos], elems[:, i : i + 1])
        state = torch.cat([state[:, : 1 + pos], lane, state[:, 2 + pos :]], dim=1)
        pos += 1
    return permute(state, rate)[:, 1, :]
