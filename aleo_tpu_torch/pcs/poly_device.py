"""Device polynomial algebra over Fr on limbs-last coefficient vectors (n, L).

Counterpart of the JAX package's `pcs/poly_device.py`. The port has one
polynomial algebra, the limbs-first functions of `pcs/poly_lf.py` (on
`fields/fr_lf.py`); each function here is an adapter over it, as
`fields/modring.py` adapts the limb arithmetic: the limb axis is moved to
the front, the limbs-first function runs, and its lazy (< 2r) output is
normalized and moved back, so values are canonical, bit for bit the
reference's. Tensors stay on the device of their operands.
"""

from __future__ import annotations

import torch

from ..fields import fr_lf as lf
from ..ntt import ntt as dntt
from . import poly_lf as pl_lf


def _lf(x: torch.Tensor) -> torch.Tensor:
    """(n, L) limbs-last -> (L, n) limbs-first, contiguous."""
    return x.T.contiguous()


def _ll(x_lf: torch.Tensor) -> torch.Tensor:
    """Lazy (L, ...) limbs-first -> canonical (..., L) limbs-last."""
    return lf.normalize(x_lf).movedim(0, -1).contiguous()


def tree_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field-add reduction along `axis` (x: (..., L) limbs); the axis is
    removed."""
    x_lf = torch.movedim(x, axis, -2).movedim(-1, 0)     # (L, ..., n)
    return _ll(lf.tree_sum(x_lf)[..., 0])


def powers(z: torch.Tensor, n: int) -> torch.Tensor:
    """[z^0, ..., z^(n-1)] as (n, L) Montgomery limbs; z: (L,)."""
    return _ll(lf.powers(z[:, None], n))


def eval_coeffs(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """p(z) for coeffs (n, L), z (L,) -> (L,)."""
    return _ll(pl_lf.eval_coeffs(_lf(coeffs), z[:, None])[:, 0])


def pad_to(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """(k, L) -> (n, L) zero-padded."""
    return pl_lf.pad_to(_lf(coeffs), n).T.contiguous()


def poly_mul(a: torch.Tensor, b: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """Product of two coefficient vectors via NTT on a 2x domain."""
    need = a.shape[0] + b.shape[0] - 1
    n = 1 << max(1, (need - 1).bit_length())
    fa = dntt.ntt_lf(pl_lf.pad_to(_lf(a), n))
    fb = dntt.ntt_lf(pl_lf.pad_to(_lf(b), n))
    return _ll(dntt.intt_lf(lf.mul(fa, fb))[:, : out_len or need])


def divide_by_vanishing(a: torch.Tensor, n: int):
    """Divide by v_H(X) = X^n - 1. Returns (quotient (len-n, L) or (0, L),
    remainder (n, L))."""
    q, r = pl_lf.divide_by_vanishing(_lf(a), n)
    return _ll(q), _ll(r)


def divide_by_linear_via_domain(coeffs: torch.Tensor, z: torch.Tensor):
    """(q, y) with p(X) - y = q(X)(X - z), y = p(z); coeffs (n, L), z (L,).
    Computed on an evaluation domain; requires z outside it (overwhelming
    probability for random z)."""
    q, y = pl_lf.divide_by_linear_via_domain(_lf(coeffs), z[:, None])
    return _ll(q), _ll(y[:, 0])
