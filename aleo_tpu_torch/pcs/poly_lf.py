"""Limbs-first device polynomial algebra over Fr ((L, n) coefficient tensors).

Counterpart of the JAX package's `pcs/poly_lf.py`, built on `fields.fr_lf`.
All operations are O(n log n)-work, log-depth tensor code: no sequential
coefficient recurrences. Every function also takes batch axes between the
limb axis and the coefficient axis ((L, k, n): k polynomials of k proofs,
the layout of `fields.fr_lf`), and works on each batch row on its own.
"""

from __future__ import annotations

import functools

import torch

from .. import params
from ..fields import fr_lf as lf
from ..ntt import ntt as dntt

L = lf.L


def pad_to(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """(L, ..., k) -> (L, ..., n) zero-padded on the lane axis."""
    k = coeffs.shape[-1]
    assert k <= n
    if k == n:
        return coeffs
    pad = torch.zeros(coeffs.shape[:-1] + (n - k,), dtype=coeffs.dtype, device=coeffs.device)
    return torch.cat([coeffs, pad], dim=-1)


def eval_coeffs(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """p(z) for coeffs (L, ..., n), z (L, ..., 1) -> (L, ..., 1)."""
    pw = lf.powers(z, coeffs.shape[-1])
    return lf.tree_sum(lf.mul(coeffs, pw))


def _tree_reduce_axis1(x: torch.Tensor) -> torch.Tensor:
    """Field-add reduction of (L, ..., k, n) over the axis before the lanes
    -> (L, ..., n). k is a (usually small) stack height; log-depth halving."""
    k = x.shape[-2]
    while k > 1:
        half = k // 2
        s = lf.add(x[..., :half, :], x[..., half : 2 * half, :])
        if k % 2:
            s = torch.cat([s, x[..., -1:, :]], dim=-2)
        x = s
        k = s.shape[-2]
    return x[..., 0, :]


def fold_stack(stack: torch.Tensor, gpows: torch.Tensor) -> torch.Tensor:
    """sum_i gpows[..., i] * stack[..., i, :]: (L, ..., k, n), (L, ..., k)
    -> (L, ..., n)."""
    return _tree_reduce_axis1(lf.mul(stack, gpows[..., None]))


def divide_by_vanishing(a: torch.Tensor, n: int):
    """Divide (L, ..., m) by v_H(X) = X^n - 1 using X^{jn} = 1 (mod v_H).
    Returns (quotient (L, ..., m-n) or (L, ..., 0), remainder (L, ..., n))."""
    m = a.shape[-1]
    lead = a.shape[:-1]
    if m <= n:
        return torch.zeros(lead + (0,), dtype=a.dtype, device=a.device), pad_to(a, n)
    k = -(-m // n)
    chunks = pad_to(a, k * n).reshape(lead + (k, n))
    rem = chunks[..., 0, :]
    for j in range(1, k):
        rem = lf.add(rem, chunks[..., j, :])
    suffix = [None] * k
    acc = chunks[..., k - 1, :]
    suffix[k - 1] = acc
    for j in range(k - 2, 0, -1):
        acc = lf.add(acc, chunks[..., j, :])
        suffix[j] = acc
    quo = torch.cat(suffix[1:], dim=-1)[..., : m - n]
    return quo, rem


def divide_by_linear_via_domain(coeffs: torch.Tensor, z: torch.Tensor):
    """(q, y) with p(X) - y = q(X)(X - z), y = p(z); coeffs (L, ..., n),
    z (L, ..., 1).

    Computed on an evaluation domain: q(x_i) = (p(x_i) - y) / (x_i - z) for
    x_i in a size-n subgroup H (exact since deg q < n); requires z outside H
    (overwhelming probability for a transcript z).
    """
    n = coeffs.shape[-1]
    npow2 = 1 << max(1, (n - 1).bit_length())
    c = pad_to(coeffs, npow2)
    y = eval_coeffs(coeffs, z)
    evals = dntt.ntt_lf(c)
    xs = dntt.domain(npow2).wpow_lf(coeffs.device)          # (L, n)
    q = dntt.intt_lf(_linear_quotient_evals(evals, xs, z, y))
    return q[..., : max(1, n - 1)], y


def _linear_quotient_evals(evals, xs, z, y):
    """(evals - y) / (xs - z) on the domain points xs (L, n); evals
    (L, ..., n), z and y (L, ..., 1)."""
    xs = xs.reshape((xs.shape[0],) + (1,) * (evals.dim() - 2) + (xs.shape[1],))
    dinv = lf.batch_inv(lf.sub(xs, z))
    return lf.mul(lf.sub(evals, y), dinv)


@functools.lru_cache(maxsize=None)
def _coset_vh_inv(n_domain: int, n_vanish: int, shift: int, device) -> torch.Tensor:
    """1 / v(x) for v(X) = X^n_vanish - 1 on the coset shift * H_{n_domain},
    limbs-first (L, n_domain) on `device`, cached per device.

    v(shift * w^i) = shift^nv * (w^nv)^i - 1 has period n_domain / n_vanish
    in i, so only one period is inverted (on host integers) and tiled.
    """
    R = params.R
    assert n_domain % n_vanish == 0
    period = n_domain // n_vanish
    x_pow = pow(shift, n_vanish, R)
    w_pow = pow(dntt.domain(n_domain).w, n_vanish, R)
    invs, acc = [], x_pow
    for _ in range(period):
        invs.append(pow((acc - 1) % R, -1, R))
        acc = acc * w_pow % R
    return lf.encode(invs, device=device).repeat(1, n_vanish)
