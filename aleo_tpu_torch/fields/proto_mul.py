"""Montgomery products as single kernels: Fq with a canonical result, a
chain of twelve dependent Fq products, and the Fr product.

Counterpart of the three Pallas kernels of the JAX package's stand-alone
tools (`tools/proto_pallas_mul.py` `make_mul` and `make_mul12`,
`tools/microbench_fr_mul.py`'s fused Fr product). Operands and results are
limbs-first (L, N) int32 tensors of 16-bit Montgomery limbs (Fq: L = 24,
radix 2^384; Fr: L = 16, radix 2^256).

  fq_mul_canon(a, b)    a*b*R^-1 mod q, canonical (< q); a, b < 2q
  fq_mul_chain12(a, b)  six rounds of x2 = x*y, y = y*x, x = x2 from
                        x, y = a, b (lazy in between), x canonical at the end
  fr_mul(a, b)          a*b*R^-1 over Fr, lazy: the integer (ab + m r)/R with
                        m = ab N' mod R, not reduced further. Operands up to
                        4r - 1; < 2r in gives < 2r out.

Each is a CUDA kernel (csrc/proto_mul.cu) behind a wrapper here. A wrapper
given CUDA tensors launches its kernel or raises; given CPU tensors it takes
the plain PyTorch version beside it (`fq_mul_canon_plain`,
`fq_mul_chain12_plain`, `fr_mul_plain`, built on `fields.limb_kernels`),
which is also what the kernels are held against on the card. Every launch
adds one to `LAUNCHES[name]`.

`fr_mul` is the port's one Fr kernel. The prover's Fr arithmetic
(`fields/fr_lf.py`) does not call it: it stays plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import _build
from . import limb_kernels as lk
from .limbs import STORE, WORK

# kernel launches since the counts were last set to 0 (one per launch, and
# nowhere else)
LAUNCHES = {"fq_mul_canon": 0, "fq_mul_chain12": 0, "fr_mul": 0}

CHAIN_ROUNDS = 6            # two products a round: twelve in the chain


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _plain(ring: lk.LimbRing, fn, a, b):
    """Run `fn(consts, a, b)` of `limb_kernels`' int64 internals on STORE
    operands of shape (L, N)."""
    c = ring.consts(a.device)
    return fn(c, a.to(WORK), b.to(WORK)).to(STORE)


def fq_mul_canon_plain(a, b):
    return _plain(lk.get_fq(), lambda c, x, y: lk._cond_sub_p(c, lk._mont_mul(c, x, y)), a, b)


def fq_mul_chain12_plain(a, b):
    def chain(c, x, y):
        for _ in range(CHAIN_ROUNDS):
            x, y = lk._mont_mul(c, x, y), lk._mont_mul(c, y, x)
        return lk._cond_sub_p(c, x)

    return _plain(lk.get_fq(), chain, a, b)


def fr_mul_plain(a, b):
    return _plain(lk.get_fr(), lk._mont_mul, a, b)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _run(name, ring: lk.LimbRing, plain, a, b):
    if a.dim() != 2 or a.shape != b.shape or a.shape[0] != ring.L:
        raise ValueError(
            f"{name}: expected two ({ring.L}, N) tensors, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if not a.is_cuda and not b.is_cuda:
        return plain(a, b)
    m = a.shape[1]
    for nm, t in (("a", a), ("b", b)):
        if t.dtype != STORE or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"{name} {nm}: expected a contiguous int32 CUDA tensor, got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    out = torch.empty((ring.L, m), dtype=STORE, device=a.device)
    launch = getattr(_build.library(), name + "_launch")
    rc = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def fq_mul_canon(a, b):
    """Fq Montgomery product with a canonical (< q) result; a, b: (24, N)."""
    return _run("fq_mul_canon", lk.get_fq(), fq_mul_canon_plain, a, b)


def fq_mul_chain12(a, b):
    """Twelve dependent Fq products in one launch; a, b: (24, N)."""
    return _run("fq_mul_chain12", lk.get_fq(), fq_mul_chain12_plain, a, b)


def fr_mul(a, b):
    """Fr Montgomery product, lazy result; a, b: (16, N), values < 4r."""
    return _run("fr_mul", lk.get_fr(), fr_mul_plain, a, b)
