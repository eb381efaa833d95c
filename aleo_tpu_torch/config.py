"""Configuration of the port (env-var overridable defaults).

  ALEO_TORCH_NETWORK     network id                    (testnet3)
  ALEO_TORCH_ENDPOINT    node REST endpoint            (empty: the
                         in-process dev ledger)
  ALEO_TORCH_DEVNET_PATH pickled dev-ledger path       (~/.aleo_tpu_torch/
                         devnet.pkl)
  ALEO_TORCH_SERVER_HOST dev server bind host          (0.0.0.0)
  ALEO_TORCH_SERVER_PORT dev server port               (4040)
  ALEO_TORCH_SRS_DIR     SRS cache directory           (~/.aleo_tpu_torch/srs)
  ALEO_TORCH_KEY_DIR     function-key cache directory  (~/.aleo_tpu_torch/keys)
  ALEO_TORCH_PROFILE     enable the stage timers       (0)
  ALEO_TORCH_MATNTT_MIN  smallest power-of-two transform that runs as MatNTT
                         (int8 matrix products, ntt/matntt.py); smaller ones
                         run the butterfly network of ntt/ntt.py   (16384)
  ALEO_TORCH_FUSED_REDUCE  1: MatNTT's Montgomery reduction is one kernel
                         (fmat_reduce); 0: the chain of carry kernels and
                         band products it fuses                    (1)
  ALEO_TORCH_MSM_AFFINE  1: the variable-base MSM accumulates in affine
                         form with shared batch inversions
                         (curves/g1_affine.py); 0: the inversion-free
                         projective pipeline (curves/g1_fused.py)     (1)
  ALEO_TORCH_FIXED_BASE  KZG commits through the fixed-base MSM
                         (msm/fixed_base.py, precomputed per-window tables
                         of the SRS): 1 always, auto for commits of
                         fixed_base.FIXED_BASE_MIN_N points or more, 0 (or
                         false) never; the twin of the JAX package's
                         switch, kept for comparison, not a tuning knob (0)

The port has two NTT paths, chosen by size alone, two variable-base MSM
paths, chosen by ALEO_TORCH_MSM_AFFINE, and the fixed-base MSM beside them,
chosen by ALEO_TORCH_FIXED_BASE and the commit's size (no test of the
device: a commit runs on whichever device the SRS lies on).
"""

from __future__ import annotations

import os


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


NETWORK = _env("ALEO_TORCH_NETWORK", "testnet3")
ENDPOINT = _env("ALEO_TORCH_ENDPOINT", "")        # "" = in-process dev ledger
DEVNET_PATH = os.path.expanduser(
    _env("ALEO_TORCH_DEVNET_PATH", "~/.aleo_tpu_torch/devnet.pkl")
)
SERVER_HOST = _env("ALEO_TORCH_SERVER_HOST", "0.0.0.0")
SERVER_PORT = int(_env("ALEO_TORCH_SERVER_PORT", "4040"))
SRS_DIR = os.path.expanduser(_env("ALEO_TORCH_SRS_DIR", "~/.aleo_tpu_torch/srs"))
KEY_DIR = os.path.expanduser(_env("ALEO_TORCH_KEY_DIR", "~/.aleo_tpu_torch/keys"))

# MatNTT threshold: power-of-two transforms with n >= this run as int8 matrix
# products plus one fused reduction per stage; the twin of the JAX package's
# MATNTT_MIN_N, with its default.
MATNTT_MIN_N = int(_env("ALEO_TORCH_MATNTT_MIN", str(1 << 14)))

# Fuse each MatNTT reduction chain (carry -> N' product -> carry -> p product
# + add -> carry) into one kernel launch. 0 runs the unfused chain.
FUSED_REDUCE = _env("ALEO_TORCH_FUSED_REDUCE", "1") not in ("0", "false")

# MSM accumulation mode, the twin of the JAX package's MSM_AFFINE_MODE with
# the choice it makes on its accelerator as the default. "0" (or "false")
# takes the projective pipeline. Read at call time (msm._use_affine).
MSM_AFFINE_MODE = _env("ALEO_TORCH_MSM_AFFINE", "1")

# Fixed-base commits, the twin of the JAX package's FIXED_BASE_MODE with its
# default (off: that package keeps the path off after a failing commit group
# on its accelerator). "1" always, "auto" for commits of
# >= fixed_base.FIXED_BASE_MIN_N points, "0" (or "false") never. Read at call
# time (kzg._use_fixed_base).
FIXED_BASE_MODE = _env("ALEO_TORCH_FIXED_BASE", "0")
