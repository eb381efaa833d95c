"""Configuration of the port (env-var overridable defaults).

  ALEO_TORCH_SRS_DIR     SRS cache directory           (~/.aleo_tpu_torch/srs)
  ALEO_TORCH_KEY_DIR     function-key cache directory  (~/.aleo_tpu_torch/keys)
  ALEO_TORCH_PROFILE     enable the stage timers       (0)

The port has one path: butterfly NTT and variable-base batch-affine MSM.
"""

from __future__ import annotations

import os


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


SRS_DIR = os.path.expanduser(_env("ALEO_TORCH_SRS_DIR", "~/.aleo_tpu_torch/srs"))
KEY_DIR = os.path.expanduser(_env("ALEO_TORCH_KEY_DIR", "~/.aleo_tpu_torch/keys"))
