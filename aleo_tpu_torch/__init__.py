"""aleo_tpu_torch: the PyTorch/CUDA port of the aleo_tpu proving framework.

Same layer map and module names as the JAX package (params -> reference
(host oracle) -> fields -> curves -> ntt/msm -> pcs -> snark -> program), so
each module's counterpart is found by name. Device code is plain PyTorch on
tensors plus hand-written CUDA kernels under `csrc/` (built at first use by
`_build.py`). Nothing here imports `jax` or the JAX package.

Device rule: every entry point that creates tensors takes `device=None`,
which means `torch.device("cuda")` and raises when CUDA is absent; callers
that want the CPU (the tests) say `device="cpu"`.
"""

__version__ = "0.1.0"

from . import params  # noqa: F401
