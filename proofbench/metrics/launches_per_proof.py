"""CUDA kernel launches per proof: every kernel on the card in one step under
torch.profiler (the program's own kernels and PyTorch's), divided by the
proofs of the step."""


def read(ctx):
    kernels = ctx["trace"].kernels
    return len(kernels) / ctx["k"] if kernels else None
