"""The five batch-affine kernels' share of their roofline, in %: over one
step under torch.profiler, the sum of each launch's least time (the larger of
its bytes over HBM bandwidth and its multiply-adds over the int32 rate, at
the launch's lanes; `proofbench/roofline.py`) over the sum of their device
times."""

from proofbench import roofline


def read(ctx):
    tr = ctx["trace"]
    device_s = sum(s for name, s in tr.kernel_seconds().items()
                   if name.removesuffix("_kernel") in roofline.KERNELS)
    if not device_s:
        return None
    least = sum(roofline.least_seconds(k, m) for k, lanes in tr.lanes.items() for m in lanes)
    return 100.0 * least / device_s
