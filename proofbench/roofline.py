"""Peaks of one NVIDIA H100 (SXM, 700 W) and the bytes and operations of the
batch-affine MSM's five kernels, for their share of the roofline.

Peaks: HBM 3.35 TB/s (NVIDIA's data sheet). The kernels compute in 32-bit
integer multiply-adds, for which NVIDIA publishes no rate; the rate assumed is
half the published 67 TFLOP/s float32 rate, 16.75e12 multiply-adds a second,
since an SM has half as many int32 lanes as float32 lanes. A 32x32->64
multiply-accumulate counts two; one Montgomery product of Fq (12 words) is
two 12x12-word passes, 576 multiply-adds. An Fq element is stored as 24
int32 words of 16-bit limbs, 96 bytes; a flag row is 4 bytes a lane. Each
input byte counts once and each output byte once, at the lanes of the launch.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 16.75e12

ELEM = 4 * 24                    # bytes of one stored Fq element
FLAG = 4
PRODUCT = 2 * 2 * 12 * 12        # multiply-adds of one Fq Montgomery product
INV_TILE = 1024                  # lanes of one inversion tile
SAFEGCD = 37 * 2 * (4 + 6) * 13  # fq_fermat's safegcd: 37 batches over 13 limbs


def _tiles(m: int) -> int:
    return -(-m // INV_TILE)


# kernel -> lanes -> (bytes, multiply-adds)
KERNELS = {
    "fq_prepare": lambda m: ((6 * ELEM + 5 * FLAG) * m, PRODUCT * m),
    "fq_apply": lambda m: ((8 * ELEM + 4 * FLAG) * m, 3 * PRODUCT * m),
    "fq_inv_up": lambda m: (ELEM * (m + _tiles(m)), PRODUCT * (m - _tiles(m))),
    "fq_inv_down": lambda m: (ELEM * (2 * m + _tiles(m)), 3 * PRODUCT * (m - _tiles(m))),
    "fq_fermat": lambda m: (2 * ELEM * m, SAFEGCD * m),
}


def least_seconds(kernel: str, lanes: int) -> float:
    """The larger of bytes over HBM bandwidth and operations over the int32
    rate for one launch at `lanes` lanes."""
    nbytes, mads = KERNELS[kernel](lanes)
    return max(nbytes / HBM_BYTES_PER_S, mads / INT32_MADS_PER_S)
