// Projective G1 group-law kernels for Hopper (sm_90a).
//
// Five kernels, one thread per lane, every Fq value as 12 32-bit words in
// registers (fq.cuh). They replace the five Pallas kernels of the JAX
// package's curves/g1_fused.py:
//
//   g1_double        <- _build_double        (_double_body, RCB16 Alg. 9)
//   g1_add           <- _build_add           (_add_body,    RCB16 Alg. 7)
//   g1_add_sel       <- _build_add_sel       (_add_sel_body over _madd_body,
//                                             RCB16 Alg. 8, mixed)
//   g1_add_sel_proj  <- _build_add_sel_proj  (masked, signed Alg. 7)
//   g1_normalize     <- _build_normalize     (lk.normalize on x, y, z)
//
// The curve is y^2 = x^3 + 1 (a = 0, b3 = 3). The formulas are complete:
// doubling, inverse pairs and the identity (z = 0, as the limbs of 0 or of p)
// on either side go through the same arithmetic, so there is no case code.
// Values are lazy: operands <= 2p, results < 2p (fq_neg may give 2p).
//
// Each kernel computes what its TPU kernel computes, product for product in
// the same order, so a result equals the plain PyTorch version's
// (curves/g1_fused.py) limb for limb after normalize. Tile padding and
// constant blocks of the TPU kernels have no counterpart: the ragged edge is
// `if (m >= M) return`, constants live in __constant__ memory.
//
// Masked lanes. g1_add_sel and g1_add_sel_proj return the accumulator on a
// lane that is not valid (and g1_add_sel on a lane whose addend is the
// (0, 0) sentinel) by copying its 72 stored words as they are: bit for bit,
// not re-reduced. Such a lane leaves before any product, so a warp whose
// lanes are all masked costs its bytes only; late rounds of an MSM, where
// most segments are exhausted, are mostly such warps.
//
// Bounds. A lane of g1_add moves 9 x 24 words (864 B) and does 12 products
// of 2 x 144 32x32->64 multiply-adds: at the card's rates the multiply-adds
// take about 1.6 times as long as the bytes, so the three adders and the
// doubling are bound by operations; g1_normalize does no product and is
// bound by bytes. What the design does about it: nothing is written to
// memory between the products of one group operation, the inputs are read
// once, coalesced (limbs first), and the products are ordered so that the
// six input coordinates die as early as the formulas allow (x and y of both
// points after the fifth product of Alg. 7, everything after the sixth).
// Measured on an H100 the group operations take 5 to 6 times that bound:
// the carries of fq_mul form one dependent chain of 288 multiply-add steps,
// and the 12 warps an SM holds at this register count do not hide its
// latency (one warp alone needs 3.5 us for one product).
//
// Out of place only: an output must not alias an input (the pointers are
// __restrict__).
//
// Plain C interface (loaded with ctypes): every launcher takes device
// pointers to contiguous (24, M) int32 limb arrays (flags: (1, M) int32), the
// lane count and the CUDA stream; it launches on that stream, does not
// synchronise, and returns cudaGetLastError().
//
// Registers per thread (nvcc 12.8, -O3, sm_90a, -Xptxas -v): 168 for the four
// group operations (the cap below; spill stores of 20 bytes in g1_double, 52
// in g1_add, 28 in g1_add_sel, 172 in g1_add_sel_proj), 88 for g1_normalize
// (no spill). The build log of every run is printed by chip_smoke.py's device
// phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

// Threads a block, and the blocks an SM must be able to hold (which caps the
// registers a thread may use: 65536 / (G1_THREADS * G1_MIN_BLOCKS)).
// Left alone the compiler takes 188 to 242 registers for the four group
// operations and spills nothing, but then an SM holds 8 warps and the 1408
// warps of a 45056-lane launch need two waves. Three blocks an SM cap a
// thread at 168 registers: 20 to 172 bytes of spills, 12 warps an SM, one
// wave, and every kernel is faster (g1_double 1.8x, the adders 1.1 to 1.2x;
// four blocks, 128 registers, spill 200 to 860 bytes and are slower again).
// scripts/torch_g1_variants.py times these choices.
#ifndef G1_THREADS
#define G1_THREADS 128
#endif
#ifndef G1_MIN_BLOCKS
#define G1_MIN_BLOCKS 3
#endif

// ---------------------------------------------------------------------------
// the three formulas, on registers
// ---------------------------------------------------------------------------

// RCB16 Algorithm 7 (a = 0, b3 = 3): (x3, y3, z3) = (x1, y1, z1) + (x2, y2, z2).
// 12 products, 3 mul3. Outputs must not alias inputs.
__device__ __forceinline__ void g1_add_core(
    uint32_t x3[FQ_WORDS], uint32_t y3[FQ_WORDS], uint32_t z3[FQ_WORDS],
    const uint32_t x1[FQ_WORDS], const uint32_t y1[FQ_WORDS], const uint32_t z1[FQ_WORDS],
    const uint32_t x2[FQ_WORDS], const uint32_t y2[FQ_WORDS], const uint32_t z2[FQ_WORDS]) {
    uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS], t3[FQ_WORDS], t4[FQ_WORDS];
    uint32_t a[FQ_WORDS], b[FQ_WORDS];
    fq_mul(t0, x1, x2);
    fq_mul(t1, y1, y2);
    fq_add(a, x1, y1);
    fq_add(b, x2, y2);
    fq_mul(t3, a, b);
    fq_add(a, t0, t1);
    fq_sub(t3, t3, a);                          // t3 = (x1+y1)(x2+y2) - t0 - t1
    fq_mul(t2, z1, z2);
    fq_add(a, y1, z1);
    fq_add(b, y2, z2);
    fq_mul(t4, a, b);
    fq_add(a, t1, t2);
    fq_sub(t4, t4, a);                          // t4 = (y1+z1)(y2+z2) - t1 - t2
    fq_add(a, x1, z1);
    fq_add(b, x2, z2);
    fq_mul(y3, a, b);
    fq_add(a, t0, t2);
    fq_sub(y3, y3, a);                          // y3 = (x1+z1)(x2+z2) - t0 - t2
    fq_mul3(t0, t0);
    fq_mul3(t2, t2);                            // b3 * t2
    fq_add(z3, t1, t2);
    fq_sub(t1, t1, t2);
    fq_mul3(y3, y3);                            // b3 * y3
    fq_mul(a, t4, y3);
    fq_mul(b, t3, t1);
    fq_sub(x3, b, a);                           // x3 = t3 t1 - t4 y3
    fq_mul(a, y3, t0);
    fq_mul(b, t1, z3);
    fq_add(y3, b, a);                           // y3 = t1 z3 + y3 t0
    fq_mul(a, t0, t3);
    fq_mul(b, z3, t4);
    fq_add(z3, b, a);                           // z3 = z3 t4 + t0 t3
}

// RCB16 Algorithm 8 (a = 0, b3 = 3, Z2 = 1): (x1, y1, z1) + affine (x2, y2).
// 11 products, 2 mul3. Outputs must not alias inputs.
__device__ __forceinline__ void g1_madd_core(
    uint32_t x3[FQ_WORDS], uint32_t y3[FQ_WORDS], uint32_t z3[FQ_WORDS],
    const uint32_t x1[FQ_WORDS], const uint32_t y1[FQ_WORDS], const uint32_t z1[FQ_WORDS],
    const uint32_t x2[FQ_WORDS], const uint32_t y2[FQ_WORDS]) {
    uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS], t3[FQ_WORDS], t4[FQ_WORDS];
    uint32_t a[FQ_WORDS], b[FQ_WORDS];
    fq_mul(t0, x1, x2);
    fq_mul(t1, y1, y2);
    fq_add(a, x2, y2);
    fq_add(b, x1, y1);
    fq_mul(t3, a, b);
    fq_add(a, t0, t1);
    fq_sub(t3, t3, a);                          // t3 = (x2+y2)(x1+y1) - t0 - t1
    fq_mul(t4, y2, z1);
    fq_add(t4, t4, y1);                         // t4 = y2 z1 + y1
    fq_mul(y3, x2, z1);
    fq_add(y3, y3, x1);                         // y3 = x2 z1 + x1
    fq_add(a, t0, t0);
    fq_add(t0, a, t0);                          // t0 = 3 t0, by two additions
    fq_mul3(t2, z1);                            // b3 * z1
    fq_add(z3, t1, t2);
    fq_sub(t1, t1, t2);
    fq_mul3(y3, y3);                            // b3 * y3
    fq_mul(a, t4, y3);
    fq_mul(b, t3, t1);
    fq_sub(x3, b, a);                           // x3 = t3 t1 - t4 y3
    fq_mul(a, y3, t0);
    fq_mul(b, t1, z3);
    fq_add(y3, b, a);                           // y3 = t1 z3 + y3 t0
    fq_mul(a, t0, t3);
    fq_mul(b, z3, t4);
    fq_add(z3, b, a);                           // z3 = z3 t4 + t0 t3
}

// RCB16 Algorithm 9 (a = 0, b3 = 3): 2 (x, y, z). 8 products, 2 mul3.
// Outputs must not alias inputs.
__device__ __forceinline__ void g1_double_core(
    uint32_t x3[FQ_WORDS], uint32_t y3[FQ_WORDS], uint32_t z3[FQ_WORDS],
    const uint32_t x[FQ_WORDS], const uint32_t y[FQ_WORDS], const uint32_t z[FQ_WORDS]) {
    uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS], txy[FQ_WORDS];
    uint32_t a[FQ_WORDS], e[FQ_WORDS];
    fq_mul(t0, y, y);
    fq_mul(t1, y, z);
    fq_mul(t2, z, z);
    fq_mul(txy, x, y);
    fq_add(e, t0, t0);
    fq_add(e, e, e);
    fq_add(e, e, e);                            // e = 8 t0
    fq_mul3(t2, t2);                            // b3 z^2
    fq_add(y3, t0, t2);
    fq_mul3(a, t2);
    fq_sub(t0, t0, a);                          // t0 = y^2 - 3 b3 z^2
    fq_mul(a, t2, e);
    fq_mul(z3, t1, e);                          // z3 = 8 y^3 z
    fq_mul(y3, t0, y3);
    fq_add(y3, a, y3);                          // y3 = t2 e + t0 (y^2 + b3 z^2)
    fq_mul(a, t0, txy);
    fq_add(x3, a, a);                           // x3 = 2 t0 x y
}

// copy one lane of a coordinate, stored words as they are
__device__ __forceinline__ void lane_copy(int* __restrict__ dst, const int* __restrict__ src,
                                          long ld, long m) {
#pragma unroll
    for (int l = 0; l < FQ_LIMBS; l++) dst[(long)l * ld + m] = src[(long)l * ld + m];
}

// ---------------------------------------------------------------------------
// g1_double: (x, y, z) -> 2 (x, y, z).
// Bound: 6 x 24 words a lane (576 B) against 8 products: operations.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS, G1_MIN_BLOCKS)
g1_double_kernel(const int* __restrict__ xp, const int* __restrict__ yp,
                 const int* __restrict__ zp, int* __restrict__ oxp, int* __restrict__ oyp,
                 int* __restrict__ ozp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    uint32_t x[FQ_WORDS], y[FQ_WORDS], z[FQ_WORDS];
    uint32_t x3[FQ_WORDS], y3[FQ_WORDS], z3[FQ_WORDS];
    fq_load(x, xp, ld, m);
    fq_load(y, yp, ld, m);
    fq_load(z, zp, ld, m);
    g1_double_core(x3, y3, z3, x, y, z);
    fq_store(oxp, ld, m, x3);
    fq_store(oyp, ld, m, y3);
    fq_store(ozp, ld, m, z3);
}

// ---------------------------------------------------------------------------
// g1_add: (x1, y1, z1) + (x2, y2, z2), complete.
// Bound: 9 x 24 words a lane (864 B) against 12 products: operations.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS, G1_MIN_BLOCKS)
g1_add_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
              const int* __restrict__ z1p, const int* __restrict__ x2p,
              const int* __restrict__ y2p, const int* __restrict__ z2p,
              int* __restrict__ oxp, int* __restrict__ oyp, int* __restrict__ ozp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    uint32_t x1[FQ_WORDS], y1[FQ_WORDS], z1[FQ_WORDS];
    uint32_t x2[FQ_WORDS], y2[FQ_WORDS], z2[FQ_WORDS];
    uint32_t x3[FQ_WORDS], y3[FQ_WORDS], z3[FQ_WORDS];
    fq_load(x1, x1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_load(y1, y1p, ld, m);
    fq_load(y2, y2p, ld, m);
    fq_load(z1, z1p, ld, m);
    fq_load(z2, z2p, ld, m);
    g1_add_core(x3, y3, z3, x1, y1, z1, x2, y2, z2);
    fq_store(oxp, ld, m, x3);
    fq_store(oyp, ld, m, y3);
    fq_store(ozp, ld, m, z3);
}

// ---------------------------------------------------------------------------
// g1_add_sel: acc (+)= (sign ? -P : P) where valid, else acc; P affine.
// P == (0, 0) is the identity sentinel of the MSM's point table: it is
// recognised by the stored limbs of y2 being all zero (table rows are
// canonical), before the negation (-0 is stored as 2p), and masked like an
// invalid lane.
// Bound: 8 x 24 + 2 words a lane (776 B) against 11 products on the lanes
// that are kept: operations, unless nearly every lane is masked.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS, G1_MIN_BLOCKS)
g1_add_sel_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                  const int* __restrict__ z1p, const int* __restrict__ x2p,
                  const int* __restrict__ y2p, const int* __restrict__ signp,
                  const int* __restrict__ validp, int* __restrict__ oxp,
                  int* __restrict__ oyp, int* __restrict__ ozp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    uint32_t y2[FQ_WORDS];
    fq_load(y2, y2p, ld, m);
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) any |= y2[i];
    if (validp[m] == 0 || any == 0) {
        lane_copy(oxp, x1p, ld, m);
        lane_copy(oyp, y1p, ld, m);
        lane_copy(ozp, z1p, ld, m);
        return;
    }
    uint32_t x1[FQ_WORDS], y1[FQ_WORDS], z1[FQ_WORDS], x2[FQ_WORDS];
    uint32_t x3[FQ_WORDS], y3[FQ_WORDS], z3[FQ_WORDS];
    if (signp[m] != 0) {
        fq_neg(x3, y2);
        fq_copy(y2, x3);
    }
    fq_load(x1, x1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_load(y1, y1p, ld, m);
    fq_load(z1, z1p, ld, m);
    g1_madd_core(x3, y3, z3, x1, y1, z1, x2, y2);
    fq_store(oxp, ld, m, x3);
    fq_store(oyp, ld, m, y3);
    fq_store(ozp, ld, m, z3);
}

// ---------------------------------------------------------------------------
// g1_add_sel_proj: acc (+)= (sign ? -P : P) where valid, else acc; P
// projective (the merge of two bucket accumulators). No sentinel: an
// identity addend has z = 0 and the complete law takes it.
// Bound: 9 x 24 + 2 words a lane (872 B) against 12 products on the valid
// lanes: operations where most lanes are valid, bytes where few are.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS, G1_MIN_BLOCKS)
g1_add_sel_proj_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                       const int* __restrict__ z1p, const int* __restrict__ x2p,
                       const int* __restrict__ y2p, const int* __restrict__ z2p,
                       const int* __restrict__ signp, const int* __restrict__ validp,
                       int* __restrict__ oxp, int* __restrict__ oyp, int* __restrict__ ozp,
                       int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    if (validp[m] == 0) {
        lane_copy(oxp, x1p, ld, m);
        lane_copy(oyp, y1p, ld, m);
        lane_copy(ozp, z1p, ld, m);
        return;
    }
    uint32_t x1[FQ_WORDS], y1[FQ_WORDS], z1[FQ_WORDS];
    uint32_t x2[FQ_WORDS], y2[FQ_WORDS], z2[FQ_WORDS];
    uint32_t x3[FQ_WORDS], y3[FQ_WORDS], z3[FQ_WORDS];
    fq_load(y2, y2p, ld, m);
    if (signp[m] != 0) {
        fq_neg(x3, y2);
        fq_copy(y2, x3);
    }
    fq_load(x1, x1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_load(y1, y1p, ld, m);
    fq_load(z1, z1p, ld, m);
    fq_load(z2, z2p, ld, m);
    g1_add_core(x3, y3, z3, x1, y1, z1, x2, y2, z2);
    fq_store(oxp, ld, m, x3);
    fq_store(oyp, ld, m, y3);
    fq_store(ozp, ld, m, z3);
}

// ---------------------------------------------------------------------------
// g1_normalize: three coordinates <= 2p -> canonical < p.
// Bound: 6 x 24 words a lane (576 B), no product: bytes. One launch for the
// three coordinates, two conditional subtractions each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS, G1_MIN_BLOCKS)
g1_normalize_kernel(const int* __restrict__ xp, const int* __restrict__ yp,
                    const int* __restrict__ zp, int* __restrict__ oxp, int* __restrict__ oyp,
                    int* __restrict__ ozp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    uint32_t v[FQ_WORDS];
    fq_load(v, xp, ld, m);
    fq_normalize(v);
    fq_store(oxp, ld, m, v);
    fq_load(v, yp, ld, m);
    fq_normalize(v);
    fq_store(oyp, ld, m, v);
    fq_load(v, zp, ld, m);
    fq_normalize(v);
    fq_store(ozp, ld, m, v);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static inline unsigned g1_blocks(int M) { return (unsigned)((M + G1_THREADS - 1) / G1_THREADS); }

extern "C" int g1_double_launch(const int* x, const int* y, const int* z, int* ox, int* oy,
                                int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_double_kernel<<<g1_blocks(M), G1_THREADS, 0, (cudaStream_t)stream>>>(x, y, z, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_launch(const int* x1, const int* y1, const int* z1, const int* x2,
                             const int* y2, const int* z2, int* ox, int* oy, int* oz, int M,
                             void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_kernel<<<g1_blocks(M), G1_THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, z2, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_sel_launch(const int* x1, const int* y1, const int* z1, const int* x2,
                                 const int* y2, const int* sign, const int* valid, int* ox,
                                 int* oy, int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_sel_kernel<<<g1_blocks(M), G1_THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, sign, valid, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_sel_proj_launch(const int* x1, const int* y1, const int* z1,
                                      const int* x2, const int* y2, const int* z2,
                                      const int* sign, const int* valid, int* ox, int* oy,
                                      int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_sel_proj_kernel<<<g1_blocks(M), G1_THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, z2, sign, valid, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_normalize_launch(const int* x, const int* y, const int* z, int* ox, int* oy,
                                   int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_normalize_kernel<<<g1_blocks(M), G1_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, ox, oy, oz, M);
    return (int)cudaGetLastError();
}
