// Batch-affine G1 accumulation kernels for Hopper (sm_90a).
//
// Four kernels, one thread per lane, every Fq value as 12 32-bit words in
// registers (fq.cuh). They replace the four Pallas kernels of the JAX
// package's curves/g1_affine.py:
//
//   fq_prepare  <- _build_prepare (_prepare_body)
//   fq_mul      <- _build_mul     (lk.mont_mul)
//   fq_fermat   <- _build_fermat  (_fermat_body)
//   fq_apply    <- _build_apply   (_apply_body)
//
// Each computes what its TPU kernel computes; the TPU bodies' Kogge-Stone
// carries, row-shift grouping, constant blocks and tile padding are matters
// of that machine and have no counterpart here: the ragged edge is masked by
// `if (m >= M) return`, constants live in __constant__ memory, carries ride
// 64-bit multiply-adds.
//
// Plain C interface (loaded with ctypes): every launcher takes device
// pointers to int32 limb arrays laid out limbs-first, the lane count, and
// the CUDA stream; it launches on that stream, does not synchronise, and
// returns cudaGetLastError().
//
// Registers per thread (nvcc 12.8, -O3, sm_90a, -Xptxas -v; no kernel spills):
// fq_prepare 96, fq_apply 80, fq_fermat 64, fq_mul 54.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define THREADS 128

// case codes, as in the JAX package
#define CASE_KEEP 0     // result = acc (invalid lane / P identity / both identity)
#define CASE_FORMULA 1  // result = chord/tangent formula
#define CASE_IDENT 2    // result = identity (P == -acc)
#define CASE_TAKE 3     // result = +-P (acc was identity)

// ---------------------------------------------------------------------------
// fq_mul: elementwise Montgomery product (the inversion tree's workhorse).
//
// Bound: a lane moves 3 x 24 int32 words (288 B) and does 2 x 144 = 288
// 32x32->64 multiply-adds plus carries. At the card's rates the bytes take
// about 2.5 times as long as the multiply-adds, so the kernel is bound by
// the memory traffic of the one-16-bit-limb-per-word layout; the design keeps every
// access coalesced (limbs first) and everything else in registers. Row
// strides are arguments so the halves of the inversion tree are multiplied
// in place, without copies.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fq_mul_kernel(const int* __restrict__ a, long lda, const int* __restrict__ b, long ldb,
              int* __restrict__ out, long ldo, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FQ_WORDS], y[FQ_WORDS];
    fq_load(x, a, lda, m);
    fq_load(y, b, ldb, m);
    fq_mul(x, x, y);
    fq_store(out, ldo, m, x);
}

// ---------------------------------------------------------------------------
// fq_prepare: per lane the denominator, numerator and case code of one
// batched affine add acc (+)= (sign ? -P : P) where valid.
//
// d is Montgomery one on every non-FORMULA lane, so the shared inversion
// tree never sees a zero. Equality is tested on lazy differences against
// both representatives {0, p} of zero.
//
// Bound: 4 coordinate reads + 2 writes of 24 words and 5 flag words per lane
// (596 B) against one squaring (~290 multiply-adds): memory traffic.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fq_prepare_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                  const int* __restrict__ inf1p, const int* __restrict__ x2p,
                  const int* __restrict__ y2p, const int* __restrict__ inf2p,
                  const int* __restrict__ signp, const int* __restrict__ validp,
                  int* __restrict__ dp, int* __restrict__ nump, int* __restrict__ casep,
                  int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    uint32_t x1[FQ_WORDS], y1[FQ_WORDS], x2[FQ_WORDS], y2[FQ_WORDS];
    fq_load(x1, x1p, ld, m);
    fq_load(y1, y1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_load(y2, y2p, ld, m);
    bool inf1 = inf1p[m] != 0, inf2 = inf2p[m] != 0;
    bool sign = signp[m] != 0, valid = validp[m] != 0;

    uint32_t t[FQ_WORDS], dx[FQ_WORDS], dy[FQ_WORDS];
    fq_neg(t, y2);
    fq_select(y2, sign, t, y2);                 // y2n
    fq_sub(dx, x2, x1);
    fq_sub(dy, y2, y1);
    bool xeq = fq_is_zero(dx), yeq = fq_is_zero(dy);
    bool active = valid && !inf1 && !inf2;
    bool is_dbl = xeq && yeq && active;
    bool is_cancel = xeq && !yeq && active;
    bool use = active && !is_cancel;

    // tangent-law operands
    uint32_t num_dbl[FQ_WORDS], den_dbl[FQ_WORDS];
    fq_sq(t, x1);
    fq_mul3(num_dbl, t);                        // 3 x1^2
    fq_add(den_dbl, y1, y1);                    // 2 y1

    uint32_t d[FQ_WORDS], num[FQ_WORDS], one[FQ_WORDS];
    fq_set_const(one, FQ_ONE);
    fq_select(d, is_dbl, den_dbl, dx);
    fq_select(num, is_dbl, num_dbl, dy);
    fq_select(d, use, d, one);

    int cs = use ? CASE_FORMULA : CASE_KEEP;
    if (is_cancel) cs = CASE_IDENT;
    if (inf1 && valid && !inf2) cs = CASE_TAKE;

    fq_store(dp, ld, m, d);
    fq_store(nump, ld, m, num);
    casep[m] = cs;
}

// ---------------------------------------------------------------------------
// fq_apply: finish the add with the batch-inverted denominators:
//   lam = num * inv, x3 = lam^2 - x1 - x2, y3 = lam (x1 - x3) - y1,
// selected by case; writes the new accumulator and its identity flag.
//
// Bound: 6 coordinate reads + 2 writes and 4 flag words per lane (784 B)
// against 3 products (~860 multiply-adds): memory traffic, by about two to
// one at the card's rates. The loads are ordered so that at most five values
// (lam, x1, x2, x3 and a temporary) are live at once: 80 registers, no spill.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fq_apply_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                const int* __restrict__ inf1p, const int* __restrict__ x2p,
                const int* __restrict__ y2p, const int* __restrict__ signp,
                const int* __restrict__ casep, const int* __restrict__ nump,
                const int* __restrict__ invp, int* __restrict__ oxp,
                int* __restrict__ oyp, int* __restrict__ oinfp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    int cs = casep[m];
    bool is_f = cs == CASE_FORMULA, is_t = cs == CASE_TAKE;

    uint32_t lam[FQ_WORDS], t[FQ_WORDS];
    fq_load(lam, nump, ld, m);
    fq_load(t, invp, ld, m);
    fq_mul(lam, lam, t);                        // lam = num * inv

    uint32_t x1[FQ_WORDS], x2[FQ_WORDS], x3[FQ_WORDS];
    fq_load(x1, x1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_sq(t, lam);
    fq_sub(t, t, x1);
    fq_sub(x3, t, x2);                          // x3 = lam^2 - x1 - x2

    uint32_t ox[FQ_WORDS];
    fq_select(ox, is_t, x2, x1);
    fq_select(ox, is_f, x3, ox);
    fq_store(oxp, ld, m, ox);

    uint32_t y1[FQ_WORDS], y2[FQ_WORDS];
    fq_load(y1, y1p, ld, m);
    fq_sub(t, x1, x3);
    fq_mul(t, lam, t);
    fq_sub(x3, t, y1);                          // y3 = lam (x1 - x3) - y1

    fq_load(y2, y2p, ld, m);
    fq_neg(t, y2);
    fq_select(y2, signp[m] != 0, t, y2);        // y2n
    fq_select(ox, is_t, y2, y1);
    fq_select(ox, is_f, x3, ox);
    fq_store(oyp, ld, m, ox);

    int oinf = inf1p[m];
    if (cs == CASE_IDENT) oinf = 1;
    if (is_f || is_t) oinf = 0;
    oinfp[m] = oinf;
}

// ---------------------------------------------------------------------------
// fq_fermat: x^(p-2), Montgomery in and out (mont(aR)^(p-2) chains give
// a^(p-2) R, the Montgomery form of the inverse). Binary square-and-multiply
// from the top bit: 376 squarings and 178 products (one per set bit), uniform over
// the threads (the exponent is a constant), no table, no spills.
//
// Called once per batched add on the <= 128 lanes at the root of the
// inversion tree: a single block whose threads each run a dependent chain
// of 554 products. It is bound by latency, not by bytes or by the card's
// multiply rate; its time is reported as it is.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fq_fermat_kernel(const int* __restrict__ xp, int* __restrict__ outp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FQ_WORDS], acc[FQ_WORDS], t[FQ_WORDS];
    fq_load(x, xp, M, m);
    fq_copy(acc, x);                            // top bit of the exponent
#pragma unroll 1
    for (int bit = FQ_EXP_BITS - 2; bit >= 0; bit--) {
        fq_sq(acc, acc);
        if ((FQ_EXP[bit >> 5] >> (bit & 31)) & 1u) {
            fq_mul(t, acc, x);
            fq_copy(acc, t);
        }
    }
    fq_store(outp, M, m, acc);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static inline unsigned blocks_for(int M) { return (unsigned)((M + THREADS - 1) / THREADS); }

extern "C" int fq_mul_launch(const int* a, long lda, const int* b, long ldb, int* out,
                             long ldo, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_mul_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(a, lda, b, ldb, out, ldo, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_prepare_launch(const int* x1, const int* y1, const int* inf1, const int* x2,
                                 const int* y2, const int* inf2, const int* sign,
                                 const int* valid, int* d, int* num, int* cs, int M,
                                 void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_prepare_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, inf1, x2, y2, inf2, sign, valid, d, num, cs, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_apply_launch(const int* x1, const int* y1, const int* inf1, const int* x2,
                               const int* y2, const int* sign, const int* cs, const int* num,
                               const int* inv, int* ox, int* oy, int* oinf, int M,
                               void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_apply_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, inf1, x2, y2, sign, cs, num, inv, ox, oy, oinf, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_fermat_launch(const int* x, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_fermat_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(x, out, M);
    return (int)cudaGetLastError();
}
