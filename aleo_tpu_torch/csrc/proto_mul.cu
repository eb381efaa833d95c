// Montgomery-product kernels for Hopper (sm_90a): the Fq product with a
// canonical result, a chain of twelve dependent Fq products, and the Fr
// product.
//
// Three kernels, one thread per element, every value in registers (Fq: 12
// 32-bit words, fq.cuh; Fr: 8 words, fr.cuh). They replace the three Pallas
// kernels of the JAX package's stand-alone tools:
//
//   fq_mul_canon    <- tools/proto_pallas_mul.py make_mul
//                      (_mont_mul_tile, then _cond_sub_p)
//   fq_mul_chain12  <- tools/proto_pallas_mul.py make_mul12
//                      (six rounds of x2 = x*y; y = y*x; x = x2, then
//                      _cond_sub_p)
//   fr_mul          <- tools/microbench_fr_mul.py, the fused kernel around
//                      limb_kernels.mont_mul (lazy result)
//
// fq_mul_canon multiplies on fq_mul_ptx (fq_mul_ptx.cuh: two carry chains a
// row in inline PTX), one warp a block, as fq_mul of g1_affine.cu does;
// fq_mul_chain12 and fr_mul run the CIOS product of mont.cuh, 128 threads a
// block.
//
// The TPU bodies' Kogge-Stone carries, row-shift grouping, constant blocks
// and tiles are matters of that machine: here carries ride 64-bit
// multiply-adds or the carry flag, the moduli live in __constant__ memory
// and the ragged edge is masked by `if (m >= M) return`.
//
// Bounds, per element. fq_mul_canon and fr_mul move three limb arrays of
// one int32 word per 16-bit limb (288 and 192 bytes) for one product (2 x
// 144 and 2 x 64 32x32->64 multiply-adds): at the card's rates the bytes
// take 2.5 and 3.8 times as long as the multiply-adds, so both are bound by
// memory traffic, as fq_mul is; the design keeps every access coalesced
// (limbs first) and everything else in registers. fq_mul_chain12 moves the
// same 288 bytes for twelve products and is bound by operations: its twelve
// products are one dependent chain per thread (each needs the one before),
// so only other warps hide the latency of the carry chains.
//
// fq_mul_chain12 keeps x, y and x2 live (36 words) beside the product's 14.
//
// Plain C interface (loaded with ctypes): every launcher takes device
// pointers to int32 limb arrays laid out limbs-first with row stride M, the
// element count, and the CUDA stream; it launches on that stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"
#include "fq_mul_ptx.cuh"
#include "fr.cuh"

#define PM_THREADS 128

// a*b*R^-1 mod q, canonical (< q). fq_mul_ptx takes operands <= 2q and
// gives a product < 2q, so one conditional subtraction of q finishes it.
// One lane a thread, FQC_THREADS (one warp) a block, loads where they are
// used: the form of fq_mul (g1_affine.cu), whose measurements ranked it
// above two or four lanes a thread (PERF.md, K3). The block size is a macro
// so that scripts/torch_g1_variants.py can build other sizes.
#ifndef FQC_THREADS
#define FQC_THREADS 32
#endif

__global__ void __launch_bounds__(FQC_THREADS)
fq_mul_canon_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    int* __restrict__ out, int M) {
    long m = (long)blockIdx.x * FQC_THREADS + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FQ_WORDS], y[FQ_WORDS];
    fq_load(x, a, M, m);
    fq_load(y, b, M, m);
    fq_mul_ptx(x, x, y);
    fq_cond_sub(x, FQ_P);
    fq_store(out, M, m, x);
}

// Twelve dependent products in one launch: six rounds of
//   x2 = x*y, y = y*x, x = x2
// (both products of a round read the round's old x), lazy (< 2q) in
// between, canonical at the end.
__global__ void __launch_bounds__(PM_THREADS)
fq_mul_chain12_kernel(const int* __restrict__ a, const int* __restrict__ b,
                      int* __restrict__ out, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FQ_WORDS], y[FQ_WORDS], x2[FQ_WORDS];
    fq_load(x, a, M, m);
    fq_load(y, b, M, m);
#pragma unroll 1
    for (int round = 0; round < 6; round++) {
        fq_mul(x2, x, y);
        fq_mul(y, y, x);
        fq_copy(x, x2);
    }
    fq_cond_sub(x, FQ_P);
    fq_store(out, M, m, x);
}

// a*b*R^-1 over Fr, lazy: the integer (a b + m r) / 2^256, not reduced
// further (fr.cuh).
__global__ void __launch_bounds__(PM_THREADS)
fr_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
              int* __restrict__ out, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FR_WORDS], y[FR_WORDS];
    fr_load(x, a, M, m);
    fr_load(y, b, M, m);
    fr_mul(x, x, y);
    fr_store(out, M, m, x);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static inline unsigned pm_blocks(int M) { return (unsigned)((M + PM_THREADS - 1) / PM_THREADS); }

static inline unsigned fqc_blocks(int M) {
    return (unsigned)((M + FQC_THREADS - 1) / FQC_THREADS);
}

extern "C" int fq_mul_canon_launch(const int* a, const int* b, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_mul_canon_kernel<<<fqc_blocks(M), FQC_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_mul_chain12_launch(const int* a, const int* b, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_mul_chain12_kernel<<<pm_blocks(M), PM_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M);
    return (int)cudaGetLastError();
}

extern "C" int fr_mul_launch(const int* a, const int* b, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fr_mul_kernel<<<pm_blocks(M), PM_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M);
    return (int)cudaGetLastError();
}
