// Kernels of the MatNTT Montgomery reduction for Hopper (sm_90a).
//
// Three kernels, one thread per column. They replace the three Pallas
// kernels of the JAX package's fields/fmat_pallas.py:
//
//   fmat_reduce   <- _build_reduce_2d (_reduce_body, behind mont_reduce8)
//   fmat_carry2d  <- _build_2d        (_carry_body,  behind carry8, 2-D)
//   fmat_carry3d  <- _build_3d        (_carry_body,  behind carry8, 3-D)
//
// Each computes what its TPU kernel computes. The TPU bodies take a
// (K, 512) tile and carry with peel rounds plus a log-step Kogge-Stone pass
// because their lanes are vectors; here a thread owns a column and ripples
// the carry through it sequentially. Both leave the base-128 digits of the
// column's value mod 128^K and drop the carry out of the top limb, so the
// bytes are the same. The lane index is the fast axis of every tensor, so a
// warp's loads of one row are 128 contiguous bytes and its stores 32; the
// ragged edge is masked by `if (m >= M) return`, nothing is padded.
//
// Plain C interface (loaded with ctypes): every launcher takes device
// pointers, the sizes and the CUDA stream; it launches on that stream, does
// not synchronise, and returns cudaGetLastError().
//
// Registers per thread (nvcc 12.8, -O3, sm_90a, -Xptxas -v; no kernel spills,
// no stack): fmat_reduce 112, fmat_carry2d 32, fmat_carry3d 32. On an NVIDIA
// H100 80GB HBM3 at 700 W, at (76, 131072): fmat_reduce 0.032 ms against a
// bound of 0.017 ms, fmat_carry2d 0.020 ms against 0.015 ms (chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define L7 38           // 7-bit limbs per element
#define K7 76           // raw convolution columns
#define LIMB_BITS 7
#define LIMB_MASK 127

// The limbs of N' = -p^-1 mod 2^266 and of p. Passed to the kernel by value,
// so they lie in its constant bank; after full unrolling every index is a
// compile-time constant and a limb is an operand of the multiply-add.
struct FmatConsts {
    int np[L7];
    int p[L7];
};

// ---------------------------------------------------------------------------
// fmat_reduce: R7-Montgomery reduction of raw convolution columns.
//
//   t = carry(x)                      only the low 38 limbs are needed
//   m = carry(N' (*) t_lo) mod 2^266  741 multiply-adds (a triangular band)
//   u = carry(p (*) m + x) >> 266     1444 multiply-adds; the low 38 digits
//                                     are zero by construction, only their
//                                     carry goes on; the top 38 are written
//
// Both band products run in the kernel's own body, on the int32 pipe.
//
// Bound: a column moves 76 * 4 + 38 = 342 bytes and does 2185 int32
// multiply-adds; at the card's rates the two are of the same order (the
// multiply-adds a little above the bytes), so neither may be wasted. The
// design: t_lo and m stay in registers (38 each, never both with x: x is
// read a second time for the `+ x` of the last step, and that read hits L1
// or L2), every loop is fully unrolled so no array goes to local memory,
// and the constants cost no load.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fmat_reduce_kernel(const int* __restrict__ x, int8_t* __restrict__ out, int M,
                   const __grid_constant__ FmatConsts c) {
    long col = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= M) return;
    const int* xc = x + col;

    // t_lo: digits of the low 38 columns (the carry into column 38 stays in x)
    int t[L7];
    int carry = 0;
#pragma unroll
    for (int k = 0; k < L7; k++) {
        int v = xc[(long)k * M] + carry;
        t[k] = v & LIMB_MASK;
        carry = v >> LIMB_BITS;
    }

    // m = t_lo * N' mod 128^38, carried as it is summed
    int m[L7];
    carry = 0;
#pragma unroll
    for (int k = 0; k < L7; k++) {
        int acc = carry;
#pragma unroll
        for (int j = 0; j <= k; j++) acc += c.np[k - j] * t[j];
        m[k] = acc & LIMB_MASK;
        carry = acc >> LIMB_BITS;
    }

    // u = (x + m * p) / 128^38: the low half only hands its carry on
    carry = 0;
#pragma unroll
    for (int k = 0; k < K7; k++) {
        int acc = xc[(long)k * M] + carry;
#pragma unroll
        for (int j = 0; j < L7; j++) {
            if (k - j >= 0 && k - j < L7) acc += c.p[k - j] * m[j];
        }
        if (k >= L7) out[(long)(k - L7) * M + col] = (int8_t)(acc & LIMB_MASK);
        carry = acc >> LIMB_BITS;
    }
}

// ---------------------------------------------------------------------------
// fmat_carry2d / fmat_carry3d: column sums -> 7-bit limbs along the K axis.
//
// Bound: bytes (4 read and 1 written per element, three arithmetic
// operations). A thread streams its column: nothing is held but the carry,
// so K is a run-time argument and occupancy is full; the loads do not depend
// on the carry and are issued ahead of it (unroll 8).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void carry_column(const int* __restrict__ x,
                                             int8_t* __restrict__ out, int K, long stride) {
    int carry = 0;
#pragma unroll 8
    for (int k = 0; k < K; k++) {
        int v = x[(long)k * stride] + carry;
        out[(long)k * stride] = (int8_t)(v & LIMB_MASK);
        carry = v >> LIMB_BITS;
    }
}

__global__ void __launch_bounds__(THREADS)
fmat_carry2d_kernel(const int* __restrict__ x, int8_t* __restrict__ out, int K, int M) {
    long col = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= M) return;
    carry_column(x + col, out + col, K, M);
}

// element (b, k, t) at b*K*T + k*T + t; one thread per (b, t)
__global__ void __launch_bounds__(THREADS)
fmat_carry3d_kernel(const int* __restrict__ x, int8_t* __restrict__ out, int B, int K, int T) {
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long)B * T) return;
    long b = idx / T, t = idx % T;
    long base = b * K * T + t;
    carry_column(x + base, out + base, K, T);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static inline unsigned blocks_for(long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// consts: HOST pointer to 76 ints, the limbs of N' then the limbs of p
extern "C" int fmat_reduce_launch(const int* x, int8_t* out, int M, const int* consts,
                                  void* stream) {
    if (M <= 0) return (int)cudaErrorInvalidValue;
    FmatConsts c;
    for (int i = 0; i < L7; i++) {
        c.np[i] = consts[i];
        c.p[i] = consts[L7 + i];
    }
    fmat_reduce_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(x, out, M, c);
    return (int)cudaGetLastError();
}

extern "C" int fmat_carry2d_launch(const int* x, int8_t* out, int K, int M, void* stream) {
    if (K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
    fmat_carry2d_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(x, out, K, M);
    return (int)cudaGetLastError();
}

extern "C" int fmat_carry3d_launch(const int* x, int8_t* out, int B, int K, int T,
                                   void* stream) {
    if (B <= 0 || K <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
    fmat_carry3d_kernel<<<blocks_for((long)B * T), THREADS, 0, (cudaStream_t)stream>>>(
        x, out, B, K, T);
    return (int)cudaGetLastError();
}
