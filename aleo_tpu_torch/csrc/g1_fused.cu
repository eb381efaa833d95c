// Projective G1 group-law kernels for Hopper (sm_90a).
//
// Five kernels, every Fq value as 12 32-bit words in registers (fq.cuh).
// They replace the five Pallas kernels of the JAX package's
// curves/g1_fused.py:
//
//   g1_double        <- _build_double        (_double_body, RCB16 Alg. 9)
//   g1_add           <- _build_add           (_add_body,    RCB16 Alg. 7)
//   g1_add_sel       <- _build_add_sel       (_add_sel_body over _madd_body,
//                                             RCB16 Alg. 8, mixed)
//   g1_add_sel_proj  <- _build_add_sel_proj  (masked, signed Alg. 7)
//   g1_normalize     <- _build_normalize     (lk.normalize on x, y, z)
//
// g1_normalize runs one thread per lane. The doubling and the three adders
// (g1_double, g1_add, g1_add_sel, g1_add_sel_proj) spread a lane over
// several threads and use fq_mul_ptx (fq_mul_ptx.cuh); their section below
// says why.
//
// The curve is y^2 = x^3 + 1 (a = 0, b3 = 3). The formulas are complete:
// doubling, inverse pairs and the identity (z = 0, as the limbs of 0 or of p)
// on either side go through the same arithmetic, so there is no case code.
// Values are lazy: operands <= 2p, results < 2p (fq_neg may give 2p).
//
// Each kernel computes what its TPU kernel computes, product for product,
// so a result equals the plain PyTorch version's (curves/g1_fused.py) limb
// for limb after normalize. Tile padding and constant blocks of the TPU
// kernels have no counterpart: the kernels mask the ragged edge themselves,
// constants live in __constant__ memory.
//
// Masked lanes. g1_add_sel and g1_add_sel_proj return the accumulator on a
// lane that is not valid (and g1_add_sel on a lane whose addend is the
// (0, 0) sentinel) by copying its 72 stored words as they are: bit for bit,
// not re-reduced. Such a lane does no product, so a warp whose lanes are
// all masked costs its bytes only; late rounds of an MSM, where most
// segments are exhausted, are mostly such warps.
//
// Bounds. A lane of g1_add moves 9 x 24 words (864 B) and does 12 products
// of 2 x 144 32x32->64 multiply-adds: at the card's rates the multiply-adds
// take about 1.6 times as long as the bytes, so the three adders and the
// doubling (576 B against 8 products) are bound by operations;
// g1_normalize does no product and is bound by bytes.
//
// Out of place only: an output must not alias an input (the pointers are
// __restrict__).
//
// Plain C interface (loaded with ctypes): every launcher takes device
// pointers to contiguous (24, M) int32 limb arrays (flags: (1, M) int32), the
// lane count and the CUDA stream; it launches on that stream, does not
// synchronise, and returns cudaGetLastError().
//
// Registers per thread (nvcc 12.8, -O3, sm_90a, -Xptxas -v): 88 for
// g1_normalize, 80 for the doubling and the three adders (no spill). The
// build log of every run is printed by chip_smoke.py's device phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"
#include "fq_mul_ptx.cuh"

// Threads a block of g1_normalize, one lane a thread.
#define G1_THREADS 128

// ---------------------------------------------------------------------------
// The doubling and the three adders (g1_double, g1_add, g1_add_sel,
// g1_add_sel_proj): one lane spread over several threads, the roles.
//
// Alg. 7, 8 and 9 are two levels of independent products with cheap sums
// between them:
//
//   level 1   Alg. 7: t0 = x1 x2, t1 = y1 y2, t2 = z1 z2, (x1 + y1)(x2 + y2),
//                     (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2)
//             Alg. 8: t0 = x1 x2, t1 = y1 y2, (x1 + y1)(x2 + y2), z1 y2, z1 x2
//             Alg. 9: t0 = y y, t1 = y z, t2 = z z, txy = x y
//   derive    Alg. 7, 8: the six factors of level 2 (t3, t4, b3 y3, 3 t0, z3,
//             t1 - b3 z1 or t1 - b3 t2), each as its formula has it, in five
//             jobs (z3 and t1 share b3 t2 or b3 z1)
//             Alg. 9: e = 8 t0 (three additions); b3 t2, y3 = t0 + b3 t2 and
//             t0 = t0 - 3 (b3 t2); t1 and txy passed on: three jobs
//   level 2   Alg. 7, 8: t3 t1, t4 y3, t1 z3, y3 t0, z3 t4, t0 t3
//             Alg. 9: (b3 t2) e, t1 e, t0 y3, t0 txy
//   final     Alg. 7, 8: x3 = t3 t1 - t4 y3, y3 = t1 z3 + y3 t0,
//             z3 = z3 t4 + t0 t3
//             Alg. 9: x3 = 2 (t0 txy), y3 = (b3 t2) e + t0 y3, z3 = t1 e
//
// A block holds G1S_LANES lanes (a multiple of 32) and R roles (G1S_ROLES
// for the adders, G1S_DBL_ROLES for the doubling); the role is the slow
// index of threadIdx.x, so a warp is 32 lanes of one role: its loads are
// coalesced in the limbs-first layout, and it never diverges on which
// product it computes. Role r takes products and jobs r, r + R, r + 2R, ...
// of each step; the steps exchange their values through shared memory (12
// words a value, lane fastest: no bank conflicts) with one barrier between
// steps. A lane's critical path is two products (fq_mul_ptx,
// fq_mul_ptx.cuh) where one thread did 12 (11, 8), and a launch of L lanes
// has L / G1S_LANES blocks: 44 for the 1408-lane steps of the bucket
// reduction, which ran on 11 blocks of 128 threads before, and one for the
// 22 window totals that the doubling takes.
//
// Every step computes what the plain versions compute (`_add_plain`,
// `_madd_plain`, `_double_plain` of curves/g1_fused.py: the same sums in the
// same order, the same products), so the result equals theirs limb for limb
// after normalize. The operand tables below are read by
// tests/test_torch_g1_hopper.py, whose host model runs the same schedule
// in all four modes.
//
// Masks. In g1_add_sel a lane that is not valid, or whose addend is the
// (0, 0) sentinel (y2's stored limbs all zero, before the negation), and
// in g1_add_sel_proj a lane that is not valid, does no product and at the
// end copies the accumulator's 72 stored words as they are, split over the
// roles; a warp whose 32 lanes are all masked does no product. Masked lanes
// and lanes past the ragged edge still reach every barrier.
//
// Bound: g1_add 9 x 24 words a lane (864 B) against 12 products,
// g1_add_sel 8 x 24 + 2 words (776 B) against 11 on the kept lanes,
// g1_add_sel_proj 9 x 24 + 2 words (872 B) against 12 on the valid lanes,
// g1_double 6 x 24 words (576 B) against 8: operations, where most lanes
// are kept.
// ---------------------------------------------------------------------------

// Roles, lanes a block, and the blocks an SM must hold (a cap of 85
// registers; 80 are used, no spill). Of the variants that
// scripts/torch_g1_variants.py tries (2, 3 or 6 roles, 32 or 64 lanes,
// other caps), this one is within 3 % of the fastest at 22, 1408 and
// 45056 lanes on an H100; more lanes or fewer roles lengthen a
// block's critical path, and G1S_LANES * 12 * 4 B * 12 values of shared
// memory grow with the lanes.
#ifndef G1S_ROLES
#define G1S_ROLES 6
#endif
#ifndef G1S_LANES
#define G1S_LANES 32
#endif
#ifndef G1S_MIN_BLOCKS
#define G1S_MIN_BLOCKS 4
#endif
#define G1S_THREADS (G1S_ROLES * G1S_LANES)
// The doubling's roles: four products a level, so four roles leave none
// idle in a product step. Its blocks an SM keep the adders' cap of 85
// registers (768 threads an SM; 80 are used, no spill). On an H100 four
// and six roles are within 2 % at 22 and 1408 lanes and four are 6 %
// faster at 45056 (more lanes an SM in flight); 64 lanes a block are 9-21 %
// slower at every width (scripts/torch_g1_variants.py).
#ifndef G1S_DBL_ROLES
#define G1S_DBL_ROLES 4
#endif
#define G1S_DBL_THREADS (G1S_DBL_ROLES * G1S_LANES)
#define G1S_DBL_MIN_BLOCKS (768 / G1S_DBL_THREADS)
// what g1s_body computes: Alg. 7 on every lane (g1_add), Alg. 8 with an
// affine addend, the sign and the masks (g1_add_sel), Alg. 7 with the sign
// and the valid mask (g1_add_sel_proj), Alg. 9 on every lane (g1_double)
enum G1sMode { G1S_ADD, G1S_MADD_SEL, G1S_ADD_SEL_PROJ, G1S_DOUBLE };

// level 1, product j = (acc[u1] (+ acc[v1])) x (addend[u2] (+ addend[v2])),
// coordinates 0, 1, 2 = x, y, z; -1 = no second term. {u1, v1, u2, v2}.
// The doubling's addend is its own point.
static __constant__ int8_t G1S_ADD_L1[6][4] = {
    {0, -1, 0, -1}, {1, -1, 1, -1}, {2, -1, 2, -1}, {0, 1, 0, 1}, {1, 2, 1, 2}, {0, 2, 0, 2}};
static __constant__ int8_t G1S_MADD_L1[5][4] = {
    {0, -1, 0, -1}, {1, -1, 1, -1}, {0, 1, 0, 1}, {2, -1, 1, -1}, {2, -1, 0, -1}};
static __constant__ int8_t G1S_DBL_L1[4][4] = {
    {1, -1, 1, -1}, {1, -1, 2, -1}, {2, -1, 2, -1}, {0, -1, 1, -1}};
// level 2, product j = d[a] d[b] over the derived values
// d = (t3, t4, b3 y3, 3 t0, z3, t1 - b3 t2) of the adders and
// d = (b3 t2, e, t1, t0 - 3 b3 t2, t0 + b3 t2, txy) of the doubling
static __constant__ int8_t G1S_L2[6][2] = {{0, 5}, {1, 2}, {5, 4}, {2, 3}, {4, 1}, {3, 0}};
static __constant__ int8_t G1S_DBL_L2[4][2] = {{0, 1}, {2, 1}, {3, 4}, {3, 5}};
// the doubling's final sums: coordinate c = P[u] + P[v] over the level-2
// products P, or P[u] alone where v < 0. {u, v}
static __constant__ int8_t G1S_DBL_OUT[3][2] = {{3, 3}, {0, 2}, {1, -1}};

__device__ __forceinline__ void g1s_put(uint32_t* s, int lane, const uint32_t v[FQ_WORDS]) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) s[i * G1S_LANES + lane] = v[i];
}

__device__ __forceinline__ void g1s_get(uint32_t v[FQ_WORDS], const uint32_t* s, int lane) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) v[i] = s[i * G1S_LANES + lane];
}

// coordinate u of a point in memory (y negated when neg_y), as 12 words
__device__ __forceinline__ void g1s_coord(uint32_t v[FQ_WORDS], const int* __restrict__ xp,
                                          const int* __restrict__ yp,
                                          const int* __restrict__ zp, int u, bool neg_y,
                                          long ld, long m) {
    fq_load(v, u == 0 ? xp : (u == 1 ? yp : zp), ld, m);
    if (u == 1 && neg_y) fq_neg(v, v);
}

// coordinate u, plus coordinate w unless w < 0
__device__ __forceinline__ void g1s_operand(uint32_t v[FQ_WORDS], const int* __restrict__ xp,
                                            const int* __restrict__ yp,
                                            const int* __restrict__ zp, int u, int w,
                                            bool neg_y, long ld, long m) {
    g1s_coord(v, xp, yp, zp, u, neg_y, ld, m);
    if (w >= 0) {
        uint32_t t[FQ_WORDS];
        g1s_coord(t, xp, yp, zp, w, neg_y, ld, m);
        fq_add(v, v, t);
    }
}

// Alg. 7's derive job j (0..4): level-1 values in s1, derived values to s2
__device__ __forceinline__ void g1s_add_derive(int j, const uint32_t* s1, uint32_t* s2,
                                               int lane) {
    constexpr int V = FQ_WORDS * G1S_LANES;
    uint32_t a[FQ_WORDS], b[FQ_WORDS], c[FQ_WORDS];
    if (j == 4) {
        g1s_get(a, s1 + 2 * V, lane);
        fq_mul3(b, a);                          // b3 t2
        g1s_get(a, s1 + 1 * V, lane);           // t1
        fq_add(c, a, b);
        g1s_put(s2 + 4 * V, lane, c);           // z3 = t1 + b3 t2
        fq_sub(c, a, b);
        g1s_put(s2 + 5 * V, lane, c);           // t1 = t1 - b3 t2
        return;
    }
    if (j == 3) {
        g1s_get(a, s1, lane);
        fq_mul3(c, a);                          // 3 t0
        g1s_put(s2 + 3 * V, lane, c);
        return;
    }
    // j = 0, 1, 2: (product 3 + j) - (t_u + t_w), times b3 for j = 2
    const int u = j == 1 ? 1 : 0, w = j == 0 ? 1 : 2;
    g1s_get(a, s1 + u * V, lane);
    g1s_get(b, s1 + w * V, lane);
    fq_add(c, a, b);
    g1s_get(a, s1 + (3 + j) * V, lane);
    fq_sub(b, a, c);
    if (j == 2) fq_mul3(b, b);                  // b3 y3
    g1s_put(s2 + j * V, lane, b);
}

// Alg. 8's derive job j (0..4); x1, y1, z1 come from memory
__device__ __forceinline__ void g1s_madd_derive(int j, const uint32_t* s1, uint32_t* s2,
                                                int lane, const int* __restrict__ x1p,
                                                const int* __restrict__ y1p,
                                                const int* __restrict__ z1p, long ld,
                                                long m) {
    constexpr int V = FQ_WORDS * G1S_LANES;
    uint32_t a[FQ_WORDS], b[FQ_WORDS], c[FQ_WORDS];
    if (j == 0) {
        g1s_get(a, s1, lane);
        g1s_get(b, s1 + 1 * V, lane);
        fq_add(c, a, b);
        g1s_get(a, s1 + 2 * V, lane);
        fq_sub(b, a, c);                        // t3 = (x2 + y2)(x1 + y1) - t0 - t1
        g1s_put(s2, lane, b);
    } else if (j == 1) {
        g1s_get(a, s1 + 3 * V, lane);
        fq_load(b, y1p, ld, m);
        fq_add(c, a, b);                        // t4 = y2 z1 + y1
        g1s_put(s2 + 1 * V, lane, c);
    } else if (j == 2) {
        g1s_get(a, s1 + 4 * V, lane);
        fq_load(b, x1p, ld, m);
        fq_add(c, a, b);
        fq_mul3(c, c);                          // b3 y3, y3 = x2 z1 + x1
        g1s_put(s2 + 2 * V, lane, c);
    } else if (j == 3) {
        g1s_get(a, s1, lane);
        fq_add(b, a, a);
        fq_add(c, b, a);                        // 3 t0, by two additions
        g1s_put(s2 + 3 * V, lane, c);
    } else {
        fq_load(a, z1p, ld, m);
        fq_mul3(b, a);                          // b3 z1
        g1s_get(a, s1 + 1 * V, lane);           // t1
        fq_add(c, a, b);
        g1s_put(s2 + 4 * V, lane, c);           // z3 = t1 + b3 z1
        fq_sub(c, a, b);
        g1s_put(s2 + 5 * V, lane, c);           // t1 = t1 - b3 z1
    }
}

// Alg. 9's derive job j (0..2): t0, t1, t2, txy in s1, the level-2 factors
// d = (b3 t2, e, t1, t0 - 3 b3 t2, t0 + b3 t2, txy) to s2
__device__ __forceinline__ void g1s_dbl_derive(int j, const uint32_t* s1, uint32_t* s2,
                                               int lane) {
    constexpr int V = FQ_WORDS * G1S_LANES;
    uint32_t a[FQ_WORDS], b[FQ_WORDS], c[FQ_WORDS];
    if (j == 0) {
        g1s_get(a, s1, lane);
        fq_add(b, a, a);
        fq_add(b, b, b);
        fq_add(b, b, b);                        // e = 8 t0
        g1s_put(s2 + 1 * V, lane, b);
    } else if (j == 1) {
        g1s_get(a, s1 + 2 * V, lane);
        fq_mul3(b, a);                          // b3 t2
        g1s_put(s2, lane, b);
        g1s_get(a, s1, lane);                   // t0
        fq_add(c, a, b);
        g1s_put(s2 + 4 * V, lane, c);           // y3 = t0 + b3 t2
        fq_mul3(c, b);
        fq_sub(b, a, c);
        g1s_put(s2 + 3 * V, lane, b);           // t0 = t0 - 3 b3 t2
    } else {
        g1s_get(a, s1 + 1 * V, lane);
        g1s_put(s2 + 2 * V, lane, a);           // t1
        g1s_get(a, s1 + 3 * V, lane);
        g1s_put(s2 + 5 * V, lane, a);           // txy
    }
}

template <G1sMode MODE, int ROLES = G1S_ROLES>
__device__ __forceinline__ void g1s_body(
    const int* __restrict__ x1p, const int* __restrict__ y1p, const int* __restrict__ z1p,
    const int* __restrict__ x2p, const int* __restrict__ y2p, const int* __restrict__ z2p,
    const int* __restrict__ signp, const int* __restrict__ validp, int* __restrict__ oxp,
    int* __restrict__ oyp, int* __restrict__ ozp, int M) {
    constexpr int V = FQ_WORDS * G1S_LANES;
    constexpr bool MIXED = MODE == G1S_MADD_SEL, DOUBLE = MODE == G1S_DOUBLE;
    constexpr bool MASKED = MODE == G1S_MADD_SEL || MODE == G1S_ADD_SEL_PROJ;
    // products of level 1, derive jobs, products of level 2
    constexpr int N1 = DOUBLE ? 4 : (MIXED ? 5 : 6), ND = DOUBLE ? 3 : 5, N2 = DOUBLE ? 4 : 6;
    __shared__ uint32_t s1[6 * V], s2[6 * V];
    const int role = threadIdx.x / G1S_LANES, lane = threadIdx.x % G1S_LANES;
    const long m = (long)blockIdx.x * G1S_LANES + lane;
    const long ld = M;
    const bool live = m < M;
    bool keep = live, neg_y = false;
    if constexpr (MODE == G1S_MADD_SEL) {
        if (live) {
            int any = 0;
#pragma unroll
            for (int l = 0; l < FQ_LIMBS; l++) any |= y2p[(long)l * ld + m];
            neg_y = signp[m] != 0;
            keep = validp[m] != 0 && any != 0;
        }
    } else if constexpr (MODE == G1S_ADD_SEL_PROJ) {
        if (live) {
            neg_y = signp[m] != 0;
            keep = validp[m] != 0;
        }
    }
    // level 1. A live lane loads its operands whether it is kept or not, so
    // that these loads need not wait for the mask's. In g1_add_sel_proj,
    // where one lane in 16 is valid, this is ~10 % faster on an H100 than
    // loading the kept lanes alone, and within 1 % where all or half are: a
    // warp whose lanes are mixed runs the products anyway.
    uint32_t a[FQ_WORDS], b[FQ_WORDS];
    for (int j = role; j < N1; j += ROLES) {
        if (live) {
            int t[4];
#pragma unroll
            for (int i = 0; i < 4; i++) {
                if constexpr (MIXED)
                    t[i] = G1S_MADD_L1[j][i];
                else if constexpr (DOUBLE)
                    t[i] = G1S_DBL_L1[j][i];
                else
                    t[i] = G1S_ADD_L1[j][i];
            }
            g1s_operand(a, x1p, y1p, z1p, t[0], t[1], false, ld, m);
            g1s_operand(b, x2p, y2p, z2p, t[2], t[3], neg_y, ld, m);
        }
        if (keep) {
            fq_mul_ptx(a, a, b);
            g1s_put(s1 + j * V, lane, a);
        }
    }
    __syncthreads();
    if (keep) {
        for (int j = role; j < ND; j += ROLES) {
            if constexpr (MIXED)
                g1s_madd_derive(j, s1, s2, lane, x1p, y1p, z1p, ld, m);
            else if constexpr (DOUBLE)
                g1s_dbl_derive(j, s1, s2, lane);
            else
                g1s_add_derive(j, s1, s2, lane);
        }
    }
    __syncthreads();
    if (keep) {
        for (int j = role; j < N2; j += ROLES) {
            const int u = DOUBLE ? G1S_DBL_L2[j][0] : G1S_L2[j][0];
            const int w = DOUBLE ? G1S_DBL_L2[j][1] : G1S_L2[j][1];
            g1s_get(a, s2 + u * V, lane);
            g1s_get(b, s2 + w * V, lane);
            fq_mul_ptx(a, a, b);
            g1s_put(s1 + j * V, lane, a);
        }
    }
    __syncthreads();
    if (keep) {
        for (int c = role; c < 3; c += ROLES) {
            if constexpr (DOUBLE) {
                g1s_get(a, s1 + G1S_DBL_OUT[c][0] * V, lane);
                if (G1S_DBL_OUT[c][1] >= 0) {
                    g1s_get(b, s1 + G1S_DBL_OUT[c][1] * V, lane);
                    fq_add(a, a, b);            // x3 = 2 t0 txy, y3 = (b3 t2) e + t0 y3
                }
            } else {
                g1s_get(a, s1 + 2 * c * V, lane);
                g1s_get(b, s1 + (2 * c + 1) * V, lane);
                if (c == 0)
                    fq_sub(a, a, b);            // x3 = t3 t1 - t4 y3
                else
                    fq_add(a, a, b);            // y3 = t1 z3 + y3 t0, z3 = z3 t4 + t0 t3
            }
            fq_store(c == 0 ? oxp : (c == 1 ? oyp : ozp), ld, m, a);
        }
    }
    // a masked lane: the accumulator's stored words, split over the roles
    if constexpr (MASKED) {
        if (live && !keep) {
            for (int k = role; k < 3 * FQ_LIMBS; k += ROLES) {
                const int c = k / FQ_LIMBS, l = k % FQ_LIMBS;
                const int* src = c == 0 ? x1p : (c == 1 ? y1p : z1p);
                int* dst = c == 0 ? oxp : (c == 1 ? oyp : ozp);
                dst[(long)l * ld + m] = src[(long)l * ld + m];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// g1_double: (x, y, z) -> 2 (x, y, z), complete (RCB16 Alg. 9, a = 0).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1S_DBL_THREADS, G1S_DBL_MIN_BLOCKS)
g1_double_kernel(const int* __restrict__ xp, const int* __restrict__ yp,
                 const int* __restrict__ zp, int* __restrict__ oxp, int* __restrict__ oyp,
                 int* __restrict__ ozp, int M) {
    g1s_body<G1S_DOUBLE, G1S_DBL_ROLES>(xp, yp, zp, xp, yp, zp, nullptr, nullptr, oxp, oyp, ozp,
                                        M);
}

// ---------------------------------------------------------------------------
// g1_add: (x1, y1, z1) + (x2, y2, z2), complete.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1S_THREADS, G1S_MIN_BLOCKS)
g1_add_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
              const int* __restrict__ z1p, const int* __restrict__ x2p,
              const int* __restrict__ y2p, const int* __restrict__ z2p,
              int* __restrict__ oxp, int* __restrict__ oyp, int* __restrict__ ozp, int M) {
    g1s_body<G1S_ADD>(x1p, y1p, z1p, x2p, y2p, z2p, nullptr, nullptr, oxp, oyp, ozp, M);
}

// ---------------------------------------------------------------------------
// g1_add_sel: acc (+)= (sign ? -P : P) where valid, else acc; P affine.
// P == (0, 0) is the identity sentinel of the MSM's point table: it is
// recognised by the stored limbs of y2 being all zero (table rows are
// canonical), before the negation (-0 is stored as 2p), and masked like an
// invalid lane.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1S_THREADS, G1S_MIN_BLOCKS)
g1_add_sel_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                  const int* __restrict__ z1p, const int* __restrict__ x2p,
                  const int* __restrict__ y2p, const int* __restrict__ signp,
                  const int* __restrict__ validp, int* __restrict__ oxp,
                  int* __restrict__ oyp, int* __restrict__ ozp, int M) {
    g1s_body<G1S_MADD_SEL>(x1p, y1p, z1p, x2p, y2p, nullptr, signp, validp, oxp, oyp, ozp, M);
}

// ---------------------------------------------------------------------------
// g1_add_sel_proj: acc (+)= (sign ? -P : P) where valid, else acc; P
// projective (the merge of two bucket accumulators). No sentinel: an
// identity addend has z = 0 and the complete law takes it.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1S_THREADS, G1S_MIN_BLOCKS)
g1_add_sel_proj_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                       const int* __restrict__ z1p, const int* __restrict__ x2p,
                       const int* __restrict__ y2p, const int* __restrict__ z2p,
                       const int* __restrict__ signp, const int* __restrict__ validp,
                       int* __restrict__ oxp, int* __restrict__ oyp, int* __restrict__ ozp,
                       int M) {
    g1s_body<G1S_ADD_SEL_PROJ>(x1p, y1p, z1p, x2p, y2p, z2p, signp, validp, oxp, oyp, ozp,
                               M);
}

// ---------------------------------------------------------------------------
// g1_normalize: three coordinates <= 2p -> canonical < p.
// Bound: 6 x 24 words a lane (576 B), no product: bytes. One launch for the
// three coordinates, two conditional subtractions each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(G1_THREADS)
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
static inline unsigned g1s_blocks(int M) { return (unsigned)((M + G1S_LANES - 1) / G1S_LANES); }

extern "C" int g1_double_launch(const int* x, const int* y, const int* z, int* ox, int* oy,
                                int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_double_kernel<<<g1s_blocks(M), G1S_DBL_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_launch(const int* x1, const int* y1, const int* z1, const int* x2,
                             const int* y2, const int* z2, int* ox, int* oy, int* oz, int M,
                             void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_kernel<<<g1s_blocks(M), G1S_THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, z2, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_sel_launch(const int* x1, const int* y1, const int* z1, const int* x2,
                                 const int* y2, const int* sign, const int* valid, int* ox,
                                 int* oy, int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_sel_kernel<<<g1s_blocks(M), G1S_THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, sign, valid, ox, oy, oz, M);
    return (int)cudaGetLastError();
}

extern "C" int g1_add_sel_proj_launch(const int* x1, const int* y1, const int* z1,
                                      const int* x2, const int* y2, const int* z2,
                                      const int* sign, const int* valid, int* ox, int* oy,
                                      int* oz, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    g1_add_sel_proj_kernel<<<g1s_blocks(M), G1S_THREADS, 0, (cudaStream_t)stream>>>(
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
