// BLS12-377 base-field (Fq) arithmetic for CUDA device code.
//
// An element is 12 32-bit words, little-endian, held in registers, in
// Montgomery form with radix 2^384 -- the same radix as the 24 x 16-bit limb
// layout of device memory, so a value packed from limbs, worked on here and
// unpacked again is bit-identical to what the plain PyTorch arithmetic
// (fields/limb_kernels.py) gives for the same inputs.
//
// Lazy reduction: operands and results of mul/add/sub stay < 2p (valid since
// 4p <= 2^384); fq_normalize gives the canonical value.
//
// Memory layout: limbs first. Limb l of lane m lies at p[l * ld + m], so the
// threads of a warp read neighbouring addresses for every limb.
//
// Loads, stores, the borrow chain and the Montgomery product are those of
// mont.cuh at 12 words (the same templates serve Fr at 8 words, fr.cuh).
//
// The constants below are checked against params.Q by the CPU test-suite
// (tests/test_torch_g1_affine.py parses this header). They are `static`: every
// source that includes this header (g1_affine.cu, g1_fused.cu) holds its own
// copy, and the objects link into one library without clashing.

#pragma once
#include <stdint.h>

#include "mont.cuh"

#define FQ_WORDS 12
#define FQ_LIMBS 24

// p
static __constant__ uint32_t FQ_P[FQ_WORDS] = {
    0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u, 0x1ef3622fu,
    0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
// 2p
static __constant__ uint32_t FQ_P2[FQ_WORDS] = {
    0x00000002u, 0x0a118000u, 0x60000001u, 0x2e16ba88u, 0x74129000u, 0x3de6c45fu,
    0x01ea271eu, 0x3445b3e6u, 0xd9429276u, 0x8c760b80u, 0x2f8a21d5u, 0x035c748cu};
// 2^384 mod p (Montgomery one)
static __constant__ uint32_t FQ_ONE[FQ_WORDS] = {
    0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u, 0x8a7d3ff2u, 0x9f7db3a9u,
    0x6e7c6305u, 0x7b4e97b7u, 0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
// -p^-1 mod 2^32
#define FQ_NP0 0xffffffffu

// The safegcd inversion (fq_inv.cuh) works on 13 signed limbs of 30 bits
// (390 bits >= the 379 a signed value below 2^378 needs).
#define FQ_S30_LIMBS 13
// p in 30-bit limbs
static __constant__ int32_t FQ_P_S30[FQ_S30_LIMBS] = {
    0x00000001, 0x14230000, 0x00000008, 0x02d7510c, 0x09480017, 0x0d88bee8, 0x1138f1ef,
    0x367cc03d, 0x093b1a22, 0x1701b285, 0x0eac63b0, 0x1185f144, 0x0001ae3a};
// R^2 mod p = 2^768 mod p in 30-bit limbs: the inversion's start value of e,
// so that a Montgomery input aR comes out as R / a, the Montgomery form of 1/a
static __constant__ int32_t FQ_R2_S30[FQ_S30_LIMBS] = {
    0x1400cd22, 0x1e19a1b2, 0x00431b1b, 0x0a7f2aac, 0x16b46d03, 0x17c4458b, 0x1c3ac22a,
    0x1f40e09f, 0x0bf9bfdf, 0x0bc105e4, 0x388837e9, 0x32c7a452, 0x00006dfc};
// p^-1 mod 2^30 (p = 1 mod 2^46, so it is 1)
#define FQ_PINV30 0x00000001u

// ---- memory <-> registers ---------------------------------------------------

// Pack 24 16-bit limbs (one per int32 word of memory) into 12 32-bit words.
__device__ __forceinline__ void fq_load(uint32_t w[FQ_WORDS], const int* __restrict__ p,
                                        long ld, long m) {
    mw_load<FQ_WORDS>(w, p, ld, m);
}

__device__ __forceinline__ void fq_store(int* __restrict__ p, long ld, long m,
                                         const uint32_t w[FQ_WORDS]) {
    mw_store<FQ_WORDS>(p, ld, m, w);
}

__device__ __forceinline__ void fq_copy(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) r[i] = a[i];
}

__device__ __forceinline__ void fq_set_const(uint32_t r[FQ_WORDS], const uint32_t* c) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) r[i] = c[i];
}

// r = cond ? a : b
__device__ __forceinline__ void fq_select(uint32_t r[FQ_WORDS], bool cond,
                                          const uint32_t a[FQ_WORDS],
                                          const uint32_t b[FQ_WORDS]) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) r[i] = cond ? a[i] : b[i];
}

// ---- 384-bit integer helpers --------------------------------------------------

// r = a + b, carry out dropped (callers keep sums < 2^384)
__device__ __forceinline__ void u384_add(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                         const uint32_t b[FQ_WORDS]) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) {
        c += (uint64_t)a[i] + (uint64_t)b[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r = a - b mod 2^384; returns the borrow (1 iff a < b)
__device__ __forceinline__ uint32_t u384_sub(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                             const uint32_t b[FQ_WORDS]) {
    return mw_sub<FQ_WORDS>(r, a, b);
}

// v -> v - c if v >= c (c = p or 2p)
__device__ __forceinline__ void fq_cond_sub(uint32_t v[FQ_WORDS], const uint32_t* c) {
    mw_cond_sub<FQ_WORDS>(v, c);
}

// ---- field ops (lazy: operands <= 2p, results < 2p unless noted) -------------

__device__ __forceinline__ void fq_add(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
    u384_add(r, a, b);
    fq_cond_sub(r, FQ_P2);
}

// r = a - b: a + 2p - b, then one conditional subtract of 2p
__device__ __forceinline__ void fq_sub(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
    uint32_t t[FQ_WORDS];
    fq_set_const(t, FQ_P2);
    u384_add(t, a, t);
    u384_sub(r, t, b);
    fq_cond_sub(r, FQ_P2);
}

// r = 2p - a (<= 2p; == -a mod p)
__device__ __forceinline__ void fq_neg(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
    uint32_t t[FQ_WORDS];
    fq_set_const(t, FQ_P2);
    u384_sub(r, t, a);
}

// r = 3a mod' 2p
__device__ __forceinline__ void fq_mul3(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
    uint32_t t[FQ_WORDS];
    u384_add(t, a, a);
    u384_add(r, t, a);
    fq_cond_sub(r, FQ_P2);
    fq_cond_sub(r, FQ_P2);
}

__device__ __forceinline__ void fq_normalize(uint32_t v[FQ_WORDS]) {
    fq_cond_sub(v, FQ_P2);
    fq_cond_sub(v, FQ_P);
}

// v == 0 (mod p) for a lazy value < 2p: both representatives {0, p}
__device__ __forceinline__ bool fq_is_zero(const uint32_t v[FQ_WORDS]) {
    uint32_t or0 = 0, orp = 0;
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) {
        or0 |= v[i];
        orp |= v[i] ^ FQ_P[i];
    }
    return (or0 == 0) | (orp == 0);
}

// Montgomery product a*b*2^-384 (CIOS over 32-bit words, mont.cuh).
// Operands < 2p give a result < 2p; no final subtraction, so the integer
// result equals the plain version's exactly.
__device__ __forceinline__ void fq_mul(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
    mw_mont_mul<FQ_WORDS>(r, a, b, FQ_P, FQ_NP0);
}

__device__ __forceinline__ void fq_sq(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
    fq_mul(r, a, a);
}
