// Multi-word integer and Montgomery arithmetic for CUDA device code, generic
// in the word count W (a template parameter): Fq works on 12 32-bit words
// (fq.cuh), Fr on 8 (fr.cuh). A value is W little-endian words in registers;
// every loop below unrolls, so nothing is indexed at run time.
//
// Memory layout: limbs first, one 16-bit limb in each int32 word of memory.
// Limb l of lane m lies at p[l * ld + m], so the threads of a warp read
// neighbouring addresses for every limb; two limbs are packed into one
// register word.

#pragma once
#include <stdint.h>

// Pack 2W 16-bit limbs (one per int32 word of memory) into W 32-bit words.
template <int W>
__device__ __forceinline__ void mw_load(uint32_t w[W], const int* __restrict__ p, long ld,
                                        long m) {
#pragma unroll
    for (int i = 0; i < W; i++) {
        uint32_t lo = (uint32_t)p[(long)(2 * i) * ld + m];
        uint32_t hi = (uint32_t)p[(long)(2 * i + 1) * ld + m];
        w[i] = lo | (hi << 16);
    }
}

template <int W>
__device__ __forceinline__ void mw_store(int* __restrict__ p, long ld, long m,
                                         const uint32_t w[W]) {
#pragma unroll
    for (int i = 0; i < W; i++) {
        p[(long)(2 * i) * ld + m] = (int)(w[i] & 0xffffu);
        p[(long)(2 * i + 1) * ld + m] = (int)(w[i] >> 16);
    }
}

// r = a - b mod 2^(32 W); returns the borrow (1 iff a < b)
template <int W>
__device__ __forceinline__ uint32_t mw_sub(uint32_t r[W], const uint32_t a[W],
                                           const uint32_t b[W]) {
    uint64_t bw = 0;
#pragma unroll
    for (int i = 0; i < W; i++) {
        uint64_t d = (uint64_t)a[i] - (uint64_t)b[i] - bw;
        r[i] = (uint32_t)d;
        bw = (d >> 32) & 1u;
    }
    return (uint32_t)bw;
}

// v -> v - c if v >= c; c points at W constant words (p or 2p)
template <int W>
__device__ __forceinline__ void mw_cond_sub(uint32_t v[W], const uint32_t* c) {
    uint32_t cc[W], d[W];
#pragma unroll
    for (int i = 0; i < W; i++) cc[i] = c[i];
    uint32_t borrow = mw_sub<W>(d, v, cc);
#pragma unroll
    for (int i = 0; i < W; i++) v[i] = borrow == 0 ? d[i] : v[i];
}

// Montgomery product a * b * 2^(-32 W) mod p (CIOS over 32-bit words, 64-bit
// multiply-adds); p points at the modulus' W words, np0 = -p^-1 mod 2^32.
// No final subtraction: the result is the integer (a b + m p) / 2^(32 W)
// with m = a b N' mod 2^(32 W), because the quotient digits taken word by
// word are the digits of that m. It is therefore the very integer the
// full-radix form of the plain PyTorch arithmetic gives, bit for bit.
// The running value stays below a + p, so a, b < 2^(32 W) - p need two words
// of headroom (t[W], t[W + 1]) and no more. r may alias a or b.
template <int W>
__device__ __forceinline__ void mw_mont_mul(uint32_t r[W], const uint32_t a[W],
                                            const uint32_t b[W], const uint32_t* p,
                                            uint32_t np0) {
    uint32_t t[W + 2];
#pragma unroll
    for (int i = 0; i < W + 2; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < W; i++) {
        uint64_t c = 0;
        uint32_t bi = b[i];
#pragma unroll
        for (int j = 0; j < W; j++) {
            uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[W] + c;
        t[W] = (uint32_t)s;
        t[W + 1] = (uint32_t)(s >> 32);

        uint32_t m = t[0] * np0;
        s = (uint64_t)m * p[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < W; j++) {
            s = (uint64_t)m * p[j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[W] + c;
        t[W - 1] = (uint32_t)s;
        t[W] = t[W + 1] + (uint32_t)(s >> 32);
    }
#pragma unroll
    for (int i = 0; i < W; i++) r[i] = t[i];
}
