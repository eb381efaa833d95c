// BLS12-377 scalar-field (Fr) arithmetic for CUDA device code.
//
// An element is 8 32-bit words, little-endian, held in registers, in
// Montgomery form with radix 2^256 -- the radix of the 16 x 16-bit limb
// layout of device memory (fields/fr_lf.py). The arithmetic is mont.cuh's at
// 8 words; this header adds the modulus.
//
// The constants are checked against params.R by the CPU test-suite
// (tests/test_torch_proto_mul.py parses this header). They are `static`, as
// fq.cuh's are: every source that includes the header holds its own copy.

#pragma once
#include <stdint.h>

#include "mont.cuh"

#define FR_WORDS 8
#define FR_LIMBS 16

// r
static __constant__ uint32_t FR_P[FR_WORDS] = {
    0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
    0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};
// -r^-1 mod 2^32
#define FR_NP0 0xffffffffu

__device__ __forceinline__ void fr_load(uint32_t w[FR_WORDS], const int* __restrict__ p,
                                        long ld, long m) {
    mw_load<FR_WORDS>(w, p, ld, m);
}

__device__ __forceinline__ void fr_store(int* __restrict__ p, long ld, long m,
                                         const uint32_t w[FR_WORDS]) {
    mw_store<FR_WORDS>(p, ld, m, w);
}

// Montgomery product a*b*2^-256, lazy: no final subtraction. Operands < 2r
// give a result < 2r; operands up to 4r - 1 (every value the limb layout's
// callers hand over) give a result < 2.17 r, and the running value stays
// below a + r < 5r < 2^256, inside the product's two words of headroom.
__device__ __forceinline__ void fr_mul(uint32_t r[FR_WORDS], const uint32_t a[FR_WORDS],
                                       const uint32_t b[FR_WORDS]) {
    mw_mont_mul<FR_WORDS>(r, a, b, FR_P, FR_NP0);
}
