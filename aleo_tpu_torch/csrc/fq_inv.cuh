// Fq inversion by Bernstein-Yang safegcd for CUDA device code.
//
// D. J. Bernstein and B.-Y. Yang, "Fast constant-time gcd computation and
// modular inversion" (2019), in the form libsecp256k1 gives it for 32-bit
// machines (modinv32: divsteps_30, update_fg_30, update_de_30,
// normalize_30), here for the 377-bit p of BLS12-377:
//
//   * f, g, d, e are 13 signed limbs of 30 bits (390 bits), limbs 0..11 in
//     [0, 2^30) and the top one signed;
//   * a batch runs 30 divsteps on the low limbs of f and g alone and yields a
//     2x2 transition matrix (u v; q r) with |u| + |v|, |q| + |r| <= 2^30,
//     which is then applied to the full f, g (exact division by 2^30) and to
//     d, e modulo p (a multiple of p added so the low 30 bits vanish; the
//     multiple needs p^-1 mod 2^30);
//   * d, e stay in (-2p, p), and normalize_30 brings d to [0, p) with the
//     sign of f.
//
// Divsteps are the original ones (delta starts at 1): with f odd,
//   delta > 0 and g odd:  (delta, f, g) <- (1 - delta, g, (g - f) / 2)
//   otherwise:            (delta, f, g) <- (1 + delta, f, (g + (g & 1) f) / 2)
// The paper's Theorem 11.2 bounds the count: if f^2 + 4 g^2 <= 5 * 2^(2 d)
// then g = 0 after m divsteps for every m >= (49 d + 57) / 17, d >= 46. Here
// f = p < 2^377 and g is a lazy input < 2p < 2^378, so f^2 + 4 g^2 < 17 *
// 2^754 <= 5 * 2^756 and d = 378 holds: ceil((49 d + 57) / 17) = 1093
// divsteps suffice, and SAFEGCD_BATCHES
// = 37 batches of 30 (1110 divsteps) cover them. The count is fixed, so
// every thread of a warp runs the same instructions; once g is 0 a divstep
// only doubles the matrix, which leaves d's residue class intact.
//
// Montgomery form: the start values are f = p, g = x, d = 0, e = R^2 mod p,
// and every batch keeps f = d x / R^2 and g = e x / R^2 (mod p). At the end
// f = +-1, so d = +-R^2 / x; for x = aR that is R / a, the Montgomery form of
// 1/a, and no product is needed to get there. The result is canonical (< p).
//
// Registers: f, g, d, e are 52 words; the batch loop is not unrolled, the
// divsteps and the limb loops inside it are.

#pragma once
#include <stdint.h>

#include "fq.cuh"

#define S30_MASK 0x3fffffff
#define SAFEGCD_BATCHES 37

// 12 words (< 2^384) -> 13 limbs of 30 bits
__device__ __forceinline__ void s30_from_words(int32_t r[FQ_S30_LIMBS],
                                               const uint32_t w[FQ_WORDS]) {
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) {
        const int bit = 30 * i, wi = bit >> 5, sh = bit & 31;
        uint32_t v = w[wi] >> sh;
        if (sh > 2 && wi + 1 < FQ_WORDS) v |= w[wi + 1] << (32 - sh);
        r[i] = (int32_t)(v & S30_MASK);
    }
}

// 13 limbs of 30 bits, each in [0, 2^30), value < 2^384 -> 12 words
__device__ __forceinline__ void s30_to_words(uint32_t w[FQ_WORDS],
                                             const int32_t r[FQ_S30_LIMBS]) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) w[i] = 0;
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) {
        const int bit = 30 * i, wi = bit >> 5, sh = bit & 31;
        const uint32_t v = (uint32_t)r[i];
        w[wi] |= v << sh;
        if (sh > 2 && wi + 1 < FQ_WORDS) w[wi + 1] |= v >> (32 - sh);
    }
}

// 30 divsteps on the low 30 bits of f (odd) and g, without a branch. The
// matrix is built in unsigned words mod 2^32 (its entries lie in
// [-2^30, 2^30], so the casts back are exact). Returns the new delta.
__device__ __forceinline__ int32_t divsteps_30(int32_t delta, uint32_t f, uint32_t g,
                                               int32_t t[4]) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int i = 0; i < 30; i++) {
        uint32_t c1 = (uint32_t)((-delta) >> 31);       // delta > 0
        const uint32_t c2 = 0u - (g & 1u);              // g odd
        const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
        g += x & c2;                                    // g -/+ f where g is odd
        q += y & c2;
        r += z & c2;
        c1 &= c2;                                       // swap
        delta = (int32_t)(((uint32_t)delta ^ c1) - c1) + 1;
        f += g & c1;                                    // f <- old g
        u += q & c1;
        v += r & c1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return delta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30, exact
__device__ __forceinline__ void update_fg_30(int32_t f[FQ_S30_LIMBS], int32_t g[FQ_S30_LIMBS],
                                             const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
    int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < FQ_S30_LIMBS; i++) {
        cf += (int64_t)u * f[i] + (int64_t)v * g[i];
        cg += (int64_t)q * f[i] + (int64_t)r * g[i];
        f[i - 1] = (int32_t)cf & S30_MASK;
        g[i - 1] = (int32_t)cg & S30_MASK;
        cf >>= 30;
        cg >>= 30;
    }
    f[FQ_S30_LIMBS - 1] = (int32_t)cf;
    g[FQ_S30_LIMBS - 1] = (int32_t)cg;
}

// (d, e) <- (u d + v e + md p, q d + r e + me p) / 2^30, with md, me chosen
// so the division is exact and d, e stay in (-2p, p)
__device__ __forceinline__ void update_de_30(int32_t d[FQ_S30_LIMBS], int32_t e[FQ_S30_LIMBS],
                                             const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    const int32_t sd = d[FQ_S30_LIMBS - 1] >> 31, se = e[FQ_S30_LIMBS - 1] >> 31;
    int32_t md = (u & sd) + (v & se);
    int32_t me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
    int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
    md -= (int32_t)((FQ_PINV30 * (uint32_t)cd + (uint32_t)md) & S30_MASK);
    me -= (int32_t)((FQ_PINV30 * (uint32_t)ce + (uint32_t)me) & S30_MASK);
    cd += (int64_t)FQ_P_S30[0] * md;
    ce += (int64_t)FQ_P_S30[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < FQ_S30_LIMBS; i++) {
        cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)FQ_P_S30[i] * md;
        ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)FQ_P_S30[i] * me;
        d[i - 1] = (int32_t)cd & S30_MASK;
        e[i - 1] = (int32_t)ce & S30_MASK;
        cd >>= 30;
        ce >>= 30;
    }
    d[FQ_S30_LIMBS - 1] = (int32_t)cd;
    e[FQ_S30_LIMBS - 1] = (int32_t)ce;
}

// carry the limbs of r into [0, 2^30), the top one signed
__device__ __forceinline__ void s30_propagate(int32_t r[FQ_S30_LIMBS]) {
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS - 1; i++) {
        r[i + 1] += r[i] >> 30;
        r[i] &= S30_MASK;
    }
}

// r in (-2p, p) -> (sign < 0 ? -r : r) mod p, canonical
__device__ __forceinline__ void normalize_30(int32_t r[FQ_S30_LIMBS], int32_t sign) {
    int32_t cond_add = r[FQ_S30_LIMBS - 1] >> 31;
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) r[i] += FQ_P_S30[i] & cond_add;
    const int32_t cond_negate = sign >> 31;
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) r[i] = (r[i] ^ cond_negate) - cond_negate;
    s30_propagate(r);
    cond_add = r[FQ_S30_LIMBS - 1] >> 31;
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) r[i] += FQ_P_S30[i] & cond_add;
    s30_propagate(r);
}

// out = R^2 / x mod p, canonical; x < 2p and x != 0 mod p. For a Montgomery
// x = aR this is the Montgomery form of 1/a.
__device__ __forceinline__ void fq_inv_safegcd(uint32_t out[FQ_WORDS],
                                               const uint32_t x[FQ_WORDS]) {
    int32_t f[FQ_S30_LIMBS], g[FQ_S30_LIMBS], d[FQ_S30_LIMBS], e[FQ_S30_LIMBS];
#pragma unroll
    for (int i = 0; i < FQ_S30_LIMBS; i++) {
        f[i] = FQ_P_S30[i];
        d[i] = 0;
        e[i] = FQ_R2_S30[i];
    }
    s30_from_words(g, x);
    int32_t delta = 1;
#pragma unroll 1
    for (int b = 0; b < SAFEGCD_BATCHES; b++) {
        int32_t t[4];
        delta = divsteps_30(delta, (uint32_t)f[0], (uint32_t)g[0], t);
        update_de_30(d, e, t);
        update_fg_30(f, g, t);
    }
    normalize_30(d, f[FQ_S30_LIMBS - 1]);
    s30_to_words(out, d);
}
