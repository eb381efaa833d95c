// The Fq Montgomery product for Hopper: two carry chains a row, in inline PTX.
//
// Same contract as fq_mul (fq.cuh): operands < 2p (2p itself is taken),
// result < 2p, no final subtraction. The result is the integer
// (a b + m p) / 2^384 with m = a b N' mod 2^384, the one integer every
// Montgomery product without a final subtraction gives, whatever its
// schedule; so it equals fq_mul's result and the plain PyTorch version's
// bit for bit.
//
// Why another product. mw_mont_mul (mont.cuh) threads one 64-bit carry
// through all 288 multiply-add steps of a product: every step waits for the
// high word of the step before it. Here the carries ride in the carry flag
// (mad.lo.cc / madc.hi.cc, SASS IMAD.X with a predicate carry), and the
// running value T of a row is kept in two accumulators (the form of
// supranational/sppark's ff/mont_t.cuh):
//
//   e[k] holds word k of T       (products a[j] b_i for even j, lo at j, hi at j + 1)
//   o[k] holds word k + 1 of T   (products a[j] b_i for odd j, lo at j, hi at j + 1)
//
// so that no two products of a row that land in one accumulator overlap,
// and a row is two independent chains of 12 multiply-adds, one for each
// accumulator, which the scheduler interleaves. After the reduction of a
// row word 0 of T is 0; the shift by one word swaps the two roles: o
// becomes the word-aligned accumulator, and e, two words down, the odd one
// (its word 1 folds into word 0 of the other).
//
// BLS12-377's p has p[0] = 1 and N' = -p^-1 mod 2^32 = 2^32 - 1, so the
// quotient digit m_i = T_0 N' is -T_0 (no multiply) and the first step of
// the even reduction chain, T_0 + m_i p[0], is 0 with a carry of (T_0 != 0).
//
// Carries. No chain takes a carry in from another asm statement: each one
// starts with an instruction that reads no carry and ends with one that
// writes none, so the compiler may place anything between two statements.
// The two ends that write no carry cannot overflow: madc.hi of a 32x32
// product with addend 0 is at most 2^32 - 1 even with a carry in, and a
// row's T stays below 2^413 (< 2^416, the 13 words e and o span), so
// neither accumulator outgrows its 12 words. tests/test_torch_g1_hopper.py
// repeats every instruction on the host, carry flag included, checks that
// no end overflows, and holds the result against (a b + m p) / 2^384.

#pragma once
#include <stdint.h>

// the words of p (fq.cuh's FQ_P) as immediates; p[0] = 1 is used implicitly
#define FQX_P1 0x8508c000u
#define FQX_P2 0x30000000u
#define FQX_P3 0x170b5d44u
#define FQX_P4 0xba094800u
#define FQX_P5 0x1ef3622fu
#define FQX_P6 0x00f5138fu
#define FQX_P7 0x1a22d9f3u
#define FQX_P8 0x6ca1493bu
#define FQX_P9 0xc63b05c0u
#define FQX_P10 0x17c510eau
#define FQX_P11 0x01ae3a46u

// row 0: e = a[even] b0, o = a[odd] b0, no accumulation
__device__ __forceinline__ void fqx_row_first(uint32_t e[12], uint32_t o[12],
                                              const uint32_t a[12], uint32_t bi) {
#pragma unroll
    for (int j = 0; j < 12; j += 2) {
        e[j] = a[j] * bi;
        e[j + 1] = __umulhi(a[j], bi);
        o[j] = a[j + 1] * bi;
        o[j + 1] = __umulhi(a[j + 1], bi);
    }
}

// a later row, after the shift: e is word-aligned, o[k] holds what was word
// k + 2 before the shift (k + 1 after it) and o[1] folds into e[0].
// Odd chain: e[0] += o[1], then o[k] = a[odd] bi + o[k + 2], shifted down.
// Even chain: e += a[even] bi, its carry out (word 12) into o[11].
__device__ __forceinline__ void fqx_row(uint32_t e[12], uint32_t o[12], const uint32_t a[12],
                                        uint32_t bi) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
        "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
        "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
        "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
        "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
        "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
        "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
        "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
        "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
        "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
        "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
        "madc.hi.u32 %12, %18, %19, 0;"
        : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
          "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]), "+r"(o[10]),
          "+r"(o[11])
        : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]), "r"(bi));
    asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]),
          "+r"(o[11])
        : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(a[8]), "r"(a[10]), "r"(bi));
}

// the reduction of a row: T += m_i p with m_i = -T_0, leaving word 0 zero.
// Odd chain: o += m_i p[odd]. Even chain: e[0] + m_i = 0 with a carry of
// (e[0] != 0) (p[0] = 1), then e += m_i p[even], its carry out into o[11].
__device__ __forceinline__ void fqx_redc(uint32_t e[12], uint32_t o[12]) {
    uint32_t mi = 0u - e[0];
    asm("mad.lo.cc.u32 %0, %12, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %12, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %12, %18, %10;\n\t"
        "madc.hi.u32 %11, %12, %18, %11;"
        : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
          "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
        : "r"(mi), "r"(FQX_P1), "r"(FQX_P3), "r"(FQX_P5), "r"(FQX_P7), "r"(FQX_P9),
          "r"(FQX_P11));
    asm("add.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "madc.lo.cc.u32 %2, %13, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %18, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %18, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]),
          "+r"(o[11])
        : "r"(mi), "r"(FQX_P2), "r"(FQX_P4), "r"(FQX_P6), "r"(FQX_P8), "r"(FQX_P10));
}

// r = a b 2^-384 (lazy: operands <= 2p, result < 2p). r may alias a or b.
__device__ __forceinline__ void fq_mul_ptx(uint32_t r[12], const uint32_t a[12],
                                           const uint32_t b[12]) {
    uint32_t e[12], o[12];
    fqx_row_first(e, o, a, b[0]);
    fqx_redc(e, o);
#pragma unroll
    for (int i = 1; i < 12; i += 2) {
        fqx_row(o, e, a, b[i]);         // odd rows: o is word-aligned
        fqx_redc(o, e);
        if (i + 1 < 12) {
            fqx_row(e, o, a, b[i + 1]);
            fqx_redc(e, o);
        }
    }
    // the last shift: T / 2^32 = e + (o >> 32), o[0] being 0
    asm("add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, 0;"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11])
        : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]),
          "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]));
#pragma unroll
    for (int k = 0; k < 12; k++) r[k] = e[k];
}
