// Batch-affine G1 accumulation kernels for Hopper (sm_90a).
//
// Six kernels, every Fq value as 12 32-bit words in registers (fq.cuh). They
// replace the four Pallas kernels of the JAX package's curves/g1_affine.py:
//
//   fq_prepare   <- _build_prepare (_prepare_body)
//   fq_mul       <- _build_mul     (lk.mont_mul)
//   fq_inv_up    <- _build_mul, as the inversion tree's levels going up
//   fq_inv_down  <- _build_mul, as the inversion tree's levels going down
//   fq_fermat    <- _build_fermat  (_fermat_body), by safegcd (fq_inv.cuh)
//   fq_apply     <- _build_apply   (_apply_body)
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
// fq_prepare 96, fq_apply 80, fq_mul 64, fq_fermat 76, fq_inv_up 80 and
// fq_inv_down 168 (both with 24 KB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"
#include "fq_inv.cuh"
#include "fq_mul_ptx.cuh"

#define THREADS 128

// case codes, as in the JAX package
#define CASE_KEEP 0     // result = acc (invalid lane / P identity / both identity)
#define CASE_FORMULA 1  // result = chord/tangent formula
#define CASE_IDENT 2    // result = identity (P == -acc)
#define CASE_TAKE 3     // result = +-P (acc was identity)

// ---------------------------------------------------------------------------
// fq_mul: elementwise Montgomery product (to_affine's; the JAX package's
// inversion tree ran on it, which fq_inv_up and fq_inv_down now do).
//
// Bound: a lane moves 3 x 24 int32 words (288 B) and does 2 x 144 = 288
// 32x32->64 multiply-adds plus carries. At the card's rates the bytes take
// about 2.5 times as long as the multiply-adds, so the kernel is bound by
// the memory traffic of the one-16-bit-limb-per-word layout; every access
// is coalesced (limbs first) and everything else stays in registers. In
// one wave the time is still that of the loads plus that of the products:
// every warp loads, multiplies and stores at the same time (PERF.md, K5).
//
// The product is fq_mul_ptx (fq_mul_ptx.cuh), one lane a thread, one warp a
// block. A thread takes FQM_LANES lanes, m, m + G, ... (G the grid's thread
// count, so that every row a warp reads stays coalesced); the grid is
// ceil(M / (FQM_THREADS * FQM_LANES)) blocks. One lane a thread is the
// fastest form on an H100: a thread that takes two or four lanes, with or
// without the next lane's loads issued before the current product (a
// register double buffer), runs its products one after another on fewer
// warps, and a product alone on a warp takes ~1.4 us. At 50688 lanes that
// lost more than the overlap of loads and products gained (PERF.md, K3;
// scripts/torch_g1_variants.py sweeps FQM_LANES).
// ---------------------------------------------------------------------------
#ifndef FQM_LANES
#define FQM_LANES 1
#endif
#define FQM_THREADS 32

__global__ void __launch_bounds__(FQM_THREADS)
fq_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
              int M) {
    const long G = (long)gridDim.x * FQM_THREADS;
    long m = (long)blockIdx.x * FQM_THREADS + threadIdx.x;
#pragma unroll
    for (int i = 0; i < FQM_LANES && m < M; i++, m += G) {
        uint32_t x[FQ_WORDS], y[FQ_WORDS];
        fq_load(x, a, M, m);
        fq_load(y, b, M, m);
        fq_mul_ptx(x, x, y);
        fq_store(out, M, m, x);
    }
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
//
// A launch of the main path is one wave in which every warp runs the same
// sequence, so the loads and the products of all warps fall into the same
// phases and their times add. The products are fq_mul_ptx (fq_mul_ptx.cuh):
// fq_mul's integer in 800 instructions instead of 1358, which shortens the
// product phases. Issuing the loads earlier did not overlap the phases on
// an H100: a value's 24 limbs lie in 24 rows of the limbs-first layout, so
// an early load lands only with its last row, and cp.async copies into
// shared memory (all groups at the start, or one group ahead) were slower
// than these loads (PERF.md, K5). FQA_LANES threads a block, one a lane: 32
// and 64 are as fast, 128 is 2 % and 256 12 % slower at 50688 lanes
// (scripts/torch_g1_variants.py).
// ---------------------------------------------------------------------------
#ifndef FQA_LANES
#define FQA_LANES 32
#endif

__global__ void __launch_bounds__(FQA_LANES)
fq_apply_kernel(const int* __restrict__ x1p, const int* __restrict__ y1p,
                const int* __restrict__ inf1p, const int* __restrict__ x2p,
                const int* __restrict__ y2p, const int* __restrict__ signp,
                const int* __restrict__ casep, const int* __restrict__ nump,
                const int* __restrict__ invp, int* __restrict__ oxp,
                int* __restrict__ oyp, int* __restrict__ oinfp, int M) {
    long m = (long)blockIdx.x * FQA_LANES + threadIdx.x;
    if (m >= M) return;
    long ld = M;
    int cs = casep[m];
    bool is_f = cs == CASE_FORMULA, is_t = cs == CASE_TAKE;

    uint32_t lam[FQ_WORDS], t[FQ_WORDS];
    fq_load(lam, nump, ld, m);
    fq_load(t, invp, ld, m);
    fq_mul_ptx(lam, lam, t);                    // lam = num * inv

    uint32_t x1[FQ_WORDS], x2[FQ_WORDS], x3[FQ_WORDS];
    fq_load(x1, x1p, ld, m);
    fq_load(x2, x2p, ld, m);
    fq_mul_ptx(t, lam, lam);
    fq_sub(t, t, x1);
    fq_sub(x3, t, x2);                          // x3 = lam^2 - x1 - x2

    uint32_t ox[FQ_WORDS];
    fq_select(ox, is_t, x2, x1);
    fq_select(ox, is_f, x3, ox);
    fq_store(oxp, ld, m, ox);

    uint32_t y1[FQ_WORDS], y2[FQ_WORDS];
    fq_load(y1, y1p, ld, m);
    fq_sub(t, x1, x3);
    fq_mul_ptx(t, lam, t);
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
// The batch inversion, Montgomery's trick over tiles (curves/g1_affine.py,
// batch_inv_lf): fq_inv_up multiplies each tile of INV_TILE consecutive lanes
// to one root, fq_fermat inverts the <= 128 roots, fq_inv_down pushes each
// root's inverse back down its tile. Three launches where the JAX package
// ran one product kernel (_build_mul) per tree level up and one per level
// down. Past 128 tiles (more than 131072 lanes) fq_inv_up is applied to the
// roots again, and fq_inv_down once more on the way back.
//
// A tile is one block of INV_THREADS threads, four lanes each: thread t holds
// lanes t, t + 256, t + 512, t + 768 (every load and store coalesced). The
// tree pairs the two halves of a level (parent i = child i * child i + w), as
// the JAX package's tree does: the first two levels in registers (a_lo = x0
// x2, a_hi = x1 x3, b = a_lo a_hi), the other eight in shared memory, where
// the level of width w lies at nodes [w, 2w), each node word-major so that
// neighbouring threads touch neighbouring banks (24 KB). Lanes past M read
// as Montgomery one, so a ragged tile needs no padded copy and a tile of
// padding alone has the root one.
//
// fq_inv_down rebuilds the tile's tree instead of reading one that
// fq_inv_up wrote: d is read twice and nothing is written in between. The
// stored tree would cost about 1.5 values per lane of writes and reads (some
// 140 B a lane, 4 us at 50688 lanes) to spare ten dependent products.
//
// Bounds at 50688 lanes (a round of the 32768-point MSM): fq_inv_up reads d
// (96 B a lane, 1.5 us) and does about one product a lane (1.7 us);
// fq_inv_down reads d, writes the inverses (2.9 us) and does two products a
// lane (3.5 us). Both are in fact bound by latency: a tile's product is a
// chain of ten dependent products (twenty in fq_inv_down, rebuild and
// pushdown), and the upper levels run on a few threads of each block.
// ---------------------------------------------------------------------------
#define INV_THREADS 256
#define INV_TILE (4 * INV_THREADS)

typedef uint32_t InvTree[FQ_WORDS][2 * INV_THREADS];

__device__ __forceinline__ void tree_put(InvTree& tree, int k, const uint32_t v[FQ_WORDS]) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) tree[i][k] = v[i];
}

__device__ __forceinline__ void tree_get(uint32_t v[FQ_WORDS], const InvTree& tree, int k) {
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) v[i] = tree[i][k];
}

// this thread's four lanes of the block's tile; Montgomery one past M
__device__ __forceinline__ void tile_load(uint32_t x[4][FQ_WORDS], const int* __restrict__ dp,
                                          int M) {
    const long base = (long)blockIdx.x * INV_TILE + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const long m = base + j * INV_THREADS;
        if (m < M)
            fq_load(x[j], dp, M, m);
        else
            fq_set_const(x[j], FQ_ONE);
    }
}

// The tile's product tree: a_lo, a_hi in registers, the threads' products b
// at nodes [256, 512) and the tile's product at node 1.
__device__ __forceinline__ void tile_tree_up(InvTree& tree, const uint32_t x[4][FQ_WORDS],
                                             uint32_t alo[FQ_WORDS], uint32_t ahi[FQ_WORDS]) {
    const int t = threadIdx.x;
    uint32_t b[FQ_WORDS];
    fq_mul(alo, x[0], x[2]);
    fq_mul(ahi, x[1], x[3]);
    fq_mul(b, alo, ahi);
    tree_put(tree, INV_THREADS + t, b);
    __syncthreads();
#pragma unroll 1
    for (int w = INV_THREADS / 2; w >= 1; w >>= 1) {
        if (t < w) {
            uint32_t lo[FQ_WORDS], hi[FQ_WORDS];
            tree_get(lo, tree, 2 * w + t);
            tree_get(hi, tree, 3 * w + t);
            fq_mul(lo, lo, hi);
            tree_put(tree, w + t, lo);
        }
        __syncthreads();
    }
}

// fq_inv_up: d (24, M) -> roots (24, ceil(M / INV_TILE)), each tile's product
__global__ void __launch_bounds__(INV_THREADS)
fq_inv_up_kernel(const int* __restrict__ dp, int* __restrict__ rootp, int M) {
    __shared__ InvTree tree;
    uint32_t x[4][FQ_WORDS], alo[FQ_WORDS], ahi[FQ_WORDS];
    tile_load(x, dp, M);
    tile_tree_up(tree, x, alo, ahi);
    if (threadIdx.x == 0) {
        uint32_t r[FQ_WORDS];
        tree_get(r, tree, 1);
        fq_store(rootp, gridDim.x, blockIdx.x, r);
    }
}

// fq_inv_down: d (24, M) and the inverses of its tile roots (24, ceil(M /
// INV_TILE)) -> 1/d (24, M). Going down, the children of a node with the
// inverse iv are iv * sibling: [lo, hi] <- [iv hi, iv lo].
__global__ void __launch_bounds__(INV_THREADS)
fq_inv_down_kernel(const int* __restrict__ dp, const int* __restrict__ rinvp,
                   int* __restrict__ outp, int M) {
    __shared__ InvTree tree;
    const int t = threadIdx.x;
    uint32_t x[4][FQ_WORDS], alo[FQ_WORDS], ahi[FQ_WORDS];
    tile_load(x, dp, M);
    tile_tree_up(tree, x, alo, ahi);
    if (t == 0) {
        uint32_t r[FQ_WORDS];
        fq_load(r, rinvp, gridDim.x, blockIdx.x);
        tree_put(tree, 1, r);
    }
    __syncthreads();
#pragma unroll 1
    for (int w = 1; w < INV_THREADS; w <<= 1) {
        if (t < w) {
            uint32_t iv[FQ_WORDS], lo[FQ_WORDS], hi[FQ_WORDS], nlo[FQ_WORDS];
            tree_get(iv, tree, w + t);
            tree_get(lo, tree, 2 * w + t);
            tree_get(hi, tree, 3 * w + t);
            fq_mul(nlo, iv, hi);
            fq_mul(hi, iv, lo);
            tree_put(tree, 2 * w + t, nlo);
            tree_put(tree, 3 * w + t, hi);
        }
        __syncthreads();
    }
    uint32_t ib[FQ_WORDS], ia[FQ_WORDS], o[FQ_WORDS];
    const long base = (long)blockIdx.x * INV_TILE + t;
    tree_get(ib, tree, INV_THREADS + t);            // 1 / b
    fq_mul(ia, ib, ahi);                            // 1 / a_lo
    fq_mul(o, ia, x[2]);
    if (base < M) fq_store(outp, M, base, o);
    fq_mul(o, ia, x[0]);
    if (base + 2 * INV_THREADS < M) fq_store(outp, M, base + 2 * INV_THREADS, o);
    fq_mul(ia, ib, alo);                            // 1 / a_hi
    fq_mul(o, ia, x[3]);
    if (base + INV_THREADS < M) fq_store(outp, M, base + INV_THREADS, o);
    fq_mul(o, ia, x[1]);
    if (base + 3 * INV_THREADS < M) fq_store(outp, M, base + 3 * INV_THREADS, o);
}

// ---------------------------------------------------------------------------
// fq_fermat: the inverse at the root of the tree, Montgomery in and out,
// one thread per lane (<= 128 lanes in the tree; any width is accepted).
// The name is the JAX package's (_build_fermat, a 4-bit-window ladder of
// ~475 products); the body is the safegcd of fq_inv.cuh: 37 batches of 30
// divsteps, each batch a 2x2 matrix applied to f, g, d, e (about 130 wide
// multiply-adds). A ladder is one chain of ~554 dependent 12-word products,
// bound by their latency on a single block; this chain is about 37 x 30
// short divsteps plus 37 limb updates whose multiply-adds are independent
// of one another.
//
// Bound: the safegcd's own work, 37 x 130 wide multiply-adds a lane (9620
// instructions, counting each as two); chip_smoke.py keeps the ladder's 554
// products a lane, the reference's algorithm, as `ladder_bound_ms`. Its SASS
// has 1203 instructions a batch, 44,984 a lane in all
// (scripts/torch_sass_count.py).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fq_fermat_kernel(const int* __restrict__ xp, int* __restrict__ outp, int M) {
    long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    uint32_t x[FQ_WORDS], r[FQ_WORDS];
    fq_load(x, xp, M, m);
    fq_inv_safegcd(r, x);
    fq_store(outp, M, m, r);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static inline unsigned blocks_for(int M) { return (unsigned)((M + THREADS - 1) / THREADS); }
static inline unsigned fqm_blocks(int M) {
    return (unsigned)((M + FQM_THREADS * FQM_LANES - 1) / (FQM_THREADS * FQM_LANES));
}

extern "C" int fq_mul_launch(const int* a, const int* b, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_mul_kernel<<<fqm_blocks(M), FQM_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M);
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
    fq_apply_kernel<<<(unsigned)((M + FQA_LANES - 1) / FQA_LANES), FQA_LANES, 0,
                      (cudaStream_t)stream>>>(x1, y1, inf1, x2, y2, sign, cs, num, inv, ox, oy,
                                              oinf, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_fermat_launch(const int* x, int* out, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_fermat_kernel<<<blocks_for(M), THREADS, 0, (cudaStream_t)stream>>>(x, out, M);
    return (int)cudaGetLastError();
}

static inline unsigned tiles_for(int M) { return (unsigned)((M + INV_TILE - 1) / INV_TILE); }

extern "C" int fq_inv_up_launch(const int* d, int* roots, int M, void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_inv_up_kernel<<<tiles_for(M), INV_THREADS, 0, (cudaStream_t)stream>>>(d, roots, M);
    return (int)cudaGetLastError();
}

extern "C" int fq_inv_down_launch(const int* d, const int* rinv, int* out, int M,
                                  void* stream) {
    if (M <= 0) return (int)cudaSuccess;
    fq_inv_down_kernel<<<tiles_for(M), INV_THREADS, 0, (cudaStream_t)stream>>>(d, rinv, out, M);
    return (int)cudaGetLastError();
}
