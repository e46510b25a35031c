// fr_poly: the BN254 Fr polynomial kernels of the fflonk prover
// (ops/fr_poly.py; snark/fflonk.py drives them):
//
//   fr_eval          p(x) at up to EVAL_POINTS points in one pass over p
//                    (eval_pass), then one block over its blocks' values
//                    (eval_pass again, at x^(EVAL_THREADS EVAL_SEG)): two
//                    launches a call of up to EVAL_POINTS points.
//   fr_div_binomial  the quotient of p by X^k - c and its remainder.  With
//                    u_j = p_{j+k}, the quotient is y_j = u_j + c y_{j+k}
//                    (y_j = 0 past its end), k interleaved chains.
//                    k <= LIN_MAX_K: one launch, a single-pass scan with a
//                    decoupled look-back (Merrill and Garland) from the top
//                    index down (lookback_scan over Lin); k > LIN_MAX_K
//                    (X^n - 1): one thread a chain, its suffix in registers
//                    (div_chain), with the remainder.
//   fr_scan_mul      prefix or suffix products, inclusive or exclusive, of
//                    a vector: the same single-pass look-back over Mul
//                    (one launch); of one value repeated, init x^i: one
//                    product of two tables a value (pow_values), the
//                    tables built by doubling in a launch before it
//                    (pow_tables).
//   fr_pointwise     one fused elementwise pass per identity, a value a
//                    thread: a linear combination of up to PW_INPUTS
//                    vectors of their own lengths, a product, the PLONK
//                    gate, the permutation's numerator and denominator,
//                    T2's numerator.
//
// Replaces: the JAX package's host Python of its fflonk prover,
// xlayer_prover_tpu/snark/fflonk.py (peval :88, pdiv_zh :95, pdivmod :107
// by binomials, the products of :210-212, :226-229, :285-287, :123 and
// :326-334, the pmul / padd chains of :306-311 and :339-347).  There is no
// TPU kernel of these functions: the JAX package runs them on the host.
//
// Every tensor holds canonical little-endian Fr values, eight 32-bit words
// (ops/bn254_mont.to_words).  Constants come as kernel parameters, most in
// Montgomery form (c 2^256 mod r), whose Montgomery product with a
// canonical value is the canonical product (bn254.cuh); each launcher says
// which form it takes.  A Montgomery product is 264 32-bit multiplies
// (a 128-multiply full product and a 136-multiply reduction); each value
// is a 32-byte sector read or written whole.
//
// What bounds them, and what the designs do about it (times: H100 80GB
// HBM3, 700 W, xlayer_prover_tpu_torch/fr_poly_times.py and chip_smoke.py
// phase 13 (a); PERF.md has them all):
//
//   Products.  A Montgomery product is one dependent carry chain of ~300
//     instructions.  Inlined at every product, these kernels' code
//     outgrew the instruction cache (the look-back at 9n: 15.2 ms
//     inlined, 8.5 ms with the same design through a call), so the
//     products here go through one non-inlined call (fr_mul_call).  Two
//     chains interleaved in a thread measured slower, not faster (10.8
//     against 7.2 ms), and tighter register caps changed nothing: the
//     identities run at ~50% of the booked 64 multiplies a clock an SM.
//   fr_eval: the function needs a full product a coefficient a point
//     (FR_PROD32, 128 multiplies) and one reduction a point; Horner takes
//     a reduced product (264) a coefficient a point.  Here a thread sums
//     EVAL_SEG coefficients times x^(EVAL_THREADS j) and its running value
//     times x^(EVAL_THREADS EVAL_SEG G) as full products in 512 bits and
//     reduces once: (EVAL_SEG + 1) 128 + 136 multiplies a tile, ~145 a
//     coefficient a point.  A warp's lanes read 32 neighbouring values (1
//     KB) each segment step; the points of a call share one pass over p
//     (the later points' reads hit the caches), up to EVAL_POINTS, so C0's
//     8 points read its 2.1 GB once.  The grid is persistent (the blocks
//     the card holds at once, fr_eval_occupancy), each block Horner over
//     its tiles; the block's values are a polynomial in x^(EVAL_THREADS
//     EVAL_SEG), which one block of the same kernel evaluates: two
//     launches a call, the x^(2^b) host-computed (a few squarings a
//     point) and the segment table doubled in shared memory.  The reduced
//     products here are few (a tile's one a point, the block's sum) and
//     inlined, so the hot loop is one full product and a 512-bit
//     addition.  The points' running values stay in local memory and the
//     points' loop is not unrolled: unrolled, the code of 8 points outgrew
//     the instruction cache (C0's 8 points 18.1-18.5 ms, slower than two
//     passes of 4 of the Horner kernel before it; one copy, 9.8-9.9 ms).
//   fr_scan_mul, one value repeated: out_i = init x^i needs a product a
//     value.  e = i + off splits as hi 2^L + lo: out_i is lo[lo] times
//     hi[hi] (x^lo canonical, init x^(2^L hi) Montgomery form), one
//     product, a value a thread, a warp's outputs contiguous.  The tables
//     (2^L and ~n / 2^L values, L about half of log2 n) are built on the
//     card by doubling, a block each, in the launch before: x is read on
//     the card, and no host loop of products enters the call.
//   fr_scan_mul, a vector: prefix (or suffix) products are the look-back
//     scan of fr_div_binomial with the product as its composition (Mul,
//     K = 1): a tile of 2048 values a block, each value converted to
//     Montgomery form (a product), a thread's run of LB_STEPS values
//     scanned from its top (a product each; the run's aggregate is its
//     product), the groups' and tiles' aggregates and carries in
//     Montgomery form, and each output the run's carry times its suffix
//     product (a product): three products a value, u read once and the
//     result written once, in one launch.  The positions are mirrored
//     (position j at index m - 1 - j) for prefix products, so the scan
//     runs from index 0 up with the same look-back.
//   fr_div_binomial, k <= LIN_MAX_K, c != 1: the sequential function needs
//     a product a value and 64 bytes (u read, y written); its bound at 9n
//     is by bytes.  A parallel linear recurrence passes over the values
//     twice (a run's aggregate with no carry, then the run again with its
//     carry): two products a value, ~2.4 ms at 9n by operations on this
//     card, against the 1.44 ms booked for the function (~1.9 here, the
//     aggregate's taken lazily).  A tile is LB_STEPS steps of each of
//     the k chains a thread: P = LB_THREADS / k threads a chain (a warp
//     at k = 3, 5, 6, 7), in groups of a warp or, at k = 8, half of one.
//     The block loads its tile once, coalesced, by cp.async into shared
//     memory padded after each thread's segment (the lanes of a group
//     fall on different banks).  A thread scans its run; the groups scan
//     their runs' aggregates by shuffles composed with c^(S d) (5 products
//     a thread, 5 / 16 a value); the groups' totals compose with
//     c^(GL S), all powers host-computed (LbPowers) and kept in shared
//     memory.  A run's aggregate, sum_i c^i u_i, is S full products
//     against c^i summed in 512 bits and reduced once: half the
//     multiplies of S - 1 chained products, and no chain.  The block
//     takes its tile from an atomic ticket, top first,
//     publishes each chain's aggregate and flag, and each chain's lead
//     group looks back over the tiles above (a warp reads LB_WINDOW
//     flags a poll, __ldcg / ld.acquire after a writer's __threadfence
//     and st.release), then publishes the inclusive prefix and writes
//     every y_j once.  u is read once and q written once, in one launch
//     (the launcher zeroes the status words first); a look-back that finds no
//     flag in LB_SPIN_LIMIT polls traps, so the launch fails.  What holds
//     it now: each thread's chain of ~25 dependent products (its carried
//     run, the scan, the carries), with 12 warps an SM (the 66 KB tile a
//     block): 6.7-7.1 ms at 9n.
//   fr_div_binomial, c = 1: additions only, bound by bytes: the look-back
//     kernel with its products compiled out (k <= LIN_MAX_K), or
//     div_chain (k > LIN_MAX_K, X^n - 1), where a thread j < k walks its
//     chain from the top with the suffix sum in registers (neighbouring j
//     on neighbouring addresses): p read once, q written once; 1.66 ms at
//     8n against a 1.28 ms bound.
//   fr_pointwise: each identity does the products that
//     chip_smoke.fr_poly_work books, and one fixing product for each
//     output's Montgomery form: a linear combination sums full products in
//     512 bits and reduces once (fewer multiplies than one product a
//     term); the gate a (qM b + qL) + qR b + qO c is three reductions of
//     full-product sums and one fix by 2^768; the permutation's domain
//     point is lo[i] times a block's beta hi[h] (one product: beta x), K1
//     beta x and K2 beta x are additions (K1 = 2, K2 = 3), each side's
//     three factors two products, each output one fix (perm_z: 10 a value
//     for its two outputs against the 9 booked; T2: z num - z(w x) den as
//     one 512-bit sum, reduced once and fixed once, ~10.5 against 11).
//     The gate and the linear combinations are bound by bytes, T2 and
//     perm_z by products.  One value a thread, PW_THREADS a block,
//     PW_MIN_BLOCKS capping the registers: measured against 2 and 4
//     values a thread and 64 or 256 threads a block, it was the fastest
//     (PERF.md: the products go through calls, so several values
//     a thread overlap no carry chains).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bn254.cuh"

#define PW_THREADS 128           // threads a block of fr_pointwise and of
                                 // fr_scan_mul's powers
#define EVAL_POINTS 8            // points a fr_eval pass takes
#define EVAL_THREADS 128         // threads a fr_eval block
#define EVAL_THREADS_LOG2 7
#define EVAL_SEG 16              // coefficients a fr_eval thread sums a
                                 // tile, EVAL_THREADS apart
#define EVAL_SQ 11               // x^(2^b), b < EVAL_SQ, a point's powers
#define EVAL_MIN_BLOCKS 4        // fr_eval blocks an SM: <= 128 registers
#define POW_SQ 32                // steps of a fr_scan_mul table (2^32)
#define POW_THREADS 512          // threads a fr_scan_mul table block
#define LIN_MAX_K 8              // the widest k of the look-back kernel
#define LB_THREADS 128           // threads a look-back block at k | 128
#define LB_STEPS 16              // chain steps a thread
#define LB_WINDOW 32             // tiles a look-back window reads
#define LB_MIN_BLOCKS 2          // blocks an SM (k = 8: <= 128 registers)
#define LB_SPIN_LIMIT (1 << 24)  // polls of a window before a trap
#define PW_INPUTS 9              // inputs of a fr_pointwise identity
#define PW_CONSTS 6              // its constants
#define PW_MIN_BLOCKS 4          // fr_pointwise blocks an SM: <= 128
                                 // registers

// look_back reads LB_WINDOW tiles a poll, lane d tile t + 1 + d and
// pw.tile[d]: the window is one warp wide
static_assert(LB_WINDOW == 32, "a look-back window is a warp's lanes");
// fr_eval: the segment table doubles from x^EVAL_THREADS by the powers
// x^(EVAL_THREADS 2^e) up to x^(EVAL_THREADS EVAL_SEG / 2); the block's
// lanes and warps combine with x^1 .. x^32
static_assert((1 << EVAL_THREADS_LOG2) == EVAL_THREADS, "EVAL_THREADS");
static_assert((EVAL_THREADS << (EVAL_SQ - 1 - EVAL_THREADS_LOG2)) * 2
                  == EVAL_THREADS * EVAL_SEG, "EVAL_SQ covers the segment");
static_assert(EVAL_THREADS == 128, "a block's four warps combine by x^32");

// fr_pointwise identities (ops/fr_poly.PW_OPS)
#define PW_LINCOMB 0
#define PW_MUL 1
#define PW_GATE 2
#define PW_PERM_Z 3
#define PW_PERM_T2 4

static inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + PW_THREADS - 1) / PW_THREADS);
}

__device__ __forceinline__ void ld8(uint32_t x[8],
                                    const uint32_t* __restrict__ p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = __ldg(q), hi = __ldg(q + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void st8(uint32_t* __restrict__ p,
                                    const uint32_t x[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(x[0], x[1], x[2], x[3]);
  q[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void set8(uint32_t x[8], uint32_t v) {
  x[0] = v;
#pragma unroll
  for (int w = 1; w < 8; w++) x[w] = 0;
}

__device__ __forceinline__ void cp8(uint32_t x[8], const uint32_t y[8]) {
#pragma unroll
  for (int w = 0; w < 8; w++) x[w] = y[w];
}

// 1 in Montgomery form: 2^256 mod r
__device__ __forceinline__ void fr_one(uint32_t x[8]) {
  x[0] = 0x4ffffffbu; x[1] = 0xac96341cu; x[2] = 0x9f60cd29u;
  x[3] = 0x36fc7695u; x[4] = 0x7879462eu; x[5] = 0x666ea36fu;
  x[6] = 0x9a07df2fu; x[7] = 0x0e0a77c1u;
}

// The Montgomery products of fr_div_binomial, fr_scan_mul's look-back and
// fr_pointwise go through one call: bn254.cuh's mont_mul inlined at every
// product makes these kernels' code too large for the instruction cache
// (the note above).
struct Fr1 {
  uint32_t w[8];
};

__device__ __noinline__ Fr1 fr_mul_call(const Fr1 a, const Fr1 b) {
  Fr1 r;
  fr_mul(r.w, a.w, b.w);
  return r;
}

// r = a b / 2^256 (r may alias a or b)
__device__ __forceinline__ void pmul(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8]) {
  Fr1 x, y;
  cp8(x.w, a);
  cp8(y.w, b);
  const Fr1 z = fr_mul_call(x, y);
  cp8(r, z.w);
}

// o = x of the lane d above in the group of `width` lanes
__device__ __forceinline__ void shfl_down8(uint32_t o[8], const uint32_t x[8],
                                           int d, int width) {
#pragma unroll
  for (int w = 0; w < 8; w++)
    o[w] = __shfl_down_sync(0xffffffffu, x[w], d, width);
}

// -- fr_eval ----------------------------------------------------------------

struct EvalArgs {
  uint32_t sq[EVAL_POINTS][EVAL_SQ][8];  // x^(2^b), Montgomery form
  uint32_t y[EVAL_POINTS][8];            // x^(EVAL_THREADS EVAL_SEG G),
                                         // Montgomery form (G blocks)
};

// Block g of G, for each of the M points x (p_m the row m, `row` values
// apart; 0: one polynomial for every point, n values):
//   out[m G + g] = sum over the block's tiles T = g + G k (EVAL_THREADS
//   EVAL_SEG values each) of x^(EVAL_THREADS EVAL_SEG G k) times
//   sum_t x^t sum_j p[T EVAL_THREADS EVAL_SEG + t + EVAL_THREADS j]
//   x^(EVAL_THREADS j),
// so that p(x) = sum_g x^(EVAL_THREADS EVAL_SEG g) out[m G + g].  Thread
// t keeps acc = sum_k (its tile k's segment) Y^k by Horner from the top
// tile: each tile's acc Y + sum_j c_j x^(EVAL_THREADS j) is EVAL_SEG + 1
// full products of canonical values summed in 512 bits (< 17 r^2) and
// reduced once.  The block then sums acc_t x^t: lanes pairwise with x^d
// (d = 1 .. 16), the warps by Horner with x^32.
__global__ void __launch_bounds__(EVAL_THREADS, EVAL_MIN_BLOCKS)
eval_pass(const uint32_t* __restrict__ p, int64_t row, int64_t n, int M,
          int64_t tiles, const __grid_constant__ EvalArgs a,
          uint32_t* __restrict__ out) {
  __shared__ uint32_t s_pj[EVAL_POINTS][EVAL_SEG][8];  // x^(EVAL_THREADS j)
  __shared__ uint32_t s_w[EVAL_POINTS][EVAL_THREADS / 32][8];  // warps' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the segment table, Montgomery form, by doubling: entries [s, 2s) are
  // entries [0, s) times x^(EVAL_THREADS s)
  if (tid < M) fr_one(s_pj[tid][0]);
  __syncthreads();
#pragma unroll 1
  for (int e = 0; (1 << e) < EVAL_SEG; e++) {
    const int s = 1 << e;
    for (int i = tid; i < M * s; i += EVAL_THREADS) {
      const int m = i / s, j = i % s;
      pmul(s_pj[m][s + j], s_pj[m][j], a.sq[m][EVAL_THREADS_LOG2 + e]);
    }
    __syncthreads();
  }
  // the points' running values in local memory: one copy of the point's
  // code (unrolled over the points, it outgrew the instruction cache)
  uint32_t acc[EVAL_POINTS][8];
#pragma unroll 1
  for (int m = 0; m < M; m++) set8(acc[m], 0);
  const int64_t G = gridDim.x;
#pragma unroll 1
  for (int64_t t = blockIdx.x + (tiles - 1 - blockIdx.x) / G * G; t >= 0;
       t -= G) {
    const int64_t base = t * (EVAL_THREADS * EVAL_SEG) + tid;
#pragma unroll 1
    for (int m = 0; m < M; m++) {
      const uint32_t* pm = p + m * row * 8;
      uint32_t s[16];
      fr_mul_wide(s, acc[m], a.y[m]);
#pragma unroll 4
      for (int j = 0; j < EVAL_SEG; j++) {
        const int64_t i = base + (int64_t)j * EVAL_THREADS;
        if (i < n) {
          uint32_t c[8];
          ld8(c, pm + i * 8);
          fr_mac_wide(s, c, s_pj[m][j]);
        }
      }
      fr_redc_wide(acc[m], s);
    }
  }
  // sum_t acc_t x^t: lane l takes lane l + d's times x^d where l is a
  // multiple of 2d, one product and one reduction with acc_l added
#pragma unroll 1
  for (int m = 0; m < M; m++) {
#pragma unroll 1
    for (int e = 0; e < 5; e++) {
      const int d = 1 << e;
      uint32_t o[8], s[16];
      shfl_down8(o, acc[m], d, 32);
      if ((lane & (2 * d - 1)) == 0) {
        fr_mul_wide(s, o, a.sq[m][e]);
        fr_redc_wide_add(acc[m], s, acc[m]);
      }
    }
    if (lane == 0) cp8(s_w[m][warp], acc[m]);
  }
  __syncthreads();
  if (tid < M) {
    uint32_t v[8], s[16];
    cp8(v, s_w[tid][EVAL_THREADS / 32 - 1]);
#pragma unroll 1
    for (int w = EVAL_THREADS / 32 - 2; w >= 0; w--) {
      fr_mul_wide(s, v, a.sq[tid][5]);             // x^32
      fr_redc_wide_add(v, s, s_w[tid][w]);
    }
    st8(out + (tid * G + blockIdx.x) * 8, v);
  }
}

// -- fr_scan_mul: one value repeated ----------------------------------------

struct PowArgs {
  uint32_t init[8];              // Montgomery form
  int lo_bits;
  int64_t hi_n;
};

// L2 loads and stores of words other threads write and read
__device__ __forceinline__ void ld8_cg(uint32_t x[8], const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = __ldcg(q), hi = __ldcg(q + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void st8_cg(uint32_t* p, const uint32_t x[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  __stcg(q, make_uint4(x[0], x[1], x[2], x[3]));
  __stcg(q + 1, make_uint4(x[4], x[5], x[6], x[7]));
}

// The two tables of x (one value on the card), a block each, by
// doubling: entries [s, 2s) are entries [0, s) times x^s of the table's
// step, the steps' x^(2^b) squared by one thread first.  Block 0: lo[k] =
// x^k canonical, k < 2^lo_bits; block 1: hi[h] = init x^(2^lo_bits h)
// Montgomery form, h < hi_n.
__global__ void __launch_bounds__(POW_THREADS)
pow_tables(const uint32_t* __restrict__ x, const __grid_constant__ PowArgs a,
           uint32_t* lo, uint32_t* hi) {
  __shared__ uint32_t s_sq[POW_SQ][8];  // the table's x^(s 2^b0)
  const bool high = blockIdx.x == 1;
  uint32_t* tab = high ? hi : lo;
  const int64_t size = high ? a.hi_n : 1LL << a.lo_bits;
  const int b0 = high ? a.lo_bits : 0;
  int steps = 0;
  while ((1LL << steps) < size) steps++;
  if (threadIdx.x == 0) {
    uint32_t v[8], r2[8];
    FrMod::r2(r2);
    ld8(v, x);
    pmul(v, v, r2);                     // x, Montgomery form
    for (int b = 0; b < b0 + steps; b++) {
      if (b >= b0) cp8(s_sq[b - b0], v);
      if (b + 1 < b0 + steps) pmul(v, v, v);
    }
    if (high) {
      cp8(v, a.init);
    } else {
      set8(v, 1);
    }
    st8_cg(tab, v);
  }
  __syncthreads();
#pragma unroll 1
  for (int e = 0; e < steps; e++) {
    const int64_t s = 1LL << e;
    for (int64_t k = threadIdx.x; k < s && s + k < size; k += POW_THREADS) {
      uint32_t v[8];
      ld8_cg(v, tab + k * 8);
      pmul(v, v, s_sq[e]);
      st8_cg(tab + (s + k) * 8, v);
    }
    __syncthreads();
  }
}

// out[i] = lo[e mod 2^lo_bits] hi[e >> lo_bits] / 2^256 = init x^e, with
// e = off + i: one product a value
__global__ void __launch_bounds__(PW_THREADS)
pow_values(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
           int lo_bits, int64_t off, int64_t n, uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * PW_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t e = off + i;
  uint32_t x[8], y[8];
  ld8(x, lo + (e & ((1LL << lo_bits) - 1)) * 8);
  ld8(y, hi + (e >> lo_bits) * 8);
  fr_mul(x, x, y);
  st8(out + i * 8, x);
}

// -- the look-back scans: fr_div_binomial (k <= LIN_MAX_K), fr_scan_mul's
// vectors ---------------------------------------------------------------------

// The look-back kernel's shape at k = K: a chain's run of S steps a
// thread, P threads a chain (LB_THREADS / K where K divides LB_THREADS,
// else a warp), in WC groups of GL lanes (a warp, or half of one at K =
// 8: two chains a warp); the k chains side by side.
template <int K>
struct Lb {
  static constexpr int P = LB_THREADS % K == 0 && LB_THREADS / K >= 16
                               ? LB_THREADS / K : 32;
  static constexpr int GL = P < 32 ? P : 32;  // lanes of a group
  static constexpr int WC = P / GL;          // groups a chain
  static constexpr int CW = 32 / GL;         // chains a warp's groups lead
  static constexpr int S = LB_STEPS;
  static constexpr int THREADS = K * P;
  static constexpr int TS = P * S;          // steps of a chain a tile
  static constexpr int TV = K * TS;         // values a tile
  static constexpr int SEG = K * S;         // values of a thread segment
  // the tile's 16-byte halves, one pad after each segment
  static constexpr int SMEM = (2 * TV + P) * 16;
};

// c's powers, Montgomery form (host-computed; ops/fr_poly._lb_powers);
// the product scan reads only c, its init
struct LbPowers {
  uint32_t c[8];
  uint32_t step[LB_STEPS][8];             // c^i, i < S
  uint32_t lane[32][8];                   // c^(S j), j < 32
  uint32_t warp[LB_THREADS / 32 + 1][8];  // c^(GL S j), j <= WC
  uint32_t tile[LB_WINDOW + 1][8];        // c^(TS d), d <= LB_WINDOW
};

struct LinArgs {
  uint32_t c[8];                 // Montgomery form
};

// The compositions a look-back scans with, of a run below (its aggregate
// x) and the one above it: Lin, y_j = u_j + c y_{j+K}: x + c^L above, cw
// = c^L Montgomery form (ONE: c = 1, additions only); Mul, y_j = u_j
// y_{j+1}: x above, every aggregate, carry and inclusive prefix in
// Montgomery form.  A window of tiles combines (Lin: the sum of the tiles
// weighed by c^(TS d); Mul: their product) and the top tile's carry is
// `top` (Lin: 0; Mul: the init).
template <bool ONE>
struct Lin {
  static constexpr bool MUL = false;
  static constexpr bool WEIGHED = !ONE;
  static constexpr bool POWERS = !ONE;
  __device__ static void identity(uint32_t y[8]) { set8(y, 0); }
  __device__ static void compose(uint32_t y[8], const uint32_t x[8],
                                 const uint32_t above[8],
                                 const uint32_t cw[8]) {
    if (ONE) {
      fr_add(y, x, above);
    } else {
      uint32_t t[8];
      pmul(t, above, cw);
      fr_add(y, x, t);
    }
  }
  __device__ static void combine(uint32_t x[8], const uint32_t o[8]) {
    fr_add(x, x, o);
  }
  __device__ static void top(uint32_t c[8], const LbPowers&) { set8(c, 0); }
};

struct Mul {
  static constexpr bool MUL = true;
  static constexpr bool WEIGHED = false;
  static constexpr bool POWERS = true;           // LbPowers.c: the init
  __device__ static void identity(uint32_t y[8]) { fr_one(y); }
  __device__ static void compose(uint32_t y[8], const uint32_t x[8],
                                 const uint32_t above[8], const uint32_t*) {
    pmul(y, x, above);
  }
  __device__ static void combine(uint32_t x[8], const uint32_t o[8]) {
    pmul(x, x, o);
  }
  __device__ static void top(uint32_t c[8], const LbPowers& pw) {
    cp8(c, pw.c);
  }
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// a value of the padded tile: position pos at 16-byte half 2 pos + pos /
// SEG (a pad after each thread segment: the lanes of a warp, SEG values
// apart, fall on different banks)
template <int SEG>
__device__ __forceinline__ void lds8(uint32_t x[8], const uint4* sm,
                                     int pos) {
  const int at = 2 * pos + pos / SEG;
  const uint4 lo = sm[at], hi = sm[at + 1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

template <int SEG>
__device__ __forceinline__ void sts8(uint4* sm, int pos, const uint32_t x[8]) {
  const int at = 2 * pos + pos / SEG;
  sm[at] = make_uint4(x[0], x[1], x[2], x[3]);
  sm[at + 1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// y = x + c y (ONE: x + y), the recurrence's step; the power cw Montgomery
template <bool ONE>
__device__ __forceinline__ void lin_step(uint32_t y[8], const uint32_t x[8],
                                         const uint32_t cw[8]) {
  if (ONE) {
    fr_add(y, y, x);
  } else {
    uint32_t t[8];
    pmul(t, y, cw);
    fr_add(y, t, x);
  }
}

// A lead warp: the carries into tile t of its CW chains r0.., the
// inclusive prefixes of tile t + 1 (its true lowest values), from the
// tiles above: a window of LB_WINDOW tiles a poll, lane d reading tile
// t + 1 + d's flag (past the top: an inclusive prefix, the identity).
// Once every tile up to the window's first inclusive prefix has at least
// its aggregate, each carry combines the window's tiles up to it (Lin:
// sum_d c^(TS d) X_d, X the aggregates, then that prefix; Mul: their
// product); with none, the whole window and the next.  The lanes of
// group h (GL lanes) end with chain r0 + h's carry.
template <int K, class Op>
__device__ void look_back(int64_t t, int64_t tiles, int r0,
                          const uint32_t* flags, const uint32_t* agg,
                          const uint32_t* inc, const LbPowers& pw,
                          uint32_t C[8]) {
  using L = Lb<K>;
  const int lane = threadIdx.x & 31;
  uint32_t mult[8];                       // c^(TS LB_WINDOW w), Montgomery
  if constexpr (Op::WEIGHED) cp8(mult, pw.tile[0]);
  Op::identity(C);
  int64_t base = t + 1;
  int spins = 0;
  while (true) {
    const int64_t at = base + lane;
    const uint32_t f = at < tiles ? ld_acquire(flags + at) : 2u;
    const unsigned b2 = __ballot_sync(0xffffffffu, f == 2);
    const unsigned b0 = __ballot_sync(0xffffffffu, f == 0);
    const int first = b2 ? __ffs(b2) - 1 : 32;
    const unsigned need = first >= 31 ? 0xffffffffu : (2u << first) - 1u;
    if (b0 & need) {
      if (++spins > LB_SPIN_LIMIT) __trap();
      __nanosleep(64);
      continue;
    }
#pragma unroll
    for (int h = 0; h < L::CW; h++) {
      uint32_t x[8], o[8];
      if (lane <= first && at < tiles) {
        ld8_cg(x, (f == 2 ? inc : agg) + (at * K + r0 + h) * 8);
        if constexpr (Op::WEIGHED) pmul(x, x, pw.tile[lane]);
      } else {
        Op::identity(x);
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
#pragma unroll
        for (int w = 0; w < 8; w++)
          o[w] = __shfl_xor_sync(0xffffffffu, x[w], d);
        Op::combine(x, o);
      }
      if constexpr (Op::WEIGHED) pmul(x, x, mult);
      if (lane / L::GL == h) Op::combine(C, x);
    }
    if (first < 32) break;
    base += LB_WINDOW;
    if constexpr (Op::WEIGHED) pmul(mult, mult, pw.tile[LB_WINDOW]);
  }
}

// One pass of the composition Op over the m values of u, from the top
// index down (REV: the positions mirrored, position j at index m - 1 -
// j, so the scan runs from index 0 up): Lin, y_j = u_j + c y_{j+K} (y = 0
// past m); Mul (K = 1), y_j = init u_j .. u_{m-1} (exclusive: u_{j+1} ..
// u_{m-1}).  status (zeroed): word 0 the ticket, then a flag a tile (0
// none, 1 aggregate, 2 inclusive prefix; padded to 4 words), then each
// tile's K aggregates, then its K inclusive prefixes.  A tile's aggregate
// of chain r is its lowest value of chain r with no carry; with the carry
// C_r (the tile above's inclusive prefix) the true value is the aggregate
// composed with C_r.
template <int K, class Op, bool REV>
__global__ void __launch_bounds__(Lb<K>::THREADS, LB_MIN_BLOCKS)
lookback_scan(const uint32_t* __restrict__ u, int64_t m, int64_t tiles,
              const __grid_constant__ LbPowers pw, uint32_t* status,
              uint32_t* __restrict__ q, int exclusive) {
  using L = Lb<K>;
  extern __shared__ uint4 sm[];
  __shared__ LbPowers spw;
  __shared__ uint32_t s_wtot[K][L::WC][8];
  __shared__ uint32_t s_carry[K][8];
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x;
  const int group = tid / L::GL, lane = tid % L::GL;
  const int r = group / L::WC;               // the thread's chain
  const int wi = group % L::WC;              // its group in the chain
  const int g = wi * L::GL + lane;           // its segment
  uint32_t* flags = status + 4;
  uint32_t* agg = flags + ((tiles + 3) & ~3LL);
  uint32_t* inc = agg + tiles * K * 8;

  if (tid == 0) s_tile = tiles - 1 - (int64_t)atomicAdd(status, 1u);
  if constexpr (Op::POWERS) {
    const uint32_t* src = &pw.c[0];
    uint32_t* dst = &spw.c[0];
    for (int w = tid; w < (int)(sizeof(LbPowers) / 4); w += L::THREADS)
      dst[w] = src[w];
  }
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t lo = t * L::TV;

  // the tile, coalesced: 16 bytes a thread, zeros past m; position j's
  // halves at 2 j (REV: 2 (m - 1 - j)) of u's 16-byte halves
  {
    const uint4* src = reinterpret_cast<const uint4*>(u);
    for (int c = tid; c < 2 * L::TV; c += L::THREADS) {
      const int pos = c >> 1;
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
          sm + c + pos / L::SEG);
      const int64_t j = lo + pos;
      const bool in = j < m;
      const int64_t at = 2 * (REV ? m - 1 - j : j) + (c & 1);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(dst), "l"(in ? src + at : src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();

  const int first = g * L::S;                // the run's lowest step
  uint32_t acc[8], v[8], tmp[8];
  if constexpr (Op::MUL) {
    // the run's suffix products in Montgomery form, each over its run's
    // values from its position up, back into the tile (positions past m
    // the identity); acc = the run's aggregate: a product to convert a
    // value, one to take it in
    uint32_t r2[8];
    FrMod::r2(r2);
    Op::identity(acc);
    bool any = false;
#pragma unroll 1
    for (int i = L::S - 1; i >= 0; i--) {
      const int pos = first + i;
      if (lo + pos < m) {
        lds8<L::SEG>(v, sm, pos);
        pmul(v, v, r2);
        if (any) {
          pmul(acc, v, acc);
        } else {
          cp8(acc, v);
          any = true;
        }
      }
      sts8<L::SEG>(sm, pos, acc);
    }
  } else if constexpr (!Op::POWERS) {
    // c = 1: the run's sum
    set8(acc, 0);
#pragma unroll 4
    for (int i = 0; i < L::S; i++) {
      lds8<L::SEG>(v, sm, (first + i) * K + r);
      fr_add(acc, acc, v);
    }
  } else {
    // the run's aggregate, its lowest value with no carry: sum_i c^i u_i,
    // S full products summed in 512 bits (< S r^2) and reduced once
    uint32_t sum[16];
#pragma unroll
    for (int w = 0; w < 16; w++) sum[w] = 0;
#pragma unroll 1
    for (int i = 0; i < L::S; i++) {
      lds8<L::SEG>(v, sm, (first + i) * K + r);
      fr_mac_wide(sum, v, spw.step[i]);
    }
    fr_redc_wide(acc, sum);
  }
  // inclusive suffix scan over the group's runs: lane l ends with the
  // aggregate of lanes l..GL - 1, (GL - l) S steps
#pragma unroll 1
  for (int d = 1; d < L::GL; d <<= 1) {
    shfl_down8(tmp, acc, d, L::GL);
    if (lane + d < L::GL) Op::compose(acc, acc, tmp, spw.lane[d]);
  }
  uint32_t ex[8];                            // lanes l + 1..GL - 1
  shfl_down8(ex, acc, 1, L::GL);
  if (lane == L::GL - 1) Op::identity(ex);
  if (lane == 0) cp8(s_wtot[r][wi], acc);
  __syncthreads();

  // chain r's lead group (its first): the tile's aggregate from the
  // groups' totals, published for every chain before the flag; the
  // look-back of its warp's chains; the inclusive prefix, published for
  // every chain before the flag
  const bool lead = wi == 0;
  const bool top = t == tiles - 1;
  uint32_t A[8];
  if (lead) {
    cp8(A, s_wtot[r][L::WC - 1]);
#pragma unroll
    for (int w = L::WC - 2; w >= 0; w--)
      Op::compose(A, s_wtot[r][w], A, spw.warp[1]);
    if (!top && lane == 0) {
      st8_cg(agg + (t * K + r) * 8, A);
      __threadfence();
    }
  }
  __syncthreads();
  if (!top && tid == 0) st_release(flags + t, 1u);
  if (lead) {
    uint32_t C[8];
    if (top) {
      Op::top(C, spw);
    } else {
      look_back<K, Op>(t, tiles, r - r % L::CW, flags, agg, inc, spw, C);
    }
    if (lane == 0) {
      Op::compose(tmp, A, C, spw.tile[1]);
      st8_cg(inc + (t * K + r) * 8, tmp);
      __threadfence();
      cp8(s_carry[r], C);
    }
  }
  __syncthreads();
  if (tid == 0) st_release(flags + t, 2u);

  // the group's carry: its chain's groups above it, then the tile's
  uint32_t y[8];
  cp8(y, s_carry[r]);
#pragma unroll
  for (int w = L::WC - 1; w > wi; w--) Op::compose(y, s_wtot[r][w], y,
                                                   spw.warp[1]);
  // the run's carry: lanes above it in the group, then the group's
  Op::compose(y, ex, y, spw.lane[L::GL - 1 - lane]);
  if constexpr (Op::MUL) {
    // each value once: the carry (canonical) times its suffix product
    // (exclusive: the one above it; the run's top: the carry)
    uint32_t one[8];
    set8(one, 1);
    pmul(y, y, one);
#pragma unroll 1
    for (int i = 0; i < L::S; i++) {
      const int pos = first + i;
      if (exclusive && i == L::S - 1) {
        cp8(v, y);
      } else {
        lds8<L::SEG>(v, sm, exclusive ? pos + 1 : pos);
        pmul(v, y, v);
      }
      sts8<L::SEG>(sm, pos, v);
    }
  } else {
    // every y_j once, with its carry, back into the tile
#pragma unroll 4
    for (int i = L::S - 1; i >= 0; i--) {
      const int pos = (first + i) * K + r;
      lds8<L::SEG>(v, sm, pos);
      lin_step<!Op::POWERS>(y, v, spw.c);
      sts8<L::SEG>(sm, pos, y);
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(q);
  for (int c = tid; c < 2 * L::TV; c += L::THREADS) {
    const int pos = c >> 1;
    const int64_t j = lo + pos;
    if (j < m) dst[2 * (REV ? m - 1 - j : j) + (c & 1)] = sm[c + pos / L::SEG];
  }
}

// q_j = sum_{t >= 1} c^(t-1) p_{j + t k} for j < n - k, and the remainder
// r_j = p_j + c q_j for j < k (q_j = 0 past n - k): thread j walks its
// chain from the top, its suffix in registers, each p read and each q
// written once
template <bool ONE>
__global__ void __launch_bounds__(PW_THREADS)
div_chain(const uint32_t* __restrict__ p, int64_t n, int64_t k, LinArgs a,
          uint32_t* __restrict__ q, uint32_t* __restrict__ r) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  uint32_t acc[8], v[8];
  set8(acc, 0);
  if (j < n - k) {
    for (int64_t i = j + ((n - k - 1 - j) / k) * k; i >= j; i -= k) {
      ld8(v, p + (i + k) * 8);
      lin_step<ONE>(acc, v, a.c);
      st8(q + i * 8, acc);
    }
  }
  if (j < n) {
    ld8(v, p + j * 8);
  } else {
    set8(v, 0);
  }
  lin_step<ONE>(acc, v, a.c);
  st8(r + j * 8, acc);
}

// -- fr_pointwise -------------------------------------------------------------

struct PwArgs {
  const uint32_t* in[PW_INPUTS];
  int64_t len[PW_INPUTS];        // PW_LINCOMB: an input is 0 past its length
  uint32_t k[PW_CONSTS][8];      // the identity's constants (fr_poly.py)
  const uint32_t* dom_lo;        // the domain point w^i = lo[i mod 2^lo_bits]
  const uint32_t* dom_hi;        //   hi[i >> lo_bits] / 2^256: lo canonical,
  int lo_bits;                   //   hi Montgomery form
  int nin;
  int64_t shift;                 // PW_PERM_T2: z(w x) is z at i + shift
};

// s[0..15] += x (eight words at the bottom; the caller keeps s < 2^512)
__device__ __forceinline__ void wide_add_lo(uint32_t s[16],
                                            const uint32_t x[8]) {
  asm("add.cc.u32  %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, %23;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.cc.u32 %9, %9, 0;\n\t"
      "addc.cc.u32 %10, %10, 0;\n\t"
      "addc.cc.u32 %11, %11, 0;\n\t"
      "addc.cc.u32 %12, %12, 0;\n\t"
      "addc.cc.u32 %13, %13, 0;\n\t"
      "addc.cc.u32 %14, %14, 0;\n\t"
      "addc.u32    %15, %15, 0;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]),
        "+r"(s[10]), "+r"(s[11]), "+r"(s[12]), "+r"(s[13]), "+r"(s[14]),
        "+r"(s[15])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]));
}

// (a b + add) / 2^256 mod r, canonical: one full product, one reduction
__device__ __forceinline__ void mul_add_redc(uint32_t out[8],
                                             const uint32_t a[8],
                                             const uint32_t b[8],
                                             const uint32_t add[8]) {
  uint32_t s[16];
  fr_mul_wide(s, a, b);
  wide_add_lo(s, add);
  fr_redc_wide(out, s);
}

// Value i = blockIdx PW_THREADS + threadIdx of one identity; a value past
// n reads row 0 and is not written.  Forms: mont(a, b) = a b / 2^256;
// every input and output canonical.
template <int OP>
__global__ void __launch_bounds__(PW_THREADS, PW_MIN_BLOCKS)
pointwise(const __grid_constant__ PwArgs a, uint32_t* __restrict__ out,
          uint32_t* __restrict__ out2, int64_t n) {
  const int64_t base = (int64_t)blockIdx.x * PW_THREADS;
  const int64_t idx = base + threadIdx.x;
  const int64_t at = idx < n ? idx : 0;
  const int64_t i8 = at * 8;
  uint32_t res[8];
  if (OP == PW_LINCOMB && a.nin == 1) {
    // in_0 k_0, k_0 Montgomery form: one product
    uint32_t x[8];
    ld8(x, a.in[0] + i8);
    fr_mul(res, x, a.k[0]);
  } else if (OP == PW_LINCOMB) {
    // sum_j in_j k_j, the k_j Montgomery form: full products summed in 512
    // bits (< PW_INPUTS r^2), one reduction
    uint32_t s[16];
#pragma unroll
    for (int w = 0; w < 16; w++) s[w] = 0;
    for (int j = 0; j < a.nin; j++) {
      if (idx < a.len[j]) {
        uint32_t x[8];
        ld8(x, a.in[j] + idx * 8);
        fr_mac_wide(s, x, a.k[j]);
      }
    }
    fr_redc_wide(res, s);
  } else if (OP == PW_MUL) {
    // mont(mont(in_0, in_1), k), k[0] = k 2^512 mod r
    uint32_t x[8], y[8];
    ld8(x, a.in[0] + i8);
    ld8(y, a.in[1] + i8);
    fr_mul(res, x, y);
    fr_mul(res, res, a.k[0]);
  } else if (OP == PW_GATE) {
    // over (qM, qL, qR, qO, qC, a, b, c, pi): X = (qM b + qL) / R, Y =
    // (qR b + qO c) / R, Z = (a X + Y) / R = G' / R^2 for G' = a (qM b +
    // qL) + qR b + qO c; mont(Z, k[0] = R^3) + qC + pi
    uint32_t qm[8], ql[8], b[8], s[16], x[8], X[8], Y[8];
    ld8(qm, a.in[0] + i8);
    ld8(ql, a.in[1] + i8);
    ld8(b, a.in[6] + i8);
    mul_add_redc(X, qm, b, ql);
    ld8(qm, a.in[2] + i8);               // qR
    ld8(ql, a.in[3] + i8);               // qO
    ld8(x, a.in[7] + i8);                // c
    fr_mul_wide(s, qm, b);
    fr_mac_wide(s, ql, x);
    fr_redc_wide(Y, s);
    ld8(x, a.in[5] + i8);                // a
    mul_add_redc(res, x, X, Y);
    pmul(res, res, a.k[0]);
    ld8(x, a.in[4] + i8);                // qC
    fr_add(res, res, x);
    ld8(x, a.in[8] + i8);                // pi
    fr_add(res, res, x);
  } else {
    // PW_PERM_Z over (a, b, c, s1, s2, s3): out = numerator, out2 =
    // denominator; PW_PERM_T2 over (a, b, c, s1, s2, s3, z): out = z
    // numerator - z(w x) denominator.  k: beta (Montgomery), gamma
    // (canonical), the fix (perm_z: R^3; perm_t2: R^4).  beta x =
    // mont(lo[i], beta hi[h]), beta hi[h] Montgomery form, one a block:
    // a block's values share h (PW_THREADS divides 2^lo_bits, or the
    // domain has one h)
    __shared__ uint32_t s_bhi[8];
    if (threadIdx.x == 0) {
      uint32_t hi[8];
      ld8(hi, a.dom_hi + (base >> a.lo_bits) * 8);
      pmul(s_bhi, hi, a.k[0]);
    }
    __syncthreads();
    const int64_t mask = (1LL << a.lo_bits) - 1;
    const uint32_t* gamma = a.k[1];
    uint32_t bx[8], x[8], f[8], num[8], den[8], b2[8];
    ld8(x, a.dom_lo + (at & mask) * 8);
    pmul(bx, x, s_bhi);                  // beta x
    ld8(x, a.in[0] + i8);
    fr_add(num, x, bx);
    fr_add(num, num, gamma);
    fr_add(b2, bx, bx);                  // K1 beta x
    ld8(x, a.in[1] + i8);
    fr_add(f, x, b2);
    fr_add(f, f, gamma);
    fr_add(bx, b2, bx);                  // K2 beta x
    pmul(num, num, f);
    ld8(x, a.in[2] + i8);
    fr_add(f, x, bx);
    fr_add(f, f, gamma);
    pmul(num, num, f);                   // num / R^2
#pragma unroll
    for (int j = 0; j < 3; j++) {
      ld8(x, a.in[3 + j] + i8);
      pmul(f, x, a.k[0]);                // beta s_j
      ld8(x, a.in[j] + i8);
      fr_add(f, f, x);
      fr_add(f, f, gamma);
      if (j == 0) {
        cp8(den, f);
      } else {
        pmul(den, den, f);               // den / R^2 after j = 2
      }
    }
    if (OP == PW_PERM_Z) {
      pmul(res, num, a.k[2]);
      pmul(den, den, a.k[2]);
      if (idx < n) st8(out2 + idx * 8, den);
    } else {
      // (z num - z(w x) den) / R^3 in one 512-bit sum, fixed by R^4
      int64_t iw = at + a.shift;
      if (iw >= n) iw -= n;
      uint32_t z[8], zero[8], s[16];
      set8(zero, 0);
      fr_sub(den, zero, den);
      ld8(z, a.in[6] + i8);
      fr_mul_wide(s, z, num);
      ld8(z, a.in[6] + iw * 8);
      fr_mac_wide(s, z, den);
      fr_redc_wide(res, s);
      pmul(res, res, a.k[2]);
    }
  }
  if (idx < n) st8(out + idx * 8, res);
}

// -- launchers ----------------------------------------------------------------

static void copy_words(uint32_t dst[8], const void* src) {
  const uint32_t* s = (const uint32_t*)src;
  for (int w = 0; w < 8; w++) dst[w] = s[w];
}

// one lookback_scan launch over the m values of u, after zeroing the
// `status_bytes` of device scratch it reads its status words from
// (fr_poly._lb_status_words); p the LbPowers
template <int K, class Op, bool REV = false>
static int lookback_launch(const uint32_t* u, int64_t m, const LbPowers& p,
                           uint32_t* status, int64_t status_bytes,
                           uint32_t* q, int exclusive, cudaStream_t st) {
  using L = Lb<K>;
  const int64_t tiles = (m + L::TV - 1) / L::TV;
  const int64_t words = 4 + ((tiles + 3) & ~3LL) + 16LL * K * tiles;
  if (status_bytes < 4 * words || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        lookback_scan<K, Op, REV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaError_t e = cudaMemsetAsync(status, 0, 4 * words, st);
  if (e != cudaSuccess) return (int)e;
  lookback_scan<K, Op, REV><<<(unsigned)tiles, L::THREADS, L::SMEM, st>>>(
      u, m, tiles, p, status, q, exclusive);
  return (int)cudaGetLastError();
}

extern "C" {

// eval_pass's resident blocks an SM (its registers set them), or -1
int fr_eval_occupancy() {
  int blocks = -1;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, eval_pass, EVAL_THREADS, 0);
  return e == cudaSuccess ? blocks : -1;
}

// out (m x blocks values) = eval_pass over p at m points in `blocks`
// blocks; args: an EvalArgs in host memory (its first m points)
int fr_eval_launch(const void* p, int64_t row, int64_t n, int m,
                   const void* args, int64_t blocks, void* out,
                   void* stream) {
  const int64_t tiles = (n + EVAL_THREADS * EVAL_SEG - 1)
                        / (EVAL_THREADS * EVAL_SEG);
  if (m < 1 || m > EVAL_POINTS || n < 1 || blocks < 1 || blocks > tiles)
    return (int)cudaErrorInvalidValue;
  EvalArgs a;
  memcpy(&a, args, sizeof(EvalArgs));
  eval_pass<<<(unsigned)blocks, EVAL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, row, n, m, tiles, a, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// fr_scan_mul of one value repeated, its tables (pow_tables) of x (one
// value on the card); init: 8 words, Montgomery form, in host memory
int fr_pow_tables_launch(const void* x, const void* init, int lo_bits,
                         int64_t hi_n, void* lo, void* hi, void* stream) {
  if (lo_bits < 0 || lo_bits > POW_SQ || hi_n < 1 || hi_n > (1LL << POW_SQ))
    return (int)cudaErrorInvalidValue;
  PowArgs a;
  copy_words(a.init, init);
  a.lo_bits = lo_bits;
  a.hi_n = hi_n;
  pow_tables<<<2, POW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, a, (uint32_t*)lo, (uint32_t*)hi);
  return (int)cudaGetLastError();
}

// out (n values) = pow_values over the tables
int fr_pow_values_launch(const void* lo, const void* hi, int lo_bits,
                         int64_t off, int64_t n, void* out, void* stream) {
  if (n < 1 || lo_bits < 0) return (int)cudaErrorInvalidValue;
  pow_values<<<blocks_for(n), PW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, (const uint32_t*)hi, lo_bits, off, n,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

// fr_scan_mul of a vector: one lookback_scan<1, Mul> over the m values of
// x; init: 8 words, Montgomery form, in host memory
int fr_scan_lookback_launch(const void* x, int64_t m, const void* init,
                            int rev, int exclusive, void* status,
                            int64_t status_bytes, void* out, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  LbPowers p = {};
  copy_words(p.c, init);
  const uint32_t* xx = (const uint32_t*)x;
  uint32_t* s = (uint32_t*)status;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return rev ? lookback_launch<1, Mul, true>(xx, m, p, s, status_bytes, o,
                                             exclusive, st)
             : lookback_launch<1, Mul, false>(xx, m, p, s, status_bytes, o,
                                              exclusive, st);
}

int fr_div_lookback_launch(const void* u, int64_t m, int k, int one,
                           const void* pw, void* status,
                           int64_t status_bytes, void* q, void* stream) {
  if (k < 1 || k > LIN_MAX_K || m < 1) return (int)cudaErrorInvalidValue;
  const uint32_t* uu = (const uint32_t*)u;
  uint32_t* s = (uint32_t*)status;
  uint32_t* o = (uint32_t*)q;
  cudaStream_t st = (cudaStream_t)stream;
  LbPowers p;
  memcpy(&p, pw, sizeof(LbPowers));
  switch (k) {
#define LB_CASE(K)                                                        \
    case K: return one                                                    \
        ? lookback_launch<K, Lin<true>>(uu, m, p, s, status_bytes, o, 0,  \
                                        st)                               \
        : lookback_launch<K, Lin<false>>(uu, m, p, s, status_bytes, o, 0, \
                                         st);
    LB_CASE(1) LB_CASE(2) LB_CASE(3) LB_CASE(4)
    LB_CASE(5) LB_CASE(6) LB_CASE(7) LB_CASE(8)
#undef LB_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// q (n - k values, if positive) and r (k values) of p by X^k - c, a
// thread a chain; c: 8 words, Montgomery form, in host memory
int fr_div_chain_launch(const void* p, int64_t n, int64_t k, int one,
                        const void* c, void* q, void* r, void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  LinArgs a;
  copy_words(a.c, c);
  const unsigned b = blocks_for(k);
  cudaStream_t st = (cudaStream_t)stream;
  if (one) {
    div_chain<true><<<b, PW_THREADS, 0, st>>>(
        (const uint32_t*)p, n, k, a, (uint32_t*)q, (uint32_t*)r);
  } else {
    div_chain<false><<<b, PW_THREADS, 0, st>>>(
        (const uint32_t*)p, n, k, a, (uint32_t*)q, (uint32_t*)r);
  }
  return (int)cudaGetLastError();
}

// one fr_pointwise identity over n values: ins / lens host arrays of nin
// device pointers and lengths, ks host words of nk constants
int fr_pointwise_launch(int op, const void* ins, const void* lens, int nin,
                        const void* ks, int nk, const void* dom_lo,
                        const void* dom_hi, int lo_bits, int64_t shift,
                        void* out, void* out2, int64_t n, void* stream) {
  if (nin < 0 || nin > PW_INPUTS || nk < 0 || nk > PW_CONSTS || n < 1)
    return (int)cudaErrorInvalidValue;
  PwArgs a = {};
  for (int j = 0; j < nin; j++) {
    a.in[j] = (const uint32_t*)((const int64_t*)ins)[j];
    a.len[j] = ((const int64_t*)lens)[j];
  }
  for (int j = 0; j < nk; j++)
    copy_words(a.k[j], (const uint32_t*)ks + 8 * j);
  a.dom_lo = (const uint32_t*)dom_lo;
  a.dom_hi = (const uint32_t*)dom_hi;
  a.lo_bits = lo_bits;
  a.nin = nin;
  a.shift = shift;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned b = blocks_for(n);
  uint32_t* o = (uint32_t*)out;
  uint32_t* o2 = (uint32_t*)out2;
  switch (op) {
#define PW_CASE(OP)                                                       \
    case OP: pointwise<OP><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    PW_CASE(PW_LINCOMB) PW_CASE(PW_MUL) PW_CASE(PW_GATE)
    PW_CASE(PW_PERM_Z) PW_CASE(PW_PERM_T2)
#undef PW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
