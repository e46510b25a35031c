// fr_poly: the BN254 Fr polynomial kernels of the fflonk prover
// (ops/fr_poly.py; snark/fflonk.py drives them):
//
//   fr_eval          p(x) at up to EVAL_POINTS points: one launch a level,
//                    a thread a segment of EVAL_SEG coefficients by Horner;
//                    the segments' values are the next level's polynomial,
//                    evaluated at x^EVAL_SEG, down to one value.
//   fr_div_binomial  the quotient of p by X^k - c and its remainder.  With
//                    u_j = p_{j+k}, the quotient is y_j = u_j + c y_{j+k}
//                    (y_j = 0 past its end), k interleaved chains.
//                    k <= LIN_MAX_K: one launch, a single-pass scan with a
//                    decoupled look-back (Merrill and Garland) from the top
//                    index down (div_lookback); k > LIN_MAX_K (X^n - 1):
//                    one thread a chain, its suffix in registers
//                    (div_chain), with the remainder.
//   fr_scan_mul      prefix products, inclusive or exclusive, of a vector
//                    or of one value repeated (the powers x^i): a block
//                    scan with a carried prefix (scan_level, two launches a
//                    level).
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
//     (the wrapper zeroes the status scratch); a look-back that finds no
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

#define PW_THREADS 128           // threads a block of fr_eval, fr_scan_mul
#define EVAL_POINTS 4            // points a fr_eval launch takes
#define EVAL_SEG 32              // coefficients a fr_eval thread sums
#define SCAN_SEG 16              // values a fr_scan_mul thread multiplies
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

// The Montgomery products of fr_div_binomial and fr_pointwise go through
// one call: bn254.cuh's mont_mul inlined at every product makes these
// kernels' code too large for the instruction cache (the note above).
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

// -- fr_eval ----------------------------------------------------------------

struct EvalArgs {
  uint32_t x[EVAL_POINTS][8];    // the points, Montgomery form
};

// out[j segs + s] = sum_{i < EVAL_SEG} p_j[s EVAL_SEG + i] x_j^i, p_j the
// row j (`row` values apart; 0: one polynomial for every point) of n values
template <int M>
__global__ void __launch_bounds__(PW_THREADS)
eval_level(const uint32_t* __restrict__ p, int64_t row, int64_t n,
           int64_t segs, EvalArgs a, uint32_t* __restrict__ out) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= segs) return;
  const int64_t lo = s * EVAL_SEG;
  const int64_t hi = lo + EVAL_SEG < n ? lo + EVAL_SEG : n;
  uint32_t acc[M][8];
#pragma unroll
  for (int j = 0; j < M; j++) set8(acc[j], 0);
  for (int64_t i = hi - 1; i >= lo; i--) {
#pragma unroll
    for (int j = 0; j < M; j++) {
      uint32_t c[8], t[8];
      ld8(c, p + (j * row + i) * 8);
      fr_mul(t, acc[j], a.x[j]);
      fr_add(acc[j], t, c);
    }
  }
#pragma unroll
  for (int j = 0; j < M; j++) st8(out + (j * segs + s) * 8, acc[j]);
}

// -- fr_scan_mul ------------------------------------------------------------

// Segment s of SCAN_SEG values of x (`xstride` 0: x[0] repeated).  With
// `out` null: totals[s] = their product.  Else out[i] = carry[s] times the
// product of the segment's values up to i (inclusive) or before it.
__global__ void __launch_bounds__(PW_THREADS)
scan_level(const uint32_t* __restrict__ x, int64_t xstride, int64_t n,
           int64_t segs, const uint32_t* __restrict__ carry,
           uint32_t* __restrict__ out, uint32_t* __restrict__ totals,
           int exclusive) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= segs) return;
  const int64_t lo = s * SCAN_SEG;
  const int64_t hi = lo + SCAN_SEG < n ? lo + SCAN_SEG : n;
  uint32_t r2[8], acc[8], xm[8], t[8];
  FrMod::r2(r2);
  if (carry != nullptr) {
    ld8(acc, carry + s * 8);
  } else {
    set8(acc, 1);
  }
  if (xstride == 0) {
    ld8(t, x);
    fr_mul(xm, t, r2);                 // x 2^256: the product acc x
  }
  for (int64_t i = lo; i < hi; i++) {
    if (xstride != 0) {
      ld8(t, x + i * 8);
      fr_mul(xm, t, r2);
    }
    if (out != nullptr && exclusive) st8(out + i * 8, acc);
    fr_mul(acc, acc, xm);
    if (out != nullptr && !exclusive) st8(out + i * 8, acc);
  }
  if (totals != nullptr) st8(totals + s * 8, acc);
}

// -- fr_div_binomial ----------------------------------------------------------

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

// c's powers, Montgomery form (host-computed; ops/fr_poly._lb_powers)
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

// L2 loads and stores of the status words other blocks write and read
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

// y = x + c^L y' composes a run below (aggregate x) with the one above it
// (y'): lin_step with the power of the lower run's length
template <bool ONE>
__device__ __forceinline__ void compose(uint32_t y[8], const uint32_t x[8],
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

// o = x of the lane d above in the group of `width` lanes
__device__ __forceinline__ void shfl_down8(uint32_t o[8], const uint32_t x[8],
                                           int d, int width) {
#pragma unroll
  for (int w = 0; w < 8; w++)
    o[w] = __shfl_down_sync(0xffffffffu, x[w], d, width);
}

// A lead warp: the carries into tile t of its CW chains r0.., the
// inclusive prefixes of tile t + 1 (its true lowest values), from the
// tiles above: a window of LB_WINDOW tiles a poll, lane d reading tile
// t + 1 + d's flag (past the top: an inclusive prefix of 0).  Once every
// tile up to the window's first inclusive prefix has at least its
// aggregate, each carry takes sum_d c^(TS d) X_d (X the aggregates, then
// that prefix); with none, the whole window and the next.  The lanes of
// group h (GL lanes) end with chain r0 + h's carry.
template <int K, bool ONE>
__device__ void look_back(int64_t t, int64_t tiles, int r0,
                          const uint32_t* flags, const uint32_t* agg,
                          const uint32_t* inc, const LbPowers& pw,
                          uint32_t C[8]) {
  using L = Lb<K>;
  const int lane = threadIdx.x & 31;
  uint32_t mult[8];                       // c^(TS LB_WINDOW w), Montgomery
  cp8(mult, pw.tile[0]);
  set8(C, 0);
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
        if (!ONE) pmul(x, x, pw.tile[lane]);
      } else {
        set8(x, 0);
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
#pragma unroll
        for (int w = 0; w < 8; w++)
          o[w] = __shfl_xor_sync(0xffffffffu, x[w], d);
        fr_add(x, x, o);
      }
      if (!ONE) pmul(x, x, mult);
      if (lane / L::GL == h) fr_add(C, C, x);
    }
    if (first < 32) break;
    base += LB_WINDOW;
    if (!ONE) pmul(mult, mult, pw.tile[LB_WINDOW]);
  }
}

// y_j = u_j + c y_{j+K} over j < m (y = 0 past m) in one pass.  status
// (zeroed): word 0 the ticket, then a flag a tile (0 none, 1 aggregate, 2
// inclusive prefix; padded to 4 words), then each tile's K aggregates,
// then its K inclusive prefixes.  A tile's aggregate of chain r is its
// lowest value of chain r with no carry; with the carry C_r (the tile
// above's inclusive prefix) the true value is aggregate + c^TS C_r.
template <int K, bool ONE>
__global__ void __launch_bounds__(Lb<K>::THREADS, LB_MIN_BLOCKS)
div_lookback(const uint32_t* __restrict__ u, int64_t m, int64_t tiles,
             const __grid_constant__ LbPowers pw, uint32_t* status,
             uint32_t* __restrict__ q) {
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
  if (!ONE) {
    const uint32_t* src = &pw.c[0];
    uint32_t* dst = &spw.c[0];
    for (int w = tid; w < (int)(sizeof(LbPowers) / 4); w += L::THREADS)
      dst[w] = src[w];
  }
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t lo = t * L::TV;

  // the tile, coalesced: 16 bytes a thread, zeros past m
  {
    const uint4* src = reinterpret_cast<const uint4*>(u) + 2 * lo;
    for (int c = tid; c < 2 * L::TV; c += L::THREADS) {
      const int pos = c >> 1;
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
          sm + c + pos / L::SEG);
      const bool in = lo + pos < m;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(dst), "l"(in ? src + c : src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();

  // the run's aggregate, its lowest value with no carry: sum_i c^i u_i,
  // S full products summed in 512 bits (< S r^2) and reduced once
  const int first = g * L::S;                // the run's lowest step
  uint32_t acc[8], v[8], tmp[8];
  if (ONE) {
    set8(acc, 0);
#pragma unroll 4
    for (int i = 0; i < L::S; i++) {
      lds8<L::SEG>(v, sm, (first + i) * K + r);
      fr_add(acc, acc, v);
    }
  } else {
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
    if (lane + d < L::GL) compose<ONE>(acc, acc, tmp, spw.lane[d]);
  }
  uint32_t ex[8];                            // lanes l + 1..GL - 1
  shfl_down8(ex, acc, 1, L::GL);
  if (lane == L::GL - 1) set8(ex, 0);
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
      compose<ONE>(A, s_wtot[r][w], A, spw.warp[1]);
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
      set8(C, 0);
    } else {
      look_back<K, ONE>(t, tiles, r - r % L::CW, flags, agg, inc, spw,
                        C);
    }
    if (lane == 0) {
      compose<ONE>(tmp, A, C, spw.tile[1]);
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
  for (int w = L::WC - 1; w > wi; w--) compose<ONE>(y, s_wtot[r][w], y,
                                                    spw.warp[1]);
  // the run's carry: lanes above it in the group, then the group's
  compose<ONE>(y, ex, y, spw.lane[L::GL - 1 - lane]);
  // every y_j once, with its carry, back into the tile
#pragma unroll 4
  for (int i = L::S - 1; i >= 0; i--) {
    const int pos = (first + i) * K + r;
    lds8<L::SEG>(v, sm, pos);
    lin_step<ONE>(y, v, spw.c);
    sts8<L::SEG>(sm, pos, y);
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(q) + 2 * lo;
  for (int c = tid; c < 2 * L::TV; c += L::THREADS) {
    const int pos = c >> 1;
    if (lo + pos < m) dst[c] = sm[c + pos / L::SEG];
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

// one div_lookback launch over the m values of u (k <= LIN_MAX_K): pw the
// LbPowers words in host memory, status zeroed device scratch of
// status_bytes (fr_poly._lb_status_words)
template <int K, bool ONE>
static int lookback_launch(const uint32_t* u, int64_t m, const void* pw,
                           uint32_t* status, int64_t status_bytes,
                           uint32_t* q, cudaStream_t st) {
  using L = Lb<K>;
  const int64_t tiles = (m + L::TV - 1) / L::TV;
  const int64_t words = 4 + ((tiles + 3) & ~3LL) + 16LL * K * tiles;
  if (status_bytes < 4 * words || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        div_lookback<K, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  LbPowers p;
  memcpy(&p, pw, sizeof(LbPowers));
  div_lookback<K, ONE><<<(unsigned)tiles, L::THREADS, L::SMEM, st>>>(
      u, m, tiles, p, status, q);
  return (int)cudaGetLastError();
}

extern "C" {

// out (m x segs values) = eval_level over p; xs: m points, 8 words each,
// Montgomery form, in host memory
int fr_eval_launch(const void* p, int64_t row, int64_t n, int m,
                   const void* xs, void* out, int64_t segs, void* stream) {
  if (m < 1 || m > EVAL_POINTS || segs < 1) return (int)cudaErrorInvalidValue;
  EvalArgs a;
  for (int j = 0; j < m; j++) copy_words(a.x[j], (const uint32_t*)xs + 8 * j);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pp = (const uint32_t*)p;
  uint32_t* o = (uint32_t*)out;
  switch (m) {
    case 1: eval_level<1><<<blocks_for(segs), PW_THREADS, 0, st>>>(
        pp, row, n, segs, a, o); break;
    case 2: eval_level<2><<<blocks_for(segs), PW_THREADS, 0, st>>>(
        pp, row, n, segs, a, o); break;
    case 3: eval_level<3><<<blocks_for(segs), PW_THREADS, 0, st>>>(
        pp, row, n, segs, a, o); break;
    default: eval_level<4><<<blocks_for(segs), PW_THREADS, 0, st>>>(
        pp, row, n, segs, a, o); break;
  }
  return (int)cudaGetLastError();
}

// one scan_level launch (out null: the totals pass)
int fr_scan_mul_launch(const void* x, int64_t xstride, int64_t n,
                       int64_t segs, const void* carry, void* out,
                       void* totals, int exclusive, void* stream) {
  if (segs < 1) return (int)cudaErrorInvalidValue;
  scan_level<<<blocks_for(segs), PW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, xstride, n, segs, (const uint32_t*)carry,
      (uint32_t*)out, (uint32_t*)totals, exclusive);
  return (int)cudaGetLastError();
}

int fr_div_lookback_launch(const void* u, int64_t m, int k, int one,
                           const void* pw, void* status,
                           int64_t status_bytes, void* q, void* stream) {
  if (k < 1 || k > LIN_MAX_K || m < 1) return (int)cudaErrorInvalidValue;
  const uint32_t* uu = (const uint32_t*)u;
  uint32_t* s = (uint32_t*)status;
  uint32_t* o = (uint32_t*)q;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define LB_CASE(K)                                                        \
    case K: return one ? lookback_launch<K, true>(uu, m, pw, s,           \
                                                  status_bytes, o, st)    \
                       : lookback_launch<K, false>(uu, m, pw, s,          \
                                                   status_bytes, o, st);
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
