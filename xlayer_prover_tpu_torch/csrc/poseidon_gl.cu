// poseidon_permute and poseidon_linear_hash: the Poseidon-Goldilocks t=12
// permutation (8 full + 22 partial rounds, x^7 S-box, 12x12 MDS) over a
// batch of states, and the Merkle leaf sponge built on it, which also
// hashes every tree level (a node is the linear hash of the 8-word row
// left || right).
//
// Replaces: xlayer_prover_tpu/ops/pallas_poseidon.py:_kernel (via permute,
// the pl.pallas_call at :251) with poseidon_permute; the jnp sponge and
// level loop xlayer_prover_tpu/ops/poseidon_gl.py:153 linear_hash, :175
// hash_node, driven by xlayer_prover_tpu/ops/merkle.py:42 _build_levels,
// with poseidon_linear_hash.  The TPU kernel held each lane as a u32
// (lo, hi) pair and built products from 16-bit halves, because Mosaic has
// no 64-bit lanes.  Hopper has native 64-bit integer lanes.
//
// Bound: integer multiply issue, not memory.  A permutation reads and
// writes 192 bytes (0.06 ms for 2^20 states at 3.35 TB/s).  Its
// fewest-multiply form needs 6,112 32-bit multiplies (counted by
// chip_smoke.py:poseidon_mul32): 0.383 ms for 2^20 states at 64 a clock
// an SM, the bound chip_smoke.py reports.  On an H100 a 32x32->64
// IMAD.WIDE.U32 (and an IMAD.HI) issues at half that rate, ~27 (~29) a
// clock an SM against ~63 for a 32-bit IMAD (poseidon_variants.py).  The
// SASS of the shipped variant issues, per permutation, 4,919
// IMAD.WIDE.U32 and 472 IMAD.HI.U32 among 13,002 instructions on the
// IMAD pipe (ptxas also puts moves and adds there), 2,016 DFMA, and
// 30,974 instructions in all: that pipe binds (PERF.md).
//
// Design, against that bound:
//  * Sparse partial rounds (ops/poseidon_constants.py:sparse_form): each
//    partial round is one lane-0 S-box, out_j = s_j + s_0 v_j (11
//    products) and out_0 = s_0 m00 + sum s_i w_hat_i, instead of a
//    144-product MDS.  Full round 4 multiplies by the dense matrix `pre`.
//  * A dot product by constants runs on 22-bit limbs (Cols below): one
//    IMAD.WIDE.U32 a partial product into three 64-bit columns, no
//    carries, one fold and reduction at the end.  out_0's terms of
//    s_1..s_11 do not wait for the S-box, so they overlap its chain.
//  * The other 7 full rounds keep the MDS (entries < 2^16, checked when
//    the table is packed): the products of 32-bit halves with its entries
//    sum exactly in doubles (below 2^52) as DFMAs on the otherwise idle
//    FP64 pipe, each S-box output summed as soon as it is made.  The next
//    round's constants start those sums (and the dot products' columns),
//    so the round-constant additions cost nothing.
//  * Intermediates stay non-canonical (gl.cuh `_nc`, PTX carry chains, no
//    compares): every step accepts any 64-bit pattern, and each output
//    lane is made canonical once.  The first step adds full_c[0] = the
//    original c[0], so inputs of any 64-bit pattern reduce as in the dense
//    form; outputs are bit-equal to _permute_plain.
//  * One thread per state (or S interleaved states), the state in
//    registers, the 3,548 constant words (13.9 KB) in __constant__ memory:
//    every thread of a warp reads the same word, which the constant cache
//    broadcasts.
//  * poseidon_linear_hash keeps the 4-word capacity in registers across a
//    row's 8-word chunks (the last one zero-padded) and writes only the
//    digest; its last MDS computes only the 4 lanes it keeps.
// The library is compiled for one launch shape (threads a block, states a
// thread, blocks an SM), the fastest of those poseidon_variants.py timed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl.cuh"

#define WIDTH 12
#define RATE 8
#define DIGEST 4
#define HALF_FULL 4
#define PARTIAL 22
#define LIMB_BITS 22
#define TERM 6  // u32 constants a dot-product term: [half of s][limb]

// A 64-bit constant w multiplies a state word s = s0 + s1 2^32 as
// s0 * w + s1 * w', w' = 2^32 w mod p, each split into three 22-bit limbs
// (the last < 2^20): six 32x22-bit products, each < 2^54, so a dot
// product of 12 terms sums in three 64-bit columns (< 2^59) with one
// IMAD.WIDE.U32 a product and no carries.  A constant to add rides in the
// columns' start values: its own three limbs.
struct PartialRound {
  uint64_t v[WIDTH - 1];
  uint32_t c0[4];                // next lane-0 constant (0 last), 3 limbs
  uint32_t w[WIDTH][TERM];       // w_hat[0..10] for s_1..s_11, then m00
};

// Layout of the table the wrapper uploads (ops/poseidon_gl.py
// kernel_constants packs the same fields in this order, as u32 words).
struct PoseidonConstants {
  uint64_t full_c[2 * HALF_FULL][WIDTH];
  uint32_t first_c[WIDTH][4];         // 3 limbs each
  uint32_t pre[WIDTH][WIDTH][TERM];   // [j][i]: pre[i][j] for out_j
  PartialRound partial[PARTIAL];
  double mds[WIDTH][WIDTH];            // M[i][j], entries < 2^16
};

__constant__ PoseidonConstants K;

__device__ __forceinline__ void sbox(uint64_t& x) {
  uint64_t x2 = gl_mul_nc(x, x);
  uint64_t x3 = gl_mul_nc(x2, x);
  uint64_t x4 = gl_mul_nc(x2, x2);
  x = gl_mul_nc(x4, x3);
}

template <int S>
__device__ __forceinline__ void sbox_all(uint64_t (&s)[S][WIDTH]) {
#pragma unroll
  for (int k = 0; k < WIDTH; k++)
#pragma unroll
    for (int q = 0; q < S; q++) sbox(s[q][k]);
}

// Three limb columns of a lazy dot product.
struct Cols {
  uint64_t c0, c1, c2;
};

__device__ __forceinline__ Cols cols_init(const uint32_t* limbs) {
  return {limbs[0], limbs[1], limbs[2]};
}

// cols += x * (the term's constant), x a 64-bit state word.
__device__ __forceinline__ void cols_mac(Cols& a, uint64_t x,
                                         const uint32_t* t) {
  uint32_t x0 = lo32(x), x1 = hi32(x);
  a.c0 += (uint64_t)x0 * t[0];
  a.c1 += (uint64_t)x0 * t[1];
  a.c2 += (uint64_t)x0 * t[2];
  a.c0 += (uint64_t)x1 * t[3];
  a.c1 += (uint64_t)x1 * t[4];
  a.c2 += (uint64_t)x1 * t[5];
}

// c0 + c1 2^22 + c2 2^44 mod p, non-canonical (< 2^104 before reducing).
__device__ __forceinline__ uint64_t cols_reduce(const Cols& a) {
  uint32_t w0, w1, w2, w3;
  asm("{\n\t.reg .u32 s0, s1, s2, t1, t2, t3;\n\t"
      "shl.b32 s0, %4, 22;\n\t"            // c1 << 22: words s0, s1, s2
      "shf.r.clamp.b32 s1, %4, %5, 10;\n\t"
      "shr.b32 s2, %5, 10;\n\t"
      "shl.b32 t1, %6, 12;\n\t"            // c2 << 44: words t1, t2, t3
      "shf.r.clamp.b32 t2, %6, %7, 20;\n\t"
      "shr.b32 t3, %7, 20;\n\t"
      "add.cc.u32 %0, %8, s0;\n\t"
      "addc.cc.u32 %1, %9, s1;\n\t"
      "addc.cc.u32 %2, s2, t2;\n\t"
      "addc.u32 %3, t3, 0;\n\t"
      "add.cc.u32 %1, %1, t1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.u32 %3, %3, 0;\n\t}"
      : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(w3)
      : "r"(lo32(a.c1)), "r"(hi32(a.c1)), "r"(lo32(a.c2)), "r"(hi32(a.c2)),
        "r"(lo32(a.c0)), "r"(hi32(a.c0)));
  return gl_reduce128_nc(pack64(w0, w1), pack64(w2, w3));
}

// lo + hi * 2^32 mod p, non-canonical, for lo, hi < 2^53.
__device__ __forceinline__ uint64_t fold_small(uint64_t lo, uint64_t hi) {
  uint64_t x = (uint64_t)hi32(hi) * GL_EPS + lo;  // < 2^54
  uint32_t r1, c;
  asm("add.cc.u32 %0, %2, %3;\n\t"
      "addc.u32 %1, %4, 0;"
      : "=r"(r1), "=r"(c) : "r"(hi32(x)), "r"(lo32(hi)), "r"(0u));
  return add_eps(lo32(x), r1, c);
}

#define TWO52 4503599627370496.0

// A 32-bit word as an exact double: 2^52 + x from its bits, less 2^52.
__device__ __forceinline__ double u32_f64(uint32_t x) {
  return __dsub_rn(__hiloint2double(0x43300000, (int)x), TWO52);
}

// An integer-valued double below 2^52 back to its integer.
__device__ __forceinline__ uint64_t f64_u64(double v) {
  double b = __dadd_rn(v, TWO52);
  return pack64((uint32_t)__double2loint(b),
                (uint32_t)__double2hiint(b) & 0xFFFFFu);
}

// Full round with the small MDS: s <- sbox(s) . M, plus full_c[next]
// when ADD_C; only lanes < OUT are written.  The products of the 32-bit
// halves of each S-box output with the MDS entries (< 2^16) sum in two
// columns below 2^52 a lane (12 x 2^32 x 2^16 + 2^32), exact in a double;
// they run as DFMAs on the FP64 pipe, which nothing else uses, instead of
// IMAD.WIDE on the busy integer multiply pipe.  The next round's constant
// starts the sums, so the round-constant addition costs nothing.  Each
// S-box output goes straight into the sums, so few S-box temporaries
// live.
template <int S, int OUT, bool ADD_C>
__device__ __forceinline__ void full_round(uint64_t (&s)[S][WIDTH], int next) {
  double lo[S][OUT], hi[S][OUT];
#pragma unroll
  for (int j = 0; j < OUT; j++) {
    uint64_t c = ADD_C ? K.full_c[next][j] : 0;
#pragma unroll
    for (int q = 0; q < S; q++) {
      lo[q][j] = u32_f64(lo32(c));
      hi[q][j] = u32_f64(hi32(c));
    }
  }
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
#pragma unroll
    for (int q = 0; q < S; q++) {
      uint64_t x = s[q][i];
      sbox(x);
      double xl = u32_f64(lo32(x)), xh = u32_f64(hi32(x));
#pragma unroll
      for (int j = 0; j < OUT; j++) {
        double m = K.mds[i][j];
        lo[q][j] = __fma_rn(xl, m, lo[q][j]);
        hi[q][j] = __fma_rn(xh, m, hi[q][j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < S; q++)
#pragma unroll
    for (int j = 0; j < OUT; j++)
      s[q][j] = fold_small(f64_u64(lo[q][j]), f64_u64(hi[q][j]));
}

// s <- s . pre + first_c (full round 4 of the sparse form).
template <int S>
__device__ __forceinline__ void mds_pre(uint64_t (&s)[S][WIDTH]) {
  uint64_t o[S][WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) {
#pragma unroll
    for (int q = 0; q < S; q++) {
      Cols a = cols_init(K.first_c[j]);
#pragma unroll
      for (int i = 0; i < WIDTH; i++) cols_mac(a, s[q][i], K.pre[j][i]);
      o[q][j] = cols_reduce(a);
    }
  }
#pragma unroll
  for (int q = 0; q < S; q++)
#pragma unroll
    for (int j = 0; j < WIDTH; j++) s[q][j] = o[q][j];
}

// Partial round k; lane 0 leaves with the next round's constant added.
// out_0's terms of s_1..s_11 do not wait for the S-box, so they go first.
template <int S>
__device__ __forceinline__ void partial_round(uint64_t (&s)[S][WIDTH], int k) {
  const PartialRound& c = K.partial[k];
  Cols a[S];
#pragma unroll
  for (int q = 0; q < S; q++) {
    a[q] = cols_init(c.c0);
#pragma unroll
    for (int i = 1; i < WIDTH; i++) cols_mac(a[q], s[q][i], c.w[i - 1]);
  }
#pragma unroll
  for (int q = 0; q < S; q++) sbox(s[q][0]);
#pragma unroll
  for (int j = 1; j < WIDTH; j++) {
#pragma unroll
    for (int q = 0; q < S; q++) {
      uint64_t lo, hi;
      gl_mul128(s[q][0], c.v[j - 1], lo, hi);
      asm("add.cc.u64 %0, %0, %2;\n\t"
          "addc.u64 %1, %1, 0;"
          : "+l"(lo), "+l"(hi) : "l"(s[q][j]));
      s[q][j] = gl_reduce128_nc(lo, hi);
    }
  }
#pragma unroll
  for (int q = 0; q < S; q++) {
    cols_mac(a[q], s[q][0], c.w[WIDTH - 1]);
    s[q][0] = cols_reduce(a[q]);
  }
}

// The permutation of S states; lanes < OUT leave canonical, the others
// undefined.
template <int S, int OUT>
__device__ __forceinline__ void permute(uint64_t (&s)[S][WIDTH]) {
#pragma unroll
  for (int q = 0; q < S; q++)
#pragma unroll
    for (int k = 0; k < WIDTH; k++)
      s[q][k] = gl_add_nc(s[q][k], K.full_c[0][k]);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL - 1; r++) full_round<S, WIDTH, true>(s, r + 1);
  sbox_all(s);
  mds_pre(s);
#pragma unroll 1
  for (int k = 0; k < PARTIAL; k++) partial_round(s, k);
#pragma unroll
  for (int q = 0; q < S; q++)
#pragma unroll
    for (int k = 0; k < WIDTH; k++)
      s[q][k] = gl_add_nc(s[q][k], K.full_c[HALF_FULL][k]);
#pragma unroll 1
  for (int r = HALF_FULL; r < 2 * HALF_FULL - 1; r++)
    full_round<S, WIDTH, true>(s, r + 1);
  full_round<S, OUT, false>(s, 0);
#pragma unroll
  for (int q = 0; q < S; q++)
#pragma unroll
    for (int k = 0; k < OUT; k++) s[q][k] = gl_canonical(s[q][k]);
}

// Launch shape: T threads a block, S states a thread, at least B blocks an
// SM (the register cap: 65,536 / (T * B) registers, at most 255).  The
// defaults are the fastest on an H100 for both kernels (PERF.md);
// poseidon_variants.py builds others with -D flags to time them.
#ifndef POSEIDON_THREADS
#define POSEIDON_THREADS 256
#endif
#ifndef POSEIDON_STATES
#define POSEIDON_STATES 1
#endif
#ifndef POSEIDON_MIN_BLOCKS
#define POSEIDON_MIN_BLOCKS 2
#endif
constexpr int kThreads = POSEIDON_THREADS;
constexpr int kStates = POSEIDON_STATES;
constexpr int kPerBlock = kThreads * kStates;

// State t of the batch: block b, thread x, slot q -> b * T * S + q * T + x.
__global__ void __launch_bounds__(kThreads, POSEIDON_MIN_BLOCKS)
    poseidon_permute_kernel(const uint64_t* __restrict__ in,
                            uint64_t* __restrict__ out, int64_t n) {
  int64_t base = (int64_t)blockIdx.x * kPerBlock + threadIdx.x;
  uint64_t s[kStates][WIDTH];
#pragma unroll
  for (int q = 0; q < kStates; q++) {
    int64_t t = base + (int64_t)q * kThreads;
#pragma unroll
    for (int k = 0; k < WIDTH; k++) s[q][k] = t < n ? in[t * WIDTH + k] : 0;
  }
  permute<kStates, WIDTH>(s);
#pragma unroll
  for (int q = 0; q < kStates; q++) {
    int64_t t = base + (int64_t)q * kThreads;
    if (t < n) {
#pragma unroll
      for (int k = 0; k < WIDTH; k++) out[t * WIDTH + k] = s[q][k];
    }
  }
}

// (n, width) rows -> (n, 4) digests; width > 4 (the wrapper pads
// narrower rows without a launch).
__global__ void __launch_bounds__(kThreads, POSEIDON_MIN_BLOCKS)
    poseidon_linear_hash_kernel(const uint64_t* __restrict__ rows,
                                uint64_t* __restrict__ out, int64_t n,
                                int width) {
  int64_t base = (int64_t)blockIdx.x * kPerBlock + threadIdx.x;
  uint64_t s[kStates][WIDTH];
#pragma unroll
  for (int q = 0; q < kStates; q++)
#pragma unroll
    for (int k = RATE; k < WIDTH; k++) s[q][k] = 0;
#pragma unroll 1
  for (int start = 0; start < width; start += RATE) {
#pragma unroll
    for (int q = 0; q < kStates; q++) {
      int64_t t = base + (int64_t)q * kThreads;
      const uint64_t* row = rows + (t < n ? t : 0) * width + start;
#pragma unroll
      for (int k = 0; k < RATE; k++)
        s[q][k] = (t < n && start + k < width) ? row[k] : 0;
    }
    permute<kStates, DIGEST>(s);
#pragma unroll
    for (int q = 0; q < kStates; q++)
#pragma unroll
      for (int k = 0; k < DIGEST; k++) s[q][RATE + k] = s[q][k];
  }
#pragma unroll
  for (int q = 0; q < kStates; q++) {
    int64_t t = base + (int64_t)q * kThreads;
    if (t < n) {
#pragma unroll
      for (int k = 0; k < DIGEST; k++) out[t * DIGEST + k] = s[q][RATE + k];
    }
  }
}

// Host pointer to the packed table of n_words 32-bit words (its size).
extern "C" int poseidon_set_constants(const uint32_t* table, int64_t n_words) {
  if (n_words * (int64_t)sizeof(uint32_t) != (int64_t)sizeof(PoseidonConstants))
    return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(K, table, sizeof(PoseidonConstants));
}

extern "C" int poseidon_permute_launch(const void* in, void* out, int64_t n,
                                       void* stream) {
  int64_t blocks = (n + kPerBlock - 1) / kPerBlock;
  poseidon_permute_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>((const uint64_t*)in,
                                                    (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_linear_hash_launch(const void* rows, void* out,
                                           int64_t n, int width,
                                           void* stream) {
  int64_t blocks = (n + kPerBlock - 1) / kPerBlock;
  poseidon_linear_hash_kernel<<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const uint64_t*)rows, (uint64_t*)out, n, width);
  return (int)cudaGetLastError();
}
