// fr_ntt: the radix-2 NTT / INTT over BN254 Fr of n = 2^bits values,
// fr_ntt_twiddles: its twiddle table expanded on the card, and
// fr_mul_sub: a b - c elementwise (Groth16's h, ops/ntt_fr.py).
//
// Replaces: the JAX package's Python-int transforms of its Groth16 prover,
// xlayer_prover_tpu/snark/groth16.py _ntt_fr (:42) and the pointwise step
// of _h_coefficients (:231).  There is no TPU kernel of these functions:
// the JAX package runs them on the host.
//
// What bounds them on the card: (n/2) log2 n Montgomery products of 264
// 32-bit multiplies each, against one read and one write of n x 32 bytes;
// at 2^21 the products take longer.  The first design (one launch for the
// bit reversal, then one launch a radix-2 stage) read and wrote the whole
// array from device memory at every stage: ~2.7 GB at 2^21.
//
// Design: the decimation-in-time transform of the first design (bit-
// reversed input, stage s pairs i0 and i0 + 2^s with the twiddle
// w^((i0 mod 2^s) 2^(bits - 1 - s))), cut into ceil(bits / NTT_TILE_BITS)
// passes, one launch each, of S stages as even as can be (2^20: 10 + 10,
// 2^21: 11 + 10).  A pass starting at stage L sees the array as columns:
// column (h, j), j < 2^L, holds positions h 2^(L+S) + row 2^L + j for
// row < 2^S, and its S stages are a 2^S-point transform of that column
// (twiddles w^(((row mod 2^s') 2^L + j) 2^(bits - 1 - L - s'))).  A block
// holds 2^NTT_TILE_BITS values in shared memory, C = 2^(TILE - S)
// adjacent columns, so that a row comes in as C x 32 contiguous bytes
// (a value is one 32-byte sector: a strided gather wastes no DRAM
// bandwidth); it loads its tile once, runs the S stages and writes it back
// once.  Inside, a thread owns NTT_VALUES slots of the tile for a group of
// log2 NTT_VALUES stages (a radix-4 group: 4 butterflies), so the group's
// stages need no barrier; a barrier separates groups.  What limits the
// kernel is the latency of the products' carry chains, so warps an SM
// count most: each butterfly reads its pair from shared memory and
// writes it back, which fits a thread in 64 registers, 32 warps an SM;
// 8 slots a thread held in registers (128 registers, 16 warps) ran 1.4x
// slower (PERF.md, section 6).  Shared memory keeps word w
// of element e at w * tile + (e ^ SWIZZLE(e >> 5)): every group's
// accesses, and the first pass's row-wise reads, fall on 32 distinct
// banks a warp.  The first group of the first pass skips the product
// where its twiddle is 1 (3 butterflies of 4).
//
// The first pass reads in[bitrev(position)] (a gather of whole sectors),
// so no launch does the bit reversal, and the blocks take the input's
// columns in order; later passes run in place on `out` (a tile belongs to
// one block).  `in` is never written.  Twiddles come from a device table
// of w^k (k < n/2) in Montgomery form, read through the L2; the product of
// a canonical value by it is canonical, so every stored value is
// canonical and the output is bit for bit defined.  The inverse
// transform's n^-1 scale rides on the last pass's stores.  The table is
// built on the card by fr_ntt_twiddles from host tables of at most 2^11
// entries each (ops/ntt_fr.py): out[i 2^a + j] = lo[j] hi[i] / R.
//
// ops/ntt_fr._ntt_model follows these passes, index maps, the swizzle and
// twiddle indices step by step on Python ints; a CPU test reads the
// constants below out of this file.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define NTT_TILE_BITS 11                   // values a block holds: 2^11
#define NTT_VALUES 4                       // values a thread owns
#define NTT_GROUP_BITS 2                   // log2 NTT_VALUES: stages a group
static_assert(NTT_GROUP_BITS <= 2, "ntt_pass runs groups of 1 or 2 stages");
#define NTT_THREADS 512                    // 2^NTT_TILE_BITS / NTT_VALUES
#define NTT_MAX_PASSES 3                   // ceil(28 / NTT_TILE_BITS)
#define NTT_MIN_BLOCKS 2                   // blocks an SM: 64 registers
// bank swizzle: element e sits in slot e ^ SWIZZLE(e >> 5), the XOR of
// these masks over the set bits of (e >> 5) & 31
#define NTT_SWIZZLE_0 31u
#define NTT_SWIZZLE_1 21u
#define NTT_SWIZZLE_2 25u
#define NTT_SWIZZLE_3 1u
#define NTT_SWIZZLE_4 2u
#define EW_THREADS 128                     // elementwise kernels

// device launches made by this library (fr_ntt_device_launches)
static int g_launches = 0;

static inline unsigned ew_blocks(int64_t n) {
  return (unsigned)((n + EW_THREADS - 1) / EW_THREADS);
}

__device__ __forceinline__ void load8(uint32_t x[8],
                                      const uint32_t* __restrict__ p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = q[0], hi = q[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* __restrict__ p,
                                       const uint32_t x[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(x[0], x[1], x[2], x[3]);
  q[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void ldg8(uint32_t x[8],
                                     const uint32_t* __restrict__ p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = __ldg(q), hi = __ldg(q + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// the low `nbits` bits of x reversed
__device__ __forceinline__ uint32_t bitrev(uint32_t x, int nbits) {
  return nbits ? __brev(x) >> (32 - nbits) : 0u;
}

__device__ __forceinline__ int slot(int e) {
  const int h = e >> 5;
  return e ^ (((h & 1) ? NTT_SWIZZLE_0 : 0u) ^ ((h & 2) ? NTT_SWIZZLE_1 : 0u)
              ^ ((h & 4) ? NTT_SWIZZLE_2 : 0u)
              ^ ((h & 8) ? NTT_SWIZZLE_3 : 0u)
              ^ ((h & 16) ? NTT_SWIZZLE_4 : 0u));
}

__device__ __forceinline__ void sh_load(uint32_t x[8], const uint32_t* sh,
                                        int tile, int e) {
  const int s = slot(e);
#pragma unroll
  for (int w = 0; w < 8; w++) x[w] = sh[w * tile + s];
}

__device__ __forceinline__ void sh_store(uint32_t* sh, int tile, int e,
                                         const uint32_t x[8]) {
  const int s = slot(e);
#pragma unroll
  for (int w = 0; w < 8; w++) sh[w * tile + s] = x[w];
}

// One pass's shape, as the block sees it.
struct NttPass {
  int bits;         // log2 n
  int L;            // the pass's first stage
  int S;            // its stage count
  int c;            // log2 of the columns a block holds
  int tile;         // 2^(S + c) values a block
  int64_t col0;     // the block's first column
};

// x0, x1 = x0 + x1 w, x0 - x1 w (ONE: w = 1, no product)
template <bool ONE>
__device__ __forceinline__ void butterfly(uint32_t x0[8], uint32_t x1[8],
                                          const uint32_t* __restrict__ w) {
  uint32_t v[8];
  if (ONE) {
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = x1[k];
  } else {
    uint32_t t[8];
    ldg8(t, w);
    fr_mul(v, x1, t);
  }
  fr_sub(x1, x0, v);
  fr_add(x0, x0, v);
}

// One group of R stages (s0 .. s0 + R - 1 of the pass) over the
// NTT_VALUES slots a thread owns: NTT_VALUES >> R groups, group g at
// o = thread + threads g, o split as (column cc: c bits, lo: s0 bits, hi);
// its slot i (R bits) is row lo + i 2^s0 + hi 2^(s0 + R) of column cc.
// Stage s0 + d pairs slots q and q + 2^d (bit d of q clear).  No other
// thread touches these slots until the group ends, so the R stages need
// no barrier.  Each butterfly reads and writes its pair in shared
// memory, which leaves registers for more warps an SM.  FROM0: the first
// group of the first pass (s0 = L = 0), where slot q's twiddle k is the
// low d bits of q, so the butterflies with k = 0 skip the product (3 of
// a radix-4 group's 4).
template <int R, bool FROM0>
__device__ __forceinline__ void ntt_group(uint32_t* sh, const NttPass& P,
                                          int s0,
                                          const uint32_t* __restrict__ tw) {
  constexpr int V = NTT_VALUES;
  constexpr int G = V >> R;
  constexpr int W = 1 << R;
  int e[V];
  bool ok[G];
  int64_t k0[G];        // twiddle k of slot 0's row at stage s0
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int o = threadIdx.x + blockDim.x * g;
    ok[g] = o < (P.tile >> R);
    const int cc = o & ((1 << P.c) - 1);
    const int rest = o >> P.c;
    const int lo = rest & ((1 << s0) - 1);
    const int hi = rest >> s0;
    k0[g] = ((int64_t)lo << P.L) | ((P.col0 + cc) & ((1 << P.L) - 1));
#pragma unroll
    for (int i = 0; i < W; i++)
      e[g * W + i] = cc + ((lo + (i << s0) + (hi << (s0 + R))) << P.c);
  }
#pragma unroll
  for (int d = 0; d < R; d++) {
    const int shift = P.bits - 1 - P.L - s0 - d;
#pragma unroll
    for (int q = 0; q < V; q++) {
      if ((q >> d) & 1) continue;
      const int g = q / W;
      if (!ok[g]) continue;
      const int i = (q % W) & ((1 << d) - 1);
      const int64_t k = k0[g] + ((int64_t)i << (s0 + P.L));
      const uint32_t* w = tw + (k << shift) * 8;
      uint32_t a[8], b[8];
      sh_load(a, sh, P.tile, e[q]);
      sh_load(b, sh, P.tile, e[q + (1 << d)]);
      if (FROM0 && i == 0) {
        butterfly<true>(a, b, w);
      } else {
        butterfly<false>(a, b, w);
      }
      sh_store(sh, P.tile, e[q], a);
      sh_store(sh, P.tile, e[q + (1 << d)], b);
    }
  }
}

// global position of row `row` of column `col` in a pass
__device__ __forceinline__ int64_t ntt_pos(const NttPass& P, int64_t col,
                                           int row) {
  return ((col >> P.L) << (P.L + P.S)) + ((int64_t)row << P.L) +
         (col & ((1 << P.L) - 1));
}

// One pass.  FIRST: read src[bitrev(position)] (L = 0), block b taking
// the input's columns b C .. b C + C - 1, column ic being output column
// bitrev(ic) over the bits - S high bits.  SCALE: the last pass of an
// inverse, each value times n^-1 as it is stored.
template <bool FIRST, bool SCALE>
__global__ void __launch_bounds__(NTT_THREADS, NTT_MIN_BLOCKS)
ntt_pass(const uint32_t* src, uint32_t* dst, int bits, int L, int S, int c,
         const uint32_t* __restrict__ tw,
         const uint32_t* __restrict__ scale) {
  extern __shared__ uint32_t sh[];
  NttPass P;
  P.bits = bits;
  P.L = L;
  P.S = S;
  P.c = c;
  P.tile = 1 << (S + c);
  P.col0 = (int64_t)blockIdx.x << c;
  const int cmask = (1 << c) - 1;
  const int T = blockDim.x;
#pragma unroll
  for (int q = 0; q < NTT_VALUES; q++) {
    const int e = threadIdx.x + q * T;
    if (e >= P.tile) break;
    const int64_t col = P.col0 + (e & cmask);
    const int row = e >> c;
    const int64_t at =
        FIRST ? ((int64_t)bitrev(row, S) << (bits - S)) + col
              : ntt_pos(P, col, row);
    uint32_t x[8];
    load8(x, src + at * 8);
    sh_store(sh, P.tile, e, x);
  }
  for (int s0 = 0; s0 < S;) {
    const int r = S - s0 < NTT_GROUP_BITS ? S - s0 : NTT_GROUP_BITS;
    __syncthreads();
    const bool from0 = FIRST && s0 == 0;
    if (r == 2 && from0) ntt_group<2, true>(sh, P, s0, tw);
    if (r == 2 && !from0) ntt_group<2, false>(sh, P, s0, tw);
    if (r == 1 && from0) ntt_group<1, true>(sh, P, s0, tw);
    if (r == 1 && !from0) ntt_group<1, false>(sh, P, s0, tw);
    s0 += r;
  }
  __syncthreads();
  uint32_t sc[8];
  if (SCALE) load8(sc, scale);
#pragma unroll
  for (int q = 0; q < NTT_VALUES; q++) {
    const int f = threadIdx.x + q * T;
    if (f >= P.tile) break;
    // the first pass stores each column's rows in order (they are
    // contiguous in dst); later passes a row's columns
    const int cc = FIRST ? f >> S : f & cmask;
    const int row = FIRST ? f & ((1 << S) - 1) : f >> c;
    uint32_t x[8];
    sh_load(x, sh, P.tile, cc + (row << c));
    if (SCALE) fr_mul(x, x, sc);
    const int64_t col = P.col0 + cc;
    const int64_t at =
        FIRST ? ((int64_t)bitrev((uint32_t)col, bits - S) << S) + row
              : ntt_pos(P, col, row);
    store8(dst + at * 8, x);
  }
}

// out[i 2^a + j] = lo[j] hi[i] / R: with lo[j] = w^j R and
// hi[i] = w^(2^a i) R (Montgomery form), out[k] = w^k R, canonical
__global__ void ntt_twiddles(const uint32_t* __restrict__ lo, int a,
                             const uint32_t* __restrict__ hi,
                             uint32_t* __restrict__ out, int64_t count) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  uint32_t x[8], y[8], r[8];
  ldg8(x, lo + (k & ((1 << a) - 1)) * 8);
  ldg8(y, hi + (k >> a) * 8);
  fr_mul(r, x, y);
  store8(out + k * 8, r);
}

__global__ void mul_sub(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        const uint32_t* __restrict__ c,
                        uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], t[8], r2[8];
  load8(x, a + i * 8);
  load8(y, b + i * 8);
  fr_mul(t, x, y);                 // a b / R
  FrMod::r2(r2);
  fr_mul(t, t, r2);                // a b
  load8(x, c + i * 8);
  fr_sub(t, t, x);
  store8(out + i * 8, t);
}

// The stage counts of the passes over 2^bits values: ceil(bits / tile)
// passes, the larger first (ops/ntt_fr._passes)
static int ntt_passes(int bits, int S[NTT_MAX_PASSES]) {
  if (bits == 0) {
    S[0] = 0;
    return 1;
  }
  const int np = (bits + NTT_TILE_BITS - 1) / NTT_TILE_BITS;
  for (int p = 0; p < np; p++) S[p] = bits / np + (p < bits % np ? 1 : 0);
  return np;
}

template <bool FIRST, bool SCALE>
static cudaError_t ntt_launch_pass(const uint32_t* src, uint32_t* dst,
                                   int bits, int L, int S, int c,
                                   const uint32_t* tw, const uint32_t* scale,
                                   cudaStream_t st) {
  const int tile = 1 << (S + c);
  const size_t smem = (size_t)tile * 32;
  // 64 KB at a full tile, above the 48 KB a launch may take by default
  cudaError_t err = cudaFuncSetAttribute(
      ntt_pass<FIRST, SCALE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (1 << NTT_TILE_BITS) * 32);
  if (err != cudaSuccess) return err;
  const unsigned threads = tile >= NTT_VALUES ? tile / NTT_VALUES : 1;
  const unsigned blocks = (unsigned)(((int64_t)1 << bits) >> (S + c));
  ntt_pass<FIRST, SCALE><<<blocks, threads, smem, st>>>(src, dst, bits, L, S,
                                                        c, tw, scale);
  g_launches++;
  return cudaGetLastError();
}

extern "C" {

// out = NTT(in) (inverse: INTT, scaled by n^-1 = scale, Montgomery form):
// one launch a pass
int fr_ntt_launch(const void* in, void* out, int64_t n, int bits,
                  const void* tw, const void* scale, int inverse,
                  void* stream) {
  (void)n;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits < 0 || (bits + NTT_TILE_BITS - 1) / NTT_TILE_BITS > NTT_MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  int S[NTT_MAX_PASSES];
  const int np = ntt_passes(bits, S);
  const int tb = bits < NTT_TILE_BITS ? bits : NTT_TILE_BITS;
  const uint32_t* t = (const uint32_t*)tw;
  const uint32_t* sc = (const uint32_t*)scale;
  uint32_t* o = (uint32_t*)out;
  int L = 0;
  for (int p = 0; p < np; p++) {
    const bool first = p == 0, last = p == np - 1 && inverse;
    const uint32_t* src = first ? (const uint32_t*)in : o;
    const int c = tb - S[p];
    cudaError_t err;
    if (first && last) {
      err = ntt_launch_pass<true, true>(src, o, bits, L, S[p], c, t, sc, st);
    } else if (first) {
      err = ntt_launch_pass<true, false>(src, o, bits, L, S[p], c, t, sc, st);
    } else if (last) {
      err = ntt_launch_pass<false, true>(src, o, bits, L, S[p], c, t, sc, st);
    } else {
      err = ntt_launch_pass<false, false>(src, o, bits, L, S[p], c, t, sc,
                                          st);
    }
    if (err != cudaSuccess) return (int)err;
    L += S[p];
  }
  return 0;
}

// out (2^(a + b) values) = the products of lo (2^a) and hi (2^b) values
int fr_ntt_twiddles_launch(const void* lo, int a, const void* hi, int b,
                           void* out, void* stream) {
  const int64_t count = (int64_t)1 << (a + b);
  ntt_twiddles<<<ew_blocks(count), EW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, a, (const uint32_t*)hi, (uint32_t*)out, count);
  g_launches++;
  return (int)cudaGetLastError();
}

int fr_mul_sub_launch(const void* a, const void* b, const void* c, void* out,
                      int64_t n, void* stream) {
  mul_sub<<<ew_blocks(n), EW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (uint32_t*)out, n);
  g_launches++;
  return (int)cudaGetLastError();
}

// the device launches this library has made (every kernel, each <<<>>>)
int fr_ntt_device_launches(void) { return g_launches; }

}  // extern "C"
