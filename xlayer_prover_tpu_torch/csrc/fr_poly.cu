// fr_poly: the BN254 Fr polynomial kernels of the fflonk prover
// (ops/fr_poly.py; snark/fflonk.py drives them):
//
//   fr_eval          p(x) at up to EVAL_POINTS points: one launch a level,
//                    a thread a segment of EVAL_SEG coefficients by Horner;
//                    the segments' values are the next level's polynomial,
//                    evaluated at x^EVAL_SEG, down to one value.
//   fr_div_binomial  the quotient of p by X^k - c and its remainder.  With
//                    u_j = p_{j+k}, the quotient is y_j = u_j + c y_{j+k}
//                    (y_j = 0 past its end), k interleaved chains.  k <= 8:
//                    a block scan with a carried c^LIN_STEPS, a thread
//                    LIN_STEPS steps of each of the k chains (lin_level,
//                    two launches a level: the segments' lowest k values
//                    with no carry, then, once the level above has carried
//                    them, the segments again with their carry); k > 8 (X^n
//                    - 1's short chains): one thread an output, Horner
//                    along its chain (div_short), with the remainder.
//   fr_scan_mul      prefix products, inclusive or exclusive, of a vector
//                    or of one value repeated (the powers x^i): a block
//                    scan with a carried prefix (scan_level, two launches a
//                    level as above).
//   fr_pointwise     one fused elementwise pass per identity: a linear
//                    combination of up to PW_INPUTS vectors of their own
//                    lengths, a product, the PLONK gate, the permutation's
//                    numerator and denominator, T2's numerator.
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
// which form it takes.  What bounds these kernels on the card: the
// Montgomery products of 264 32-bit multiplies each (fr_eval, fr_scan_mul,
// fr_div_binomial take one or two a value, the identities 8-17) against a
// read of 32 bytes an input value and a write of 32 an output; segments
// of 16-32 values a thread keep the carries' levels few and every launch
// free of barriers and shared memory: each value is a whole 32-byte
// sector, so a thread's run of values wastes no DRAM bandwidth.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define PW_THREADS 128           // threads a block, every kernel here
#define EVAL_POINTS 4            // points a fr_eval launch takes
#define EVAL_SEG 32              // coefficients a fr_eval thread sums
#define SCAN_SEG 16              // values a fr_scan_mul thread multiplies
#define LIN_STEPS 16             // chain steps a fr_div_binomial thread
#define LIN_MAX_K 8              // the widest k of the block scan
#define PW_INPUTS 9              // inputs of a fr_pointwise identity
#define PW_CONSTS 6              // its constants

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

struct LinArgs {
  uint32_t c[8];                 // Montgomery form
};

// y_j = u_j + c y_{j+K} over j < m; thread s takes the segment of
// LIN_STEPS K values from s LIN_STEPS K, row by row from the top.  Its
// carry is y at (s + 1) K + r of `next` (the level above's y, 0 past
// next_len; null: no carry).  `totals` (if not null) gets the segment's
// lowest K values, `out` (if not null) every y_j.
template <int K>
__global__ void __launch_bounds__(PW_THREADS)
lin_level(const uint32_t* __restrict__ u, int64_t m, int64_t segs,
          LinArgs a, const uint32_t* __restrict__ next, int64_t next_len,
          uint32_t* __restrict__ out, uint32_t* __restrict__ totals) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= segs) return;
  uint32_t y[K][8];
#pragma unroll
  for (int r = 0; r < K; r++) {
    const int64_t at = (s + 1) * K + r;
    if (next != nullptr && at < next_len) {
      ld8(y[r], next + at * 8);
    } else {
      set8(y[r], 0);
    }
  }
  const int64_t lo = s * (int64_t)(LIN_STEPS * K);
  for (int row = LIN_STEPS - 1; row >= 0; row--) {
#pragma unroll
    for (int r = K - 1; r >= 0; r--) {
      const int64_t j = lo + row * K + r;
      uint32_t t[8];
      fr_mul(t, y[r], a.c);
      if (j < m) {
        uint32_t v[8];
        ld8(v, u + j * 8);
        fr_add(y[r], t, v);
        if (out != nullptr) st8(out + j * 8, y[r]);
      } else {
        cp8(y[r], t);
      }
    }
  }
  if (totals != nullptr) {
#pragma unroll
    for (int r = 0; r < K; r++) st8(totals + (s * K + r) * 8, y[r]);
  }
}

// q_j = sum_{t >= 1} c^(t-1) p_{j + t k} for j < n - k, and the remainder
// r_j = p_j + c q_j for j < k (q_j = 0 past n - k); one thread a j
__global__ void __launch_bounds__(PW_THREADS)
div_short(const uint32_t* __restrict__ p, int64_t n, int64_t k, LinArgs a,
          uint32_t* __restrict__ q, uint32_t* __restrict__ r,
          int64_t count) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  uint32_t acc[8], t[8], v[8];
  set8(acc, 0);
  if (j < n - k) {
    const int64_t top = j + ((n - 1 - j) / k) * k;
    for (int64_t i = top; i > j; i -= k) {
      fr_mul(t, acc, a.c);
      ld8(v, p + i * 8);
      fr_add(acc, t, v);
    }
    st8(q + j * 8, acc);
  }
  if (j < k) {
    if (j < n) {
      ld8(v, p + j * 8);
    } else {
      set8(v, 0);
    }
    fr_mul(t, acc, a.c);
    fr_add(acc, t, v);
    st8(r + j * 8, acc);
  }
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

// f1 f2 f3 (and z) of one side of the permutation argument:
// (v1 + b1 t1 + g)(v2 + b2 t2 + g)(v3 + b3 t3 + g), b_j t_j = mont(t_j, B_j)
// with the B_j Montgomery; `last` (if not null) one more factor; fix the
// 2^-256 of each product with K = 2^(256 m) for m factors
__device__ __forceinline__ void perm_side(uint32_t out[8], const uint32_t v[3][8],
                                          const uint32_t t[3][8],
                                          const uint32_t* b[3],
                                          const uint32_t g[8],
                                          const uint32_t* last,
                                          const uint32_t fix[8]) {
  uint32_t f[8], acc[8], u[8];
#pragma unroll
  for (int j = 0; j < 3; j++) {
    fr_mul(u, t[j], b[j]);
    fr_add(u, u, v[j]);
    fr_add(f, u, g);
    if (j == 0) {
      cp8(acc, f);
    } else {
      fr_mul(acc, acc, f);
    }
  }
  if (last != nullptr) fr_mul(acc, acc, last);
  fr_mul(out, acc, fix);
}

template <int OP>
__global__ void __launch_bounds__(PW_THREADS)
pointwise(PwArgs a, uint32_t* __restrict__ out, uint32_t* __restrict__ out2,
          int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[8], t[8], x[8];
  if (OP == PW_LINCOMB) {
    // sum_j k_j in_j[i], the k_j Montgomery form
    set8(acc, 0);
    for (int j = 0; j < a.nin; j++) {
      if (i < a.len[j]) {
        ld8(x, a.in[j] + i * 8);
        fr_mul(t, x, a.k[j]);
        fr_add(acc, acc, t);
      }
    }
    st8(out + i * 8, acc);
  } else if (OP == PW_MUL) {
    // in_0 in_1 k, k[0] = k 2^512 mod r
    ld8(x, a.in[0] + i * 8);
    ld8(t, a.in[1] + i * 8);
    fr_mul(acc, x, t);
    fr_mul(acc, acc, a.k[0]);
    st8(out + i * 8, acc);
  } else if (OP == PW_GATE) {
    // qM a b + qL a + qR b + qO c + qC + pi over (qM, qL, qR, qO, qC, a,
    // b, c, pi)
    uint32_t r2[8], w[3][8], q[8];
    FrMod::r2(r2);
#pragma unroll
    for (int j = 0; j < 3; j++) {
      ld8(x, a.in[5 + j] + i * 8);
      fr_mul(w[j], x, r2);             // a, b, c in Montgomery form
    }
    ld8(q, a.in[0] + i * 8);
    fr_mul(acc, q, w[0]);
    fr_mul(acc, acc, w[1]);            // qM a b
#pragma unroll
    for (int j = 0; j < 3; j++) {
      ld8(q, a.in[1 + j] + i * 8);
      fr_mul(t, q, w[j]);
      fr_add(acc, acc, t);
    }
    ld8(q, a.in[4] + i * 8);
    fr_add(acc, acc, q);
    ld8(q, a.in[8] + i * 8);
    fr_add(acc, acc, q);
    st8(out + i * 8, acc);
  } else {
    // PW_PERM_Z over (a, b, c, s1, s2, s3): out = numerator, out2 =
    // denominator; PW_PERM_T2 over (a, b, c, s1, s2, s3, z): out = z
    // numerator - z(w x) denominator.  k: beta (Montgomery), gamma
    // (canonical), k1 beta, k2 beta (Montgomery), 2^768 and 2^1024 mod r
    uint32_t v[3][8], tt[3][8], xs[3][8];
    const uint32_t* bx[3] = {a.k[0], a.k[2], a.k[3]};
    const uint32_t* bs[3] = {a.k[0], a.k[0], a.k[0]};
    uint32_t lo[8], hi[8];
    ld8(lo, a.dom_lo + (i & ((1LL << a.lo_bits) - 1)) * 8);
    ld8(hi, a.dom_hi + (i >> a.lo_bits) * 8);
    fr_mul(x, lo, hi);                 // the domain point
#pragma unroll
    for (int j = 0; j < 3; j++) {
      ld8(v[j], a.in[j] + i * 8);
      ld8(xs[j], a.in[3 + j] + i * 8);
      cp8(tt[j], x);
    }
    if (OP == PW_PERM_Z) {
      perm_side(acc, v, tt, bx, a.k[1], nullptr, a.k[4]);
      st8(out + i * 8, acc);
      perm_side(acc, v, xs, bs, a.k[1], nullptr, a.k[4]);
      st8(out2 + i * 8, acc);
    } else {
      uint32_t z[8], zw[8], g[8];
      ld8(z, a.in[6] + i * 8);
      int64_t iw = i + a.shift;
      if (iw >= n) iw -= n;
      ld8(zw, a.in[6] + iw * 8);
      perm_side(acc, v, tt, bx, a.k[1], z, a.k[5]);
      perm_side(g, v, xs, bs, a.k[1], zw, a.k[5]);
      fr_sub(acc, acc, g);
      st8(out + i * 8, acc);
    }
  }
}

// -- launchers ----------------------------------------------------------------

static void copy_words(uint32_t dst[8], const void* src) {
  const uint32_t* s = (const uint32_t*)src;
  for (int w = 0; w < 8; w++) dst[w] = s[w];
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

// one lin_level launch; c: 8 words, Montgomery form, in host memory
int fr_lin_scan_launch(const void* u, int64_t m, int k, int64_t segs,
                       const void* c, const void* next, int64_t next_len,
                       void* out, void* totals, void* stream) {
  if (k < 1 || k > LIN_MAX_K || segs < 1) return (int)cudaErrorInvalidValue;
  LinArgs a;
  copy_words(a.c, c);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned b = blocks_for(segs);
  const uint32_t* uu = (const uint32_t*)u;
  const uint32_t* nx = (const uint32_t*)next;
  uint32_t* o = (uint32_t*)out;
  uint32_t* tt = (uint32_t*)totals;
  switch (k) {
#define LIN_CASE(K)                                                     \
    case K: lin_level<K><<<b, PW_THREADS, 0, st>>>(uu, m, segs, a, nx,  \
                                                   next_len, o, tt);    \
      break;
    LIN_CASE(1) LIN_CASE(2) LIN_CASE(3) LIN_CASE(4)
    LIN_CASE(5) LIN_CASE(6) LIN_CASE(7) LIN_CASE(8)
#undef LIN_CASE
  }
  return (int)cudaGetLastError();
}

// q (n - k values, if positive) and r (k values) of p by X^k - c; c: 8
// words, Montgomery form, in host memory
int fr_div_short_launch(const void* p, int64_t n, int64_t k, const void* c,
                        void* q, void* r, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  LinArgs a;
  copy_words(a.c, c);
  const int64_t count = n - k > k ? n - k : k;
  div_short<<<blocks_for(count), PW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, n, k, a, (uint32_t*)q, (uint32_t*)r, count);
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
    case PW_LINCOMB:
      pointwise<PW_LINCOMB><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    case PW_MUL:
      pointwise<PW_MUL><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    case PW_GATE:
      pointwise<PW_GATE><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    case PW_PERM_Z:
      pointwise<PW_PERM_Z><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    case PW_PERM_T2:
      pointwise<PW_PERM_T2><<<b, PW_THREADS, 0, st>>>(a, o, o2, n); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
