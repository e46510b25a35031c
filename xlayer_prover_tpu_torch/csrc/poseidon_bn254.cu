// poseidon_bn254_permute and poseidon_bn254_leaf_hash: the Poseidon
// permutation over BN254 Fr (circomlib's optimized form, widths t = 2..17)
// over a batch of states, and the BN128 Merkle leaf sponge built on it.
//
// Replaces: the JAX package's host core xlayer_prover_tpu/native/posbn.cpp
// (posbn_permute :139, posbn_permute_batch :215; a 4 x 64-bit CIOS
// Montgomery core, :51-76), which serves ops/poseidon_bn254.py permute and
// stark/commitment.py _leaf_hashes_batch / build_tree_bn128 (the recursiveF
// stage's trees).  There is no TPU kernel of this function: the JAX
// package runs it on the host.
//
// Round form (ops/poseidon_bn254.py host_permute): the first round
// constants; 3 full rounds with the MDS matrix M and 1 with the
// pre-sparse matrix P; N_ROUNDS_P[t - 2] partial rounds, each a lane-0
// S-box, s0 = sum_j S_j st_j and st_j += st_0 v_j; 4 full rounds with M.
// A full round is t S-boxes (x^5: three products) and t^2 products.
//
// Design (the first, simple one):
//  * One thread per state (per row for the leaf hash); field arithmetic
//    of bn254.cuh: 8 x 32-bit words, CIOS Montgomery products on PTX
//    carry chains, every value canonical.
//  * The state lives in shared memory, two buffers of 17 x 8 words per
//    thread (the MDS writes the other buffer), word k of lane i of thread
//    x at ((i * 8 + k) * blockDim + x): a warp's accesses are conflict
//    free.  So t is a runtime argument and one code path serves every
//    width, and the leaf hash mixes t = 17 with its row's tail width.
//  * The constants (ops/poseidon_bn254.py kernel_table(t): Montgomery
//    form, c | M | P | S) stay in global memory; every thread of a warp
//    reads the same constant at once, a broadcast through the L1.
//  * Inputs are any 256-bit values (fr_to_mont reduces them mod p),
//    outputs canonical: bit-equal to the plain version _permute_plain.
// The state in registers, spread over a warp, and the MDS by shuffles are
// for a later version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define MAX_T 17
#define FULL_ROUNDS 8
#define ARITY 16
#define THREADS 32
#define SMEM_BYTES (2 * MAX_T * FR_WORDS * THREADS * 4)

struct State {
  uint32_t* buf;   // this thread's first word; lanes strided by `stride`
  int stride;
  __device__ __forceinline__ void load(uint32_t x[8], int lane) const {
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = buf[(lane * 8 + k) * stride];
  }
  __device__ __forceinline__ void store(int lane, const uint32_t x[8]) const {
#pragma unroll
    for (int k = 0; k < 8; k++) buf[(lane * 8 + k) * stride] = x[k];
  }
};

__device__ __forceinline__ void load_const(uint32_t x[8],
                                           const uint32_t* __restrict__ tab,
                                           int idx) {
  const uint4* q = reinterpret_cast<const uint4*>(tab + 8 * idx);
  const uint4 lo = __ldg(q), hi = __ldg(q + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// st_i = st_i^5 (sbox) + c[c0 + i] (if add)
__device__ __forceinline__ void sbox_layer(const State& st, int t,
                                           const uint32_t* __restrict__ tab,
                                           int c0, bool add) {
  for (int i = 0; i < t; i++) {
    uint32_t x[8], y[8];
    st.load(x, i);
    fr_pow5(y, x);
    if (add) {
      load_const(x, tab, c0 + i);
      fr_add(y, y, x);
    }
    st.store(i, y);
  }
}

// out_i = sum_j mat[j t + i] st_j (mat at constant index m0)
__device__ __forceinline__ void mix(const State& out, const State& st, int t,
                                    const uint32_t* __restrict__ tab, int m0) {
  for (int i = 0; i < t; i++) {
    uint32_t acc[8], x[8], c[8];
    st.load(x, 0);
    load_const(c, tab, m0 + i);
    fr_mul(acc, x, c);
    for (int j = 1; j < t; j++) {
      uint32_t p[8];
      st.load(x, j);
      load_const(c, tab, m0 + j * t + i);
      fr_mul(p, x, c);
      fr_add(acc, acc, p);
    }
    out.store(i, acc);
  }
}

// The permutation of the Montgomery-form state in `a` (width t); returns
// the buffer that holds the result (a or b).
__device__ State permute_mont(State a, State b, int t, int nrp,
                              const uint32_t* __restrict__ tab) {
  const int m0 = FULL_ROUNDS * t + nrp;      // table_layout offsets
  const int p0 = m0 + t * t;
  const int s0 = p0 + t * t;
  const int half = FULL_ROUNDS / 2;
  for (int i = 0; i < t; i++) {
    uint32_t x[8], c[8];
    a.load(x, i);
    load_const(c, tab, i);
    fr_add(x, x, c);
    a.store(i, x);
  }
#pragma unroll 1
  for (int r = 0; r < half - 1; r++) {
    sbox_layer(a, t, tab, (r + 1) * t, true);
    mix(b, a, t, tab, m0);
    const State s = a; a = b; b = s;
  }
  sbox_layer(a, t, tab, half * t, true);
  mix(b, a, t, tab, p0);
  { const State s = a; a = b; b = s; }
  const int pc0 = (half + 1) * t;
#pragma unroll 1
  for (int r = 0; r < nrp; r++) {
    const int srow = s0 + (2 * t - 1) * r;
    uint32_t x0[8], y[8], c[8], acc[8], p[8];
    a.load(y, 0);
    fr_pow5(x0, y);
    load_const(c, tab, pc0 + r);
    fr_add(x0, x0, c);
    load_const(c, tab, srow);
    fr_mul(acc, x0, c);
    for (int j = 1; j < t; j++) {
      a.load(y, j);
      load_const(c, tab, srow + j);
      fr_mul(p, y, c);                       // s0 reads the old lane j
      fr_add(acc, acc, p);
      load_const(c, tab, srow + t + j - 1);
      fr_mul(p, x0, c);
      fr_add(y, y, p);
      a.store(j, y);
    }
    a.store(0, acc);
  }
  const int fc0 = pc0 + nrp;
#pragma unroll 1
  for (int r = 0; r < half - 1; r++) {
    sbox_layer(a, t, tab, fc0 + r * t, true);
    mix(b, a, t, tab, m0);
    const State s = a; a = b; b = s;
  }
  sbox_layer(a, t, tab, 0, false);
  mix(b, a, t, tab, m0);
  return b;
}

__device__ __forceinline__ void split64(uint32_t x[2], uint64_t v) {
  x[0] = (uint32_t)v;
  x[1] = (uint32_t)(v >> 32);
}

__device__ __forceinline__ State thread_state(uint32_t* smem, int which) {
  State s;
  s.stride = blockDim.x;
  s.buf = smem + which * MAX_T * FR_WORDS * blockDim.x + threadIdx.x;
  return s;
}

__global__ void __launch_bounds__(THREADS)
    poseidon_bn254_permute_kernel(const uint64_t* __restrict__ in,
                                  uint64_t* __restrict__ out, int64_t n, int t,
                                  int nrp, const uint32_t* __restrict__ tab) {
  extern __shared__ uint32_t smem[];
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const State a = thread_state(smem, 0), b = thread_state(smem, 1);
  const uint64_t* src = in + idx * t * 4;
  for (int i = 0; i < t; i++) {
    uint32_t raw[8], x[8];
#pragma unroll
    for (int w = 0; w < 4; w++) split64(raw + 2 * w, src[4 * i + w]);
    fr_to_mont(x, raw);
    a.store(i, x);
  }
  const State res = permute_mont(a, b, t, nrp, tab);
  uint64_t* dst = out + idx * t * 4;
  for (int i = 0; i < t; i++) {
    uint32_t x[8], y[8];
    res.load(x, i);
    fr_from_mont(y, x);
#pragma unroll
    for (int w = 0; w < 4; w++)
      dst[4 * i + w] = ((uint64_t)y[2 * w + 1] << 32) | y[2 * w];
  }
}

// One row of `width` Goldilocks words -> its Fr digest: width <= 4, the
// row's 256-bit packing mod p; wider, three words an Fr (below 2^192),
// absorbed 16 Fr a permutation at t = 17 with the digest in lane 0, the
// last chunk of b < 16 Fr at t = b + 1 (tab_tail).
__global__ void __launch_bounds__(THREADS)
    poseidon_bn254_leaf_hash_kernel(const uint64_t* __restrict__ rows,
                                    uint64_t* __restrict__ out, int64_t n,
                                    int width,
                                    const uint32_t* __restrict__ tab17,
                                    int nrp17,
                                    const uint32_t* __restrict__ tab_tail,
                                    int t_tail, int nrp_tail) {
  extern __shared__ uint32_t smem[];
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const uint64_t* row = rows + idx * width;
  uint32_t digest[8], y[8];
  if (width <= 4) {
    uint32_t raw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int w = 0; w < width; w++) split64(raw + 2 * w, row[w]);
    fr_to_mont(digest, raw);
  } else {
    const State a = thread_state(smem, 0), b = thread_state(smem, 1);
    const int n_fr = (width + 2) / 3;
#pragma unroll 8
    for (int k = 0; k < 8; k++) digest[k] = 0;   // 0 in Montgomery form
    for (int pos = 0; pos < n_fr; pos += ARITY) {
      const int chunk = min(ARITY, n_fr - pos);
      const int t = chunk + 1;
      a.store(0, digest);
      for (int e = 0; e < chunk; e++) {
        uint32_t raw[8] = {0, 0, 0, 0, 0, 0, 0, 0}, x[8];
        const int w0 = 3 * (pos + e);
        for (int q = 0; q < 3 && w0 + q < width; q++)
          split64(raw + 2 * q, row[w0 + q]);
        fr_to_mont(x, raw);
        a.store(1 + e, x);
      }
      const bool full = t == MAX_T;
      const State res = permute_mont(a, b, t, full ? nrp17 : nrp_tail,
                                     full ? tab17 : tab_tail);
      res.load(digest, 0);
    }
  }
  fr_from_mont(y, digest);
#pragma unroll
  for (int w = 0; w < 4; w++)
    out[idx * 4 + w] = ((uint64_t)y[2 * w + 1] << 32) | y[2 * w];
}

static inline int blocks_for(int64_t n) {
  return (int)((n + THREADS - 1) / THREADS);
}

extern "C" int poseidon_bn254_permute_launch(const void* in, void* out,
                                             int64_t n, int t, int nrp,
                                             const void* table, void* stream) {
  if (t < 2 || t > MAX_T) return (int)cudaErrorInvalidValue;
  poseidon_bn254_permute_kernel<<<blocks_for(n), THREADS, SMEM_BYTES,
                                  (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n, t, nrp,
      (const uint32_t*)table);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_bn254_leaf_hash_launch(const void* rows, void* out,
                                               int64_t n, int width,
                                               const void* table17, int nrp17,
                                               const void* table_tail,
                                               int t_tail, int nrp_tail,
                                               void* stream) {
  if (width < 0 || t_tail < 2 || t_tail > MAX_T) return (int)cudaErrorInvalidValue;
  if (width > 4 && (((width + 2) / 3 - 1) % ARITY) + 2 != t_tail)
    return (int)cudaErrorInvalidValue;
  poseidon_bn254_leaf_hash_kernel<<<blocks_for(n), THREADS, SMEM_BYTES,
                                    (cudaStream_t)stream>>>(
      (const uint64_t*)rows, (uint64_t*)out, n, width,
      (const uint32_t*)table17, nrp17, (const uint32_t*)table_tail, t_tail,
      nrp_tail);
  return (int)cudaGetLastError();
}
