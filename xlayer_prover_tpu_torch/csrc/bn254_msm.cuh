// The MSM and fixed-base kernels over BN254's G1 (Fq) and G2 (Fq2)
// (bn254_curve.cuh), one template over the coordinate field: multi-scalar
// multiplication sum_i k_i P_i (bn254_msm_g1 / bn254_msm_g2) and k_i G
// for a batch of scalars (bn254_fixed_base_g1 / bn254_fixed_base_g2).
// bn254_msm_g1.cu and bn254_msm_g2.cu instantiate them, one library each,
// so that nvcc builds the two in parallel.
//
// Replaces: the JAX package's host library xlayer_prover_tpu/native/
// msm.cpp (pippenger :251 via msm_g1 :288 and msm_g2 :318; fixed_base :378
// via fixed_base_g1 :481 and fixed_base_g2 :495, normalised to affine at
// :414 and :457), which serves its Groth16 setup and prover.  There is no
// TPU kernel of these functions: the JAX package runs them on the host.
//
// What bounds them on the card: the 32-bit multiplies of the Montgomery
// products (264 a product, 7 M + 4 S a mixed addition, 11 M + 5 S a full
// one; an Fq2 product is 3 Fq products); the bytes are small beside them.
//
// MSM (Pippenger, c-bit windows; the wrapper ops/bn254_msm.py picks c and
// orders the work with torch glue: the digits of every window, one
// torch.sort of (window, digit) keys, the runs below):
//  1. msm_prepare: each point to Montgomery form, once (a point serves in
//     every window).
//  2. msm_runs: one thread a run of at most K entries of one bucket (in
//     digit order), their sum by mixed additions.  A bucket of m entries
//     is cut into runs of K ~ sqrt(m_max), so a bucket that holds half of
//     the points (Groth16 witnesses are mostly 0 and 1) is no serial chain
//     of half the points.
//  3. msm_buckets: one thread a bucket, the sum of its runs' sums.
//  4. msm_segments: one thread a segment of the 2^c - 1 buckets of a
//     window: the running-sum trick over the segment gives
//     sum (b - lo + 1) B_b and sum B_b, and (lo - 1) sum B_b by double and
//     add makes it sum b B_b.
//  5. msm_windows: one thread a window, the sum of its segments.
//  6. msm_combine: one thread, acc = 2^c acc + window_w from the top
//     window down; the Jacobian result as canonical words ((0, 1, 0) at
//     infinity).
// Fixed base: one thread a scalar walks the host-built table of 2^j G
// (j < 254, affine, Montgomery form) with a mixed addition for every set
// bit, then normalises to affine with a Fermat inverse of Z; scalar 0
// gives zero words.
// Signed digits, batch-affine bucket sums and a windowed fixed-base table
// are for a later version.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_curve.cuh"

#define SCALAR_BITS 254
#define MSM_THREADS 64

static inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + MSM_THREADS - 1) / MSM_THREADS);
}

template <class F>
__global__ void msm_prepare(const uint32_t* __restrict__ pts,
                            uint32_t* __restrict__ mont, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int fw = FieldWords<F>::N;
  F x, y;
  f_load(x, pts + i * 2 * fw);
  f_load(y, pts + i * 2 * fw + fw);
  f_store_raw(mont + i * 2 * fw, x);
  f_store_raw(mont + i * 2 * fw + fw, y);
}

template <class F>
__global__ void msm_runs(const uint32_t* __restrict__ mont,
                         const int32_t* __restrict__ point,
                         const int32_t* __restrict__ run_start,
                         const int32_t* __restrict__ run_end, int64_t n_runs,
                         uint32_t* __restrict__ partial) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_runs) return;
  const int fw = FieldWords<F>::N;
  Jac<F> acc;
  jac_set_inf(acc);
  for (int32_t e = run_start[s]; e < run_end[s]; e++) {
    const int64_t idx = point[e];
    F x, y;
    f_load_raw(x, mont + idx * 2 * fw);
    f_load_raw(y, mont + idx * 2 * fw + fw);
    jac_add_affine(acc, acc, x, y);
  }
  jac_store_raw(partial + s * 3 * fw, acc);
}

template <class F>
__global__ void msm_buckets(const uint32_t* __restrict__ partial,
                            const int32_t* __restrict__ first_run,
                            int64_t n_buckets,
                            uint32_t* __restrict__ buckets) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_buckets) return;
  const int fw = FieldWords<F>::N;
  Jac<F> acc, q;
  jac_set_inf(acc);
  for (int32_t j = first_run[b]; j < first_run[b + 1]; j++) {
    jac_load_raw(q, partial + (int64_t)j * 3 * fw);
    jac_add(acc, acc, q);
  }
  jac_store_raw(buckets + b * 3 * fw, acc);
}

template <class F>
__global__ void msm_segments(const uint32_t* __restrict__ buckets, int c,
                             int n_windows, int segments,
                             uint32_t* __restrict__ seg_out) {
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (int64_t)n_windows * segments) return;
  const int fw = FieldWords<F>::N;
  const int w = (int)(id / segments), g = (int)(id % segments);
  const int nb = 1 << c;
  const int len = (nb - 1 + segments - 1) / segments;
  const int lo = 1 + g * len;
  const int hi = min(nb, lo + len);
  Jac<F> running, sum, q;
  jac_set_inf(running);
  jac_set_inf(sum);
  for (int b = hi - 1; b >= lo; b--) {
    jac_load_raw(q, buckets + ((int64_t)w * nb + b) * 3 * fw);
    jac_add(running, running, q);
    jac_add(sum, sum, running);
  }
  // sum = sum_b (b - lo + 1) B_b; add (lo - 1) sum_b B_b
  Jac<F> mult;
  jac_set_inf(mult);
  const int k = lo - 1;
  for (int bit = c - 1; bit >= 0; bit--) {
    jac_double(mult, mult);
    if ((k >> bit) & 1) jac_add(mult, mult, running);
  }
  jac_add(sum, sum, mult);
  jac_store_raw(seg_out + id * 3 * fw, sum);
}

template <class F>
__global__ void msm_windows(const uint32_t* __restrict__ seg, int n_windows,
                            int segments, uint32_t* __restrict__ windows) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_windows) return;
  const int fw = FieldWords<F>::N;
  Jac<F> acc, q;
  jac_set_inf(acc);
  for (int g = 0; g < segments; g++) {
    jac_load_raw(q, seg + ((int64_t)w * segments + g) * 3 * fw);
    jac_add(acc, acc, q);
  }
  jac_store_raw(windows + (int64_t)w * 3 * fw, acc);
}

template <class F>
__global__ void msm_combine(const uint32_t* __restrict__ windows, int c,
                            int n_windows, uint32_t* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int fw = FieldWords<F>::N;
  Jac<F> acc, q;
  jac_set_inf(acc);
  for (int w = n_windows - 1; w >= 0; w--) {
    for (int k = 0; k < c; k++) jac_double(acc, acc);
    jac_load_raw(q, windows + (int64_t)w * 3 * fw);
    jac_add(acc, acc, q);
  }
  if (jac_is_inf(acc)) {
    for (int k = 0; k < 3 * fw; k++) out[k] = 0;
    out[fw] = 1;                     // (0, 1, 0)
    return;
  }
  f_store(out, acc.x);
  f_store(out + fw, acc.y);
  f_store(out + 2 * fw, acc.z);
}

template <class F>
static int msm_launch(const void* points, int64_t n, const int32_t* point,
                      const int32_t* run_start, const int32_t* run_end,
                      int64_t n_runs, const int32_t* first_run, int c,
                      int n_windows, int segments, void* scratch, void* out,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int fw = FieldWords<F>::N;
  const int64_t n_buckets = (int64_t)n_windows << c;
  uint32_t* mont = (uint32_t*)scratch;
  uint32_t* partial = mont + n * 2 * fw;
  uint32_t* buckets = partial + n_runs * 3 * fw;
  uint32_t* seg = buckets + n_buckets * 3 * fw;
  uint32_t* windows = seg + (int64_t)n_windows * segments * 3 * fw;
  cudaError_t err;
  if (n > 0) {
    msm_prepare<F><<<blocks_for(n), MSM_THREADS, 0, st>>>(
        (const uint32_t*)points, mont, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (n_runs > 0) {
    msm_runs<F><<<blocks_for(n_runs), MSM_THREADS, 0, st>>>(
        mont, point, run_start, run_end, n_runs, partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  msm_buckets<F><<<blocks_for(n_buckets), MSM_THREADS, 0, st>>>(
      partial, first_run, n_buckets, buckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msm_segments<F><<<blocks_for((int64_t)n_windows * segments), MSM_THREADS,
                    0, st>>>(buckets, c, n_windows, segments, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msm_windows<F><<<blocks_for(n_windows), MSM_THREADS, 0, st>>>(
      seg, n_windows, segments, windows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msm_combine<F><<<1, 1, 0, st>>>(windows, c, n_windows, (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <class F>
__global__ void fixed_base(const uint32_t* __restrict__ table,
                           const uint32_t* __restrict__ scalars,
                           uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int fw = FieldWords<F>::N;
  uint32_t k[8];
#pragma unroll
  for (int w = 0; w < 8; w++) k[w] = scalars[i * 8 + w];
  Jac<F> acc;
  jac_set_inf(acc);
  for (int j = 0; j < SCALAR_BITS; j++) {
    if ((k[j >> 5] >> (j & 31)) & 1) {
      F x, y;
      f_load_raw(x, table + (int64_t)j * 2 * fw);
      f_load_raw(y, table + (int64_t)j * 2 * fw + fw);
      jac_add_affine(acc, acc, x, y);
    }
  }
  uint32_t* o = out + i * 2 * fw;
  if (jac_is_inf(acc)) {
    for (int w = 0; w < 2 * fw; w++) o[w] = 0;
    return;
  }
  F zi, zi2, t;
  f_inv(zi, acc.z);
  f_mul(zi2, zi, zi);
  f_mul(t, acc.x, zi2);
  f_store(o, t);
  f_mul(zi2, zi2, zi);
  f_mul(t, acc.y, zi2);
  f_store(o + fw, t);
}

template <class F>
static int fixed_base_launch(const void* table, const void* scalars,
                             void* out, int64_t n, void* stream) {
  fixed_base<F><<<blocks_for(n), MSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

