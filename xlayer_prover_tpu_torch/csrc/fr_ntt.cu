// fr_ntt: the radix-2 NTT / INTT over BN254 Fr of n = 2^bits values, and
// fr_mul_sub: a b - c elementwise (Groth16's h, ops/ntt_fr.py).
//
// Replaces: the JAX package's Python-int transforms of its Groth16 prover,
// xlayer_prover_tpu/snark/groth16.py _ntt_fr (:42) and the pointwise step
// of _h_coefficients (:231).  There is no TPU kernel of these functions:
// the JAX package runs them on the host.
//
// What bounds them on the card: (n/2) log2 n Montgomery products of 264
// 32-bit multiplies each, against one read and one write of n x 32 bytes
// a pass; at 2^21 the products take longer.
//
// Design (the first, simple one): one launch copies the input into
// bit-reversed order (ntt_bitrev), then one launch a stage (ntt_stage),
// one thread a butterfly: v = a[i1] w, a[i0] = u + v, a[i1] = u - v, with
// w = tw[k 2^(bits - 1 - s)] read from a device table of w^k (k < n/2) in
// Montgomery form, so that the product of a canonical value by it is
// canonical: every value stays canonical and the output is bit for bit
// defined.  The inverse transform's n^-1 scale rides on its last stage.
// Shared-memory stages for the first log2(block) levels are for a later
// version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define NTT_THREADS 128

static inline unsigned ntt_blocks(int64_t n) {
  return (unsigned)((n + NTT_THREADS - 1) / NTT_THREADS);
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

__global__ void ntt_bitrev(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out, int64_t n, int bits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t j = bits ? (int64_t)(__brev((uint32_t)i) >> (32 - bits)) : 0;
  uint32_t x[8];
  load8(x, in + i * 8);
  store8(out + j * 8, x);
}

__global__ void ntt_stage(uint32_t* __restrict__ a, int64_t n, int bits,
                          int s, const uint32_t* __restrict__ tw,
                          const uint32_t* __restrict__ scale) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n / 2) return;
  const int64_t half = (int64_t)1 << s;
  const int64_t k = j & (half - 1);
  const int64_t i0 = ((j >> s) << (s + 1)) + k;
  const int64_t i1 = i0 + half;
  uint32_t u[8], x[8], w[8], v[8], r0[8], r1[8];
  load8(u, a + i0 * 8);
  load8(x, a + i1 * 8);
  load8(w, tw + (k << (bits - 1 - s)) * 8);
  fr_mul(v, x, w);
  fr_add(r0, u, v);
  fr_sub(r1, u, v);
  if (scale != nullptr) {
    uint32_t c[8];
    load8(c, scale);
    fr_mul(r0, r0, c);
    fr_mul(r1, r1, c);
  }
  store8(a + i0 * 8, r0);
  store8(a + i1 * 8, r1);
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

extern "C" {

// out = NTT(in) (inverse: INTT, scaled by n^-1 = scale, Montgomery form)
int fr_ntt_launch(const void* in, void* out, int64_t n, int bits,
                  const void* tw, const void* scale, int inverse,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ntt_bitrev<<<ntt_blocks(n), NTT_THREADS, 0, st>>>(
      (const uint32_t*)in, (uint32_t*)out, n, bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < bits; s++) {
    const uint32_t* sc =
        (inverse && s == bits - 1) ? (const uint32_t*)scale : nullptr;
    ntt_stage<<<ntt_blocks(n / 2), NTT_THREADS, 0, st>>>(
        (uint32_t*)out, n, bits, s, (const uint32_t*)tw, sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

int fr_mul_sub_launch(const void* a, const void* b, const void* c, void* out,
                      int64_t n, void* stream) {
  mul_sub<<<ntt_blocks(n), NTT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
