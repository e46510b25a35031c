// poseidon_permute: the Poseidon-Goldilocks t=12 permutation over a batch
// of states (8 full + 22 partial rounds, x^7 S-box, 12x12 MDS), the hash
// under every Merkle leaf and node of the prover.
//
// Replaces: xlayer_prover_tpu/ops/pallas_poseidon.py:_kernel (via
// permute, the pl.pallas_call at :251).  The TPU kernel held each lane as
// a u32 (lo, hi) pair and built products from 16-bit halves, because
// Mosaic has no 64-bit lanes.  Hopper has native 64-bit integer lanes:
// products here are a*b plus __umul64hi(a, b) and the Goldilocks
// reduction (gl.cuh).
//
// Bound: 32-bit integer multiply issue, not memory.  A permutation reads
// and writes 192 bytes.  Its fewest-multiply form factors each partial
// round's MDS into one sparse matrix (Poseidon paper App. B;
// ops/poseidon_constants.py:sparse_form): 6112 32-bit multiplies per
// permutation, counted by chip_smoke.py:poseidon_mul32, which gives the
// bound.  This kernel runs the dense form instead: 118 S-boxes x 4 full
// 64x64->128 products (4 32x32->64 partial products each) and 30 x 144
// MDS products; the MDS entries are small (< 2^16, checked by the
// wrapper), so each MDS product is two 32x16-bit multiplies into a
// 128-bit accumulator with one reduction per output lane:
// 30 x 144 x 2 + 472 x 4 = 10528 32-bit multiplies per permutation.
//
// Design: one thread per state, the 12 lanes in registers, the 360 round
// constants and the MDS in __constant__ memory (every thread of a warp
// reads the same word, which constant memory broadcasts).  The batch may
// have any length: threads past the end return.  Inputs may be any 64-bit
// pattern (the first round-constant addition reduces them); outputs are
// canonical.  MDS convention: out_j = sum_i s_i * M[i][j].
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl.cuh"

#define WIDTH 12
#define HALF_FULL 4
#define PARTIAL 22
#define N_ROUNDS 30

__constant__ uint64_t RC[N_ROUNDS * WIDTH];
__constant__ uint32_t MDS[WIDTH * WIDTH];

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(gl_mul(x4, x2), x);
}

__device__ __forceinline__ void ark(uint64_t* s, int r) {
#pragma unroll
  for (int k = 0; k < WIDTH; k++) s[k] = gl_add(s[k], RC[r * WIDTH + k]);
}

__device__ __forceinline__ void mds(uint64_t* s) {
  uint64_t o[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) {
    // sum_i s_i * M[i][j] = lo_sum + hi_sum * 2^32, each sum < 2^52
    uint64_t lo_sum = 0, hi_sum = 0;
#pragma unroll
    for (int i = 0; i < WIDTH; i++) {
      uint64_t m = MDS[i * WIDTH + j];
      lo_sum += (s[i] & 0xFFFFFFFFULL) * m;
      hi_sum += (s[i] >> 32) * m;
    }
    uint64_t lo = lo_sum + (hi_sum << 32);
    uint64_t hi = (hi_sum >> 32) + (lo < lo_sum ? 1 : 0);
    o[j] = gl_reduce128(lo, hi);
  }
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = o[j];
}

__global__ void poseidon_kernel(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out, int64_t n) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; k++) s[k] = in[t * WIDTH + k];
  int r = 0;
#pragma unroll 1
  for (int q = 0; q < HALF_FULL; q++, r++) {
    ark(s, r);
#pragma unroll
    for (int k = 0; k < WIDTH; k++) s[k] = sbox(s[k]);
    mds(s);
  }
#pragma unroll 1
  for (int q = 0; q < PARTIAL; q++, r++) {
    ark(s, r);
    s[0] = sbox(s[0]);
    mds(s);
  }
#pragma unroll 1
  for (int q = 0; q < HALF_FULL; q++, r++) {
    ark(s, r);
#pragma unroll
    for (int k = 0; k < WIDTH; k++) s[k] = sbox(s[k]);
    mds(s);
  }
#pragma unroll
  for (int k = 0; k < WIDTH; k++) out[t * WIDTH + k] = s[k];
}

// Host pointers: rc[360] round constants, mds[144] row-major M[i][j].
extern "C" int poseidon_set_constants(const uint64_t* rc, const uint32_t* mds) {
  cudaError_t e = cudaMemcpyToSymbol(RC, rc, sizeof(uint64_t) * N_ROUNDS * WIDTH);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(MDS, mds, sizeof(uint32_t) * WIDTH * WIDTH);
  return (int)e;
}

extern "C" int poseidon_permute_launch(const void* in, void* out, int64_t n,
                                       void* stream) {
  const int threads = 128;
  int64_t blocks = (n + threads - 1) / threads;
  poseidon_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}
