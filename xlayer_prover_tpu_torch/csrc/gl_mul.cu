// gl_mul: elementwise Goldilocks product of two int64 tensors (or of a
// tensor by one scalar), the multiply under every NTT butterfly,
// constraint evaluation, scan and FRI fold of the prover.
//
// Replaces: no Pallas kernel.  The JAX package built the 64x64->128
// product from four 32-bit half products in jnp (fields/gl.py:_mul_wide,
// _reduce128) and left it to XLA; PyTorch has no multiply-high and no
// uint64 arithmetic, so the port needs this kernel.
//
// Bound: memory.  Each element reads 16 bytes and writes 8 (24 bytes
// against 3.35 TB/s on an H100 SXM); the product is one a*b, one
// __umul64hi and a branch-free reduction, far below the integer issue
// rate.  Design: one element per thread in a grid-stride loop, 64-bit
// loads and stores with neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl.cuh"

__global__ void gl_mul_kernel(const uint64_t* __restrict__ a,
                              const uint64_t* __restrict__ b,
                              uint64_t* __restrict__ out, int64_t n,
                              int b_scalar) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  uint64_t bs = b_scalar ? b[0] : 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = gl_mul(a[i], b_scalar ? bs : b[i]);
  }
}

// max_blocks caps the grid (the wrapper passes 64 blocks per SM of the
// card); larger tensors take more turns of the grid-stride loop.
extern "C" int gl_mul_launch(const void* a, const void* b, void* out,
                             int64_t n, int b_scalar, int64_t max_blocks,
                             void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  gl_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint64_t*)b, (uint64_t*)out, n, b_scalar);
  return (int)cudaGetLastError();
}
