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
// A full round is t S-boxes (x^5) and t dot products of length t.
//
// Bound: 32-bit integer multiplies (chip_smoke.py bn254_mul32: ~0.9 M a
// t = 17 permutation in the fewest-multiply form, against 1,088 bytes of
// input and output), not memory.
//
// Design:
//  * A state lives in the registers of a group of G lanes of one warp.
//    Every lane of the group holds lane 0 of the state (x0); state lane
//    e >= 1 sits in slot (e - 1) / G of group lane (e - 1) % G; slots past
//    t hold 0.  No shared memory is used.  G = 4 for a batch (at t = 17,
//    4 slots a lane: 5 elements with x0, the fewest a lane can hold while
//    its MDS accumulators still fit the registers; 8 states a warp).  A
//    batch too small to give each of the card's schedulers a warp at
//    G = 4 (a tree's upper levels) is latency-bound: G = 8 halves each
//    lane's chain.  At t <= SMALL_T one lane holds a whole state (G = 1),
//    which idles no lane.  The launchers choose; PERF.md has the times.
//  * A full round: each lane runs the S-boxes of x0 and its slots (all
//    lanes alike, so x0's is repeated G times), then the MDS.  A lane
//    computes the rows of its slots over all t inputs, reading the other
//    lanes' slots by __shfl_sync within the group, and its share of row
//    0 (its slots' terms, and x0's on lane 0), which a butterfly of
//    __shfl_xor_sync sums over the group.
//  * A partial round: the S-box of x0 on every lane; s0's terms of the
//    slots, which do not wait for it, then x0's on lane 0, summed by the
//    butterfly; then the slots' updates st_j += x0 v_j.
//  * Lazy reduction (bn254.cuh fr_mac_wide / fr_redc_wide): a dot
//    product's terms are full 512-bit products summed exactly in sixteen
//    words, and one Montgomery reduction and fr_canon make the sum
//    canonical.  The S-box squares by fr_sqr_wide (72 multiplies against
//    a product's 128), x^2 and x^4 left below 2r; its round constant and
//    a slot's update are the addend of the reduction that ends a product.
//  * G and the slot count K = ceil((t - 1) / G) are template parameters,
//    so the slots are registers and every loop over them unrolls; t, the
//    partial rounds and the table offsets are arguments.  With t itself
//    as the parameter (16 instantiations a kernel) and the full round
//    inlined at each of its 4 call sites the library took 719 s to build
//    on the H100's host (PERF.md); now one loop runs the 8 full rounds and
//    18 kernels are built.  The constants (ops/poseidon_bn254.py
//    kernel_table(t): Montgomery form, c | M | P | S) are read through
//    the read-only cache; a warp's lanes read G distinct constants at a
//    time.  No stack frames except the few spilled bytes of the t = 17
//    kernels under the 168-register cap (MIN_BLOCKS).
//  * Inputs are any 256-bit values (fr_to_mont reduces them mod r),
//    outputs canonical: bit-equal to the plain version _permute_plain.
// ops/poseidon_bn254.py GROUP, GROUP_FEW and SMALL_T mirror the constants
// below (a CPU test reads them here).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define THREADS 128
// 3 blocks of 128 an SM cap a kernel at 168 registers: the t = 17 kernels
// (8 warps an SM uncapped) spill 4-24 bytes and run 12 warps an SM, 19%
// faster at 2^20 states and 13% at 2^17 leaves of width 60 (PERF.md)
#define MIN_BLOCKS 3
#define GROUP 4               // lanes a state in a batch
// lanes a state in a batch of fewer states than the card has lanes /
// GROUP (4 or 8)
#define GROUP_FEW 8
// t up to which one lane holds a state (1: never)
#define SMALL_T 5
#define MAX_T 17
#define FULL_ROUNDS 8
#define ARITY 16
#define FULL_MASK 0xffffffffu

static_assert(GROUP_FEW == 4 || GROUP_FEW == 8, "GROUP_FEW: 4 or 8");
static_assert(SMALL_T >= 1 && SMALL_T <= 5, "SMALL_T: 1..5");

// slots a lane of a state of width t over g lanes
__host__ __device__ constexpr int slots(int t, int g) {
  return (t - 1 + g - 1) / g;
}

__host__ __device__ constexpr int n_rounds_p(int t) {
  constexpr int nrp[16] = {56, 57, 56, 60, 60, 63, 64, 63,
                           60, 66, 60, 65, 70, 60, 64, 68};
  return nrp[t - 2];
}

// a width's offsets in its table (ops/poseidon_bn254.py table_layout)
struct Width {
  int t, nrp, m0, p0, s0;
  __device__ __forceinline__ Width(int t_, int nrp_) : t(t_), nrp(nrp_) {
    m0 = FULL_ROUNDS * t + nrp;
    p0 = m0 + t * t;
    s0 = p0 + t * t;
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

__device__ __forceinline__ void zero8(uint32_t x[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = 0;
}

__device__ __forceinline__ void zero16(uint32_t x[16]) {
#pragma unroll
  for (int k = 0; k < 16; k++) x[k] = 0;
}

// x = x^5 + c (c = 0 when cidx < 0), canonical
__device__ __forceinline__ void sbox(uint32_t x[8],
                                     const uint32_t* __restrict__ tab,
                                     int cidx) {
  uint32_t x2[8], x4[8], c[8], w[16];
  fr_sqr_lazy(x2, x);
  fr_sqr_lazy(x4, x2);
  if (cidx >= 0) load_const(c, tab, cidx);
  else zero8(c);
  fr_mul_wide(w, x4, x);
  fr_redc_wide_add(x, w, c);
}

// The state of one group: x0 on every lane, state lane 1 + lane + G i in
// slot i (0 past t)
template <int K>
struct GroupState {
  uint32_t x0[8];
  uint32_t s[K][8];
};

// state lane of slot i on group lane `lane`, and the index used to read a
// constant for it (a valid lane, so a padding slot reads in bounds)
template <int G>
__device__ __forceinline__ int slot_elem(int lane, int i) {
  return 1 + lane + G * i;
}

template <int G>
__device__ __forceinline__ int slot_read(const Width& w, int lane, int i) {
  return min(slot_elem<G>(lane, i), w.t - 1);
}

// sum over the group of the sixteen-word acc (every lane gets the sum)
template <int G>
__device__ __forceinline__ void group_sum(uint32_t acc[16]) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    uint32_t o[16];
#pragma unroll
    for (int k = 0; k < 16; k++)
      o[k] = __shfl_xor_sync(FULL_MASK, acc[k], d, G);
    wide_add(acc, o);
  }
}

// S-boxes with round constants c[cbase + e] (none when cbase < 0), then
// the matrix at table index mo: out_i = sum_j mat[j t + i] st_j
template <int G, int K>
__device__ __forceinline__ void full_round(GroupState<K>& st, int lane,
                                           const Width& w,
                                           const uint32_t* __restrict__ tab,
                                           int cbase, int mo) {
  const int t = w.t;
  sbox(st.x0, tab, cbase);
#pragma unroll
  for (int i = 0; i < K; i++) {
    sbox(st.s[i], tab, cbase < 0 ? -1 : cbase + slot_read<G>(w, lane, i));
    if (slot_elem<G>(lane, i) >= t) zero8(st.s[i]);
  }
  uint32_t acc[K + 1][16];
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i <= K; i++) zero16(acc[i]);
  // row 0: this lane's share (its slots; x0 on lane 0)
  load_const(c, tab, mo);
  if (lane != 0) zero8(c);
  fr_mac_wide(acc[0], st.x0, c);
#pragma unroll
  for (int i = 0; i < K; i++) {
    load_const(c, tab, mo + slot_read<G>(w, lane, i) * t);
    fr_mac_wide(acc[0], st.s[i], c);
  }
  // the rows of this lane's slots: x0's term, then every slot of the group
#pragma unroll
  for (int i = 0; i < K; i++) {
    load_const(c, tab, mo + slot_read<G>(w, lane, i));
    fr_mac_wide(acc[i + 1], st.x0, c);
  }
#pragma unroll 1
  for (int o = 0; o < G; o++) {
#pragma unroll
    for (int i2 = 0; i2 < K; i2++) {
      const int j = slot_elem<G>(o, i2);
      if (j < t) {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; k++)
          v[k] = G == 1 ? st.s[i2][k]
                        : __shfl_sync(FULL_MASK, st.s[i2][k], o, G);
#pragma unroll
        for (int i = 0; i < K; i++) {
          load_const(c, tab, mo + j * t + slot_read<G>(w, lane, i));
          fr_mac_wide(acc[i + 1], v, c);
        }
      }
    }
  }
  group_sum<G>(acc[0]);
  fr_redc_wide(st.x0, acc[0]);
#pragma unroll
  for (int i = 0; i < K; i++) {
    fr_redc_wide(st.s[i], acc[i + 1]);
    if (slot_elem<G>(lane, i) >= t) zero8(st.s[i]);
  }
}

// The partial rounds: x0's S-box, s0 = sum_j S_j st_j, st_j += x0 v_j
template <int G, int K>
__device__ __forceinline__ void partial_rounds(
    GroupState<K>& st, int lane, const Width& w,
    const uint32_t* __restrict__ tab) {
  const int t = w.t;
  const int pc0 = (FULL_ROUNDS / 2 + 1) * t;
#pragma unroll 1
  for (int r = 0; r < w.nrp; r++) {
    const int srow = w.s0 + (2 * t - 1) * r;
    uint32_t acc[16], c[8], y[8];
    zero16(acc);
    // s0's terms of the slots (state lanes before this round's update)
#pragma unroll
    for (int i = 0; i < K; i++) {
      load_const(c, tab, srow + slot_read<G>(w, lane, i));
      fr_mac_wide(acc, st.s[i], c);
    }
#pragma unroll
    for (int k = 0; k < 8; k++) y[k] = st.x0[k];
    sbox(y, tab, pc0 + r);
    load_const(c, tab, srow);
    if (lane != 0) zero8(c);
    fr_mac_wide(acc, y, c);
    group_sum<G>(acc);
    fr_redc_wide(st.x0, acc);
    // st_j += x0 v_j
#pragma unroll
    for (int i = 0; i < K; i++) {
      uint32_t p[16];
      load_const(c, tab, srow + t + slot_read<G>(w, lane, i) - 1);
      fr_mul_wide(p, y, c);
      fr_redc_wide_add(st.s[i], p, st.s[i]);
      if (slot_elem<G>(lane, i) >= t) zero8(st.s[i]);
    }
  }
}

// The permutation of a group's Montgomery-form state (after the first
// round constants are added): full rounds 0..3 (round 3 with the
// pre-sparse matrix), the partial rounds, full rounds 4..7 (round 7
// without constants), one copy of the full round in the code
template <int G, int K>
__device__ __forceinline__ void permute_group(
    GroupState<K>& st, int lane, const Width& w,
    const uint32_t* __restrict__ tab) {
  constexpr int HALF = FULL_ROUNDS / 2;
  const int fc0 = (HALF + 1) * w.t + w.nrp;
#pragma unroll 1
  for (int r = 0; r < FULL_ROUNDS; r++) {
    const int cbase = r < HALF                ? (r + 1) * w.t
                      : r < FULL_ROUNDS - 1 ? fc0 + (r - HALF) * w.t
                                            : -1;
    full_round<G, K>(st, lane, w, tab, cbase, r == HALF - 1 ? w.p0 : w.m0);
    if (r == HALF - 1) partial_rounds<G, K>(st, lane, w, tab);
  }
}

__device__ __forceinline__ void split64(uint32_t x[2], uint64_t v) {
  x[0] = (uint32_t)v;
  x[1] = (uint32_t)(v >> 32);
}

__device__ __forceinline__ uint64_t join64(const uint32_t x[2]) {
  return ((uint64_t)x[1] << 32) | x[0];
}

// an Fr of four 64-bit words (any 256-bit value) -> Montgomery form
__device__ __forceinline__ void load_fr(uint32_t x[8],
                                        const uint64_t* __restrict__ src) {
  uint32_t raw[8];
#pragma unroll
  for (int w = 0; w < 4; w++) split64(raw + 2 * w, src[w]);
  fr_to_mont(x, raw);
}

// this thread's group (a state or a row), its lane in the group, and
// whether the group is inside the batch; a group past the end works on
// the last one and stores nothing, so every lane reaches every shuffle
struct Place {
  int64_t item;
  int lane;
  bool live;
};

template <int G>
__device__ __forceinline__ Place place(int64_t n) {
  const int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  Place p;
  p.live = g < n;
  p.item = p.live ? g : n - 1;
  p.lane = threadIdx.x % G;
  return p;
}

// the digest x0 (Montgomery form) -> canonical; lane k % G of the group
// writes 64-bit word k
template <int G>
__device__ __forceinline__ void store_digest(uint64_t* __restrict__ dst,
                                             const uint32_t x0[8], int lane) {
  uint32_t y[8];
  fr_from_mont(y, x0);
#pragma unroll
  for (int w = 0; w < 4; w++)
    if (lane == w % G) dst[w] = join64(y + 2 * w);
}

template <int G, int K>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    poseidon_bn254_permute_kernel(const uint64_t* __restrict__ in,
                                  uint64_t* __restrict__ out, int64_t n,
                                  int t, int nrp,
                                  const uint32_t* __restrict__ tab) {
  const Width w(t, nrp);
  const Place at = place<G>(n);
  const uint64_t* src = in + at.item * t * 4;
  GroupState<K> st;
  uint32_t c[8];
  load_fr(st.x0, src);
  load_const(c, tab, 0);
  fr_add(st.x0, st.x0, c);
#pragma unroll
  for (int i = 0; i < K; i++) {
    const int e = slot_read<G>(w, at.lane, i);
    load_fr(st.s[i], src + 4 * e);
    load_const(c, tab, e);
    fr_add(st.s[i], st.s[i], c);
    if (slot_elem<G>(at.lane, i) >= t) zero8(st.s[i]);
  }
  permute_group<G, K>(st, at.lane, w, tab);
  if (!at.live) return;
  uint64_t* dst = out + at.item * t * 4;
  store_digest<G>(dst, st.x0, at.lane);
#pragma unroll
  for (int i = 0; i < K; i++) {
    const int e = slot_elem<G>(at.lane, i);
    if (e < t) {
      uint32_t y[8];
      fr_from_mont(y, st.s[i]);
#pragma unroll
      for (int q = 0; q < 4; q++) dst[4 * e + q] = join64(y + 2 * q);
    }
  }
}

// state lane e (>= 1) of a sponge chunk that starts at packed Fr `pos`:
// Goldilocks words 3 (pos + e - 1) .. + 2 of the row (those below `width`)
// packed into one Fr (below 2^192), in Montgomery form
__device__ __forceinline__ void load_packed(uint32_t x[8],
                                            const uint64_t* __restrict__ row,
                                            int width, int pos, int e) {
  uint32_t raw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int w0 = 3 * (pos + e - 1);
#pragma unroll
  for (int q = 0; q < 3; q++)
    if (w0 + q < width) split64(raw + 2 * q, row[w0 + q]);
  fr_to_mont(x, raw);
}

// one sponge chunk of width w.t (w.t - 1 packed Fr from `pos`) over the
// digest
template <int G, int K>
__device__ __forceinline__ void absorb(uint32_t digest[8],
                                       const uint64_t* __restrict__ row,
                                       int width, int pos, int lane,
                                       const Width& w,
                                       const uint32_t* __restrict__ tab) {
  GroupState<K> st;
  uint32_t c[8];
  load_const(c, tab, 0);
  fr_add(st.x0, digest, c);
#pragma unroll
  for (int i = 0; i < K; i++) {
    const int e = slot_read<G>(w, lane, i);
    load_packed(st.s[i], row, width, pos, e);
    load_const(c, tab, e);
    fr_add(st.s[i], st.s[i], c);
    if (slot_elem<G>(lane, i) >= w.t) zero8(st.s[i]);
  }
  permute_group<G, K>(st, lane, w, tab);
#pragma unroll
  for (int k = 0; k < 8; k++) digest[k] = st.x0[k];
}

// One row of `width` Goldilocks words -> its Fr digest: width <= 4, the
// row's 256-bit packing mod r; wider, three words an Fr (below 2^192),
// absorbed 16 Fr a permutation at t = 17 with the digest in lane 0, the
// last chunk of t_tail - 1 Fr at t = t_tail (tab_tail; KT slots a lane).
// A group of G lanes a row; at G = 1 (the launcher's choice for a row of
// one chunk at t_tail <= SMALL_T) there is no t = 17 chunk.
template <int G, int KT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    poseidon_bn254_leaf_hash_kernel(const uint64_t* __restrict__ rows,
                                    uint64_t* __restrict__ out, int64_t n,
                                    int width,
                                    const uint32_t* __restrict__ tab17,
                                    const uint32_t* __restrict__ tab_tail,
                                    int t_tail) {
  const Place at = place<G>(n);
  const uint64_t* row = rows + at.item * width;
  uint32_t digest[8];
  if (width <= 4) {
    uint32_t raw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; q++)
      if (q < width) split64(raw + 2 * q, row[q]);
    fr_to_mont(digest, raw);
  } else {
    const int n_fr = (width + 2) / 3;
    const int n_full = (n_fr - 1) / ARITY;
    zero8(digest);                              // 0 in Montgomery form
    if constexpr (G > 1) {
      const Width w17(MAX_T, n_rounds_p(MAX_T));
#pragma unroll 1
      for (int ch = 0; ch < n_full; ch++)
        absorb<G, slots(MAX_T, G)>(digest, row, width, ch * ARITY, at.lane,
                                   w17, tab17);
    }
    const Width wt(t_tail, n_rounds_p(t_tail));
    absorb<G, KT>(digest, row, width, n_full * ARITY, at.lane, wt,
                  tab_tail);
  }
  if (at.live) store_digest<G>(out + at.item * 4, digest, at.lane);
}

static inline unsigned blocks_for(int64_t n, int g) {
  return (unsigned)((n * g + THREADS - 1) / THREADS);
}

// states below which a batch runs at GROUP_FEW: fewer than the card's
// lanes (SMs x 4 schedulers x 32) / GROUP
static int64_t few_states() {
  static int64_t few = -1;
  if (few < 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
    few = (int64_t)sms * 4 * 32 / GROUP;
  }
  return few;
}

// the batch size below which a permutation runs at GROUP_FEW
extern "C" int poseidon_bn254_few_states() { return (int)few_states(); }

// the group size a batch of n states of width t runs at
static int permute_group_size(int t, int64_t n) {
  return t <= SMALL_T ? 1 : n < few_states() ? GROUP_FEW : GROUP;
}

// and a batch of leaf rows: one lane a row of one chunk at t <= SMALL_T
static int leaf_group_size(int width, int t_tail) {
  return width > 4 && (width + 2) / 3 <= ARITY && t_tail <= SMALL_T ? 1
                                                                     : GROUP;
}

template <int G, int K>
static int launch_permute(const void* in, void* out, int64_t n, int t,
                          int nrp, const void* table, cudaStream_t stream) {
  poseidon_bn254_permute_kernel<G, K><<<blocks_for(n, G), THREADS, 0,
                                        stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n, t, nrp,
      (const uint32_t*)table);
  return (int)cudaGetLastError();
}

template <int G, int K>
static int launch_leaf(const void* rows, void* out, int64_t n, int width,
                       const void* table17, const void* table_tail,
                       int t_tail, cudaStream_t stream) {
  poseidon_bn254_leaf_hash_kernel<G, K><<<blocks_for(n, G), THREADS, 0,
                                          stream>>>(
      (const uint64_t*)rows, (uint64_t*)out, n, width,
      (const uint32_t*)table17, (const uint32_t*)table_tail, t_tail);
  return (int)cudaGetLastError();
}

template <class F>
static int warps_of(F kernel) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, THREADS, 0);
  return e == cudaSuccess ? blocks * THREADS / 32 : -(int)e;
}

// The kernels built, (G, K): every t = 2..17 at each group size the
// launchers may choose for it
#define PERMUTE_KERNELS(F)                                                 \
  F(1, 1) F(1, 2) F(1, 3) F(1, 4) F(4, 1) F(4, 2) F(4, 3) F(4, 4) F(8, 1) \
  F(8, 2)
#define LEAF_KERNELS(F) \
  F(1, 1) F(1, 2) F(1, 3) F(1, 4) F(4, 1) F(4, 2) F(4, 3) F(4, 4)
#define KEY(G, K) ((G) * 16 + (K))

// warps of the kernel that a batch of n states of width t (leaf = 0), or
// of n leaf rows of `width` words (leaf = 1, t = their tail width), runs
// on, that one SM holds at once (negative: a CUDA error)
extern "C" int poseidon_bn254_resident_warps(int t, int leaf, int64_t n,
                                             int width) {
  if (t < 2 || t > MAX_T) return -(int)cudaErrorInvalidValue;
  const int g = leaf ? leaf_group_size(width, t) : permute_group_size(t, n);
  const int key = KEY(g, slots(t, g));
  if (leaf) {
    switch (key) {
#define CASE(G, K) \
  case KEY(G, K): return warps_of(poseidon_bn254_leaf_hash_kernel<G, K>);
      LEAF_KERNELS(CASE)
#undef CASE
    }
  } else {
    switch (key) {
#define CASE(G, K) \
  case KEY(G, K): return warps_of(poseidon_bn254_permute_kernel<G, K>);
      PERMUTE_KERNELS(CASE)
#undef CASE
    }
  }
  return -(int)cudaErrorInvalidValue;
}

extern "C" int poseidon_bn254_permute_launch(const void* in, void* out,
                                             int64_t n, int t, int nrp,
                                             const void* table, void* stream) {
  if (t < 2 || t > MAX_T || n <= 0 || nrp != n_rounds_p(t))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = permute_group_size(t, n);
  switch (KEY(g, slots(t, g))) {
#define CASE(G, K) \
  case KEY(G, K): return launch_permute<G, K>(in, out, n, t, nrp, table, s);
    PERMUTE_KERNELS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int poseidon_bn254_leaf_hash_launch(const void* rows, void* out,
                                               int64_t n, int width,
                                               const void* table17, int nrp17,
                                               const void* table_tail,
                                               int t_tail, int nrp_tail,
                                               void* stream) {
  if (width < 0 || n <= 0 || t_tail < 2 || t_tail > MAX_T ||
      nrp17 != n_rounds_p(MAX_T) || nrp_tail != n_rounds_p(t_tail))
    return (int)cudaErrorInvalidValue;
  if (width > 4 && (((width + 2) / 3 - 1) % ARITY) + 2 != t_tail)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = leaf_group_size(width, t_tail);
  switch (KEY(g, slots(t_tail, g))) {
#define CASE(G, K)                                                      \
  case KEY(G, K):                                                       \
    return launch_leaf<G, K>(rows, out, n, width, table17, table_tail, \
                             t_tail, s);
    LEAF_KERNELS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
