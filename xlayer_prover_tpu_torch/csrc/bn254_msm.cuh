// The MSM and fixed-base kernels over BN254's G1 (Fq) and G2 (Fq2)
// (bn254_curve.cuh), one template over the coordinate field: multi-scalar
// multiplication sum_i k_i P_i (bn254_msm_g1 / bn254_msm_g2) and k_i G
// for a batch of scalars (bn254_fixed_base_g1 / bn254_fixed_base_g2).
// bn254_msm_g1.cu and bn254_msm_g2.cu instantiate them, one library each,
// so that nvcc builds the two in parallel.
//
// Replaces: the JAX package's host library xlayer_prover_tpu/native/
// msm.cpp (pippenger :251 via msm_g1 :288 and msm_g2 :318; fixed_base :378
// via fixed_base_g1 :481 and fixed_base_g2 :495, normalised to affine by
// g1_normalize :414 and g2_normalize :457), which serves its Groth16 setup
// and prover.  There is no TPU kernel of these functions: the JAX package
// runs them on the host.
//
// -- MSM ---------------------------------------------------------------------
//
// What bounds it on the card: the 32-bit multiplies of the Montgomery
// products (264 a product; 7 M + 4 S a mixed addition, one a nonzero
// digit; 11 M + 5 S a full addition, two a bucket for the running sums; an
// Fq2 product is 3 Fq products); the bytes are small beside them.  What
// keeps a GPU Pippenger far from that bound is how the additions fall on
// the threads: a serial chain of hundreds of additions on one of a few
// thousand threads (a bucket of the many 0/1 witnesses, a window's
// running sum, the windows' combination) waits on carry-chain latency
// that nothing hides, while the card's other lanes idle.
//
// What the design does about it (ops/bn254_msm.py msm_plan sizes every
// launch from n and c alone, and _msm_model is the same schedule step for
// step in plain PyTorch):
//  * Signed c-bit digits (msm_prepare, one thread a point, which also puts
//    the point in Montgomery form): digit d_w in (-2^(c-1), 2^(c-1)] with a
//    carry into the next window, ceil(255 / c) windows, so a window has
//    2^(c-1) buckets and a negative digit adds (x, p - y).  The key of an
//    entry is 2 bucket + sign, 32 bits; a zero digit or a point at
//    infinity gets MSM_NONE, which sorts last.  One torch.sort of the
//    W n keys orders them (glue); nothing on the path waits for the host.
//  * Balanced bucket sums (msm_chunks): thread t sums the MSM_CHUNK sorted
//    entries [t L, t L + L) with mixed additions, across bucket edges.  A
//    bucket that lies inside the chunk is written to its slot directly;
//    the sums at the chunk's two edges of a bucket that goes on into the
//    neighbour chunk are written as the chunk's two edge items.  Levels of
//    the same kernel over the edge items with full additions
//    (MSM_EDGE_CHUNK items a thread; one warp a chunk, msm_edges_warp,
//    once a level has at most MSM_WARP_CHUNKS chunks) reduce them until
//    one chunk is left: a segmented reduction.  Every lane does the same
//    number of additions, and a bucket of half the points is spread over
//    many threads.  Chunks of zero digits stop at their first key.
//  * A parallel tail: the running sums over segments of MSM_SEGMENT
//    buckets (msm_running, W 2^(c-1) / MSM_SEGMENT threads), each giving
//    sum_b (b - lo + 1) B_b and its total sum_b B_b.  The offsets
//    (lo - 1) sum_b B_b are the same weighted sum over the segments'
//    totals (weights 1, 2, ...) times MSM_SEGMENT: further levels over
//    the totals, each doubled log2(segment) times, in segments of
//    MSM_SEGMENT_HI.  Every window's sums then go through a tree of
//    MSM_FAN items a node (msm_tree), and one warp combines the windows
//    (msm_combine: acc = 2^c acc + S_w from the top window down).  The
//    levels above the first, the tree and the combination are chains of
//    additions on few points, so one warp does each addition, its
//    products on separate lanes (warp_add, warp_double below).
//  * The register file: the additions read their second operand from
//    memory where it is first needed (jac_add_from), the running sums keep
//    their two points in shared memory, and __launch_bounds__ caps the
//    registers of the bucket sums (MsmShape).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_curve.cuh"

#define MSM_NONE 0x7FFFFFFF        // the key of a zero digit
#define MSM_NONE_BUCKET (MSM_NONE >> 1)   // its bucket; an empty edge item
#define MSM_CHUNK 64               // sorted entries a thread sums
#define MSM_EDGE_CHUNK 16          // edge items a thread of a level sums
#define MSM_SEGMENT 16             // buckets of a first-level segment
#define MSM_SEGMENT_BITS 4         // log2(MSM_SEGMENT)
#define MSM_SEGMENT_HI 4           // items of a segment of a higher level
#define MSM_SEGMENT_HI_BITS 2      // log2(MSM_SEGMENT_HI)
#define MSM_FAN 4                  // items a warp of the window tree sums
#define MSM_THREADS 64             // the block of msm_prepare, msm_running

// the bucket sums' block width and the blocks an SM must hold, for the
// mixed additions of the sorted entries (AFFINE) and for the full
// additions of the edge levels (G2's within 255 registers, not 168)
template <class F, bool AFFINE> struct MsmShape;
template <bool AFFINE> struct MsmShape<Fq, AFFINE> {
  static constexpr int THREADS = 128, MIN_BLOCKS = 4;
};
template <bool AFFINE> struct MsmShape<Fq2, AFFINE> {
  static constexpr int THREADS = 128, MIN_BLOCKS = AFFINE ? 3 : 2;
};

static inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// c bits of a 256-bit scalar (eight words) from bit `off` (c <= 31)
__device__ __forceinline__ uint32_t scalar_bits(const uint32_t s[8], int off,
                                                int c) {
  const int word = off >> 5, bit = off & 31;
  if (word >= 8) return 0;
  uint32_t v = s[word] >> bit;
  if (bit + c > 32 && word + 1 < 8) v |= s[word + 1] << (32 - bit);
  return v & ((1u << c) - 1);
}

// one thread a point: the point in Montgomery form, and the key of each of
// its `windows` signed digits, keys[w n + i] (MSM_NONE for a zero digit or
// a point at infinity).  The scalar is read below 2^254.
template <class F>
__global__ void msm_prepare(const uint32_t* __restrict__ pts,
                            const uint32_t* __restrict__ scalars,
                            uint32_t* __restrict__ mont,
                            int32_t* __restrict__ keys, int64_t n, int c,
                            int windows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int fw = FieldWords<F>::N;
  uint32_t any = 0;
  for (int k = 0; k < 2 * fw; k++) any |= pts[i * 2 * fw + k];
  F x, y;
  f_load(x, pts + i * 2 * fw);
  f_load(y, pts + i * 2 * fw + fw);
  f_store_raw(mont + i * 2 * fw, x);
  f_store_raw(mont + i * 2 * fw + fw, y);
  uint32_t s[8];
  for (int k = 0; k < 8; k++) s[k] = scalars[i * 8 + k];
  s[7] &= 0x3FFFFFFFu;
  const int half = 1 << (c - 1);
  int carry = 0;
  for (int w = 0; w < windows; w++) {
    const int t = (int)scalar_bits(s, w * c, c) + carry;
    carry = t > half;
    const int d = carry ? t - (1 << c) : t;
    int32_t key = MSM_NONE;
    if (d != 0 && any != 0) {
      const int mag = d < 0 ? -d : d;
      key = (int32_t)((((int64_t)w << (c - 1)) + mag - 1) * 2 + (d < 0));
    }
    keys[(int64_t)w * n + i] = key;
  }
}

// One level of the bucket sums: thread t sums items [t len, t len + len)
// of `count`, in runs of one bucket.  AFFINE: the items are the sorted
// keys (2 bucket + sign) of entry e, point index[e] - window n of the
// Montgomery table `src`, added by mixed additions (y -> p - y for a
// negative digit); else the items are edge items (key = bucket, a
// Jacobian point at src + e 3 fw) added by full additions.  A run inside
// the chunk is the bucket's sum: it goes to buckets[bucket].  A run at the
// chunk's start whose bucket the item before holds too goes to edge item
// 2 t (and item 2 t + 1 gets the bucket and infinity when that run also
// reaches the chunk's end and goes on); one at its end whose bucket the
// next item holds goes to edge item 2 t + 1.  Other edge items get
// MSM_NONE_BUCKET.  So the items of one bucket stay side by side, with
// nothing but its own between them, level after level.
template <class F, bool AFFINE>
__global__ void __launch_bounds__(MsmShape<F, AFFINE>::THREADS,
                                  MsmShape<F, AFFINE>::MIN_BLOCKS)
msm_chunks(const int32_t* __restrict__ keys,
           const int64_t* __restrict__ index,
           const uint32_t* __restrict__ src, int64_t n, int c, int64_t count,
           int64_t chunks, int len, uint32_t* __restrict__ buckets,
           int32_t* __restrict__ out_keys, uint32_t* __restrict__ out_pts) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= chunks) return;
  const int fw = FieldWords<F>::N;
  const int64_t start = t * len;
  const int64_t end = start + len < count ? start + len : count;
  auto bucket_at = [&](int64_t e) -> int32_t {
    return AFFINE ? keys[e] >> 1 : keys[e];
  };
  int32_t head = MSM_NONE_BUCKET, tail = MSM_NONE_BUCKET;
  const int32_t before = start > 0 ? bucket_at(start - 1) : MSM_NONE_BUCKET;
  const int32_t after = end < count ? bucket_at(end) : MSM_NONE_BUCKET;
  Jac<F> acc;
  jac_set_inf(acc);
  int32_t cur = bucket_at(start);
  int64_t run = start;
  // the run [run, e) of bucket cur ends
  auto flush = [&](int64_t e) {
    if (cur == MSM_NONE_BUCKET) return;
    const bool from_before = run == start && before == cur;
    const bool on_after = e == end && after == cur;
    if (from_before) {
      head = cur;
      jac_store_raw(out_pts + 2 * t * 3 * fw, acc);
      if (on_after) {              // infinity: zero words
        tail = cur;
        uint32_t* o = out_pts + (2 * t + 1) * 3 * fw;
        for (int k = 0; k < 3 * fw; k++) o[k] = 0;
      }
    } else if (on_after) {
      tail = cur;
      jac_store_raw(out_pts + (2 * t + 1) * 3 * fw, acc);
    } else {
      jac_store_raw(buckets + (int64_t)cur * 3 * fw, acc);
    }
  };
  for (int64_t e = start; e < end; e++) {
    const int32_t key = keys[e];
    const int32_t b = AFFINE ? key >> 1 : key;
    if (b != cur) {
      flush(e);
      cur = b;
      run = e;
      jac_set_inf(acc);
    }
    if (b == MSM_NONE_BUCKET) {
      if (AFFINE) break;           // zero digits sort last
      continue;
    }
    if (AFFINE) {
      const int64_t idx = index[e] - (int64_t)(key >> c) * n;
      F x, y;
      f_load_raw(x, src + idx * 2 * fw);
      f_load_raw(y, src + idx * 2 * fw + fw);
      if (key & 1) {
        F zero;
        f_zero(zero);
        f_sub(y, zero, y);
      }
      jac_add_affine(acc, acc, x, y);
    } else {
      jac_add_from(acc, src + e * 3 * fw);
    }
  }
  flush(end);
  if (out_keys != nullptr) {
    out_keys[2 * t] = head;
    out_keys[2 * t + 1] = tail;
  }
}

// One level of the running sums: thread (w, g) takes items
// [g MSM_SEGMENT, ...) of window w's `count` (item i at in + (w in_stride
// + i) 3 fw, weight i + 1), from the top down: running += X_i,
// sum += running, so sum = sum_i (i - lo + 1) X_i and running = sum_i X_i.
// It writes sum to sums[w sums_stride + g] and, if `totals` is set,
// MSM_SEGMENT running to totals[w groups + g]: the items of the next
// level, whose weighted sum is the segments' offsets (lo - 1) sum_i X_i.
// Both points live in shared memory, word-major across the block.
template <class F>
__global__ void __launch_bounds__(MSM_THREADS)
msm_running(const uint32_t* __restrict__ in, int64_t in_stride, int count,
            int groups, int windows, uint32_t* __restrict__ sums,
            int64_t sums_stride, uint32_t* __restrict__ totals) {
  constexpr int fw = FieldWords<F>::N, T = MSM_THREADS;
  __shared__ uint32_t stage[2 * 3 * fw * T];
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (int64_t)windows * groups) return;
  const int w = (int)(id / groups), g = (int)(id % groups);
  uint32_t* running = stage + threadIdx.x;
  uint32_t* sum = running + 3 * fw * T;
  Jac<F> acc;
  jac_set_inf(acc);
  jac_store_raw<F, T>(running, acc);
  jac_store_raw<F, T>(sum, acc);
  const int lo = g * MSM_SEGMENT;
  const int hi = lo + MSM_SEGMENT < count ? lo + MSM_SEGMENT : count;
  for (int i = hi - 1; i >= lo; i--) {
    jac_load_raw<F, T>(acc, running);
    jac_add_from(acc, in + ((int64_t)w * in_stride + i) * 3 * fw);
    jac_store_raw<F, T>(running, acc);
    jac_load_raw<F, T>(acc, sum);
    jac_add_from<F, T>(acc, running);
    jac_store_raw<F, T>(sum, acc);
  }
  jac_store_raw(sums + ((int64_t)w * sums_stride + g) * 3 * fw, acc);
  if (totals != nullptr) {
    jac_load_raw<F, T>(acc, running);
    for (int k = 0; k < MSM_SEGMENT_BITS; k++) jac_double(acc, acc);
    jac_store_raw(totals + ((int64_t)w * groups + g) * 3 * fw, acc);
  }
}

// -- one warp's point arithmetic ----------------------------------------------
//
// After the bucket sums and the first running-sum level, few points are
// left, and the additions come one after another: their latency, not
// the card's multiply rate, sets the time (the combination's ~254 - c
// doublings most of all).  Here the products of one step of a doubling
// or an addition run on separate lanes of one warp (an Fq2 product on
// three: a0 b0, a1 b1, (a0 + a1)(b0 + b1)), on field elements in shared
// memory: a doubling waits for three products and an addition for five,
// where one thread waits for each of their 7-16 products in turn.  The
// formulas are jac_double's and jac_add_from's.

// lanes an F product takes
template <class F> struct LaneMul;
template <> struct LaneMul<Fq> { static constexpr int N = 1; };
template <> struct LaneMul<Fq2> { static constexpr int N = 3; };

// a warp's shared-memory slots: points (X, Y, Z) at PA, PQ and PB, and
// the temporaries of a step
enum WarpSlot { PA = 0, PQ = 3, PB = 6, SA = 9, SB, SC, SD, SE, SF, ST, SU,
                SV, SW, N_SLOTS };

// a product s[out] = s[a] s[b] of one step
#define MUL_OP(a, b, out) \
  ((uint32_t)(a) | (uint32_t)(b) << 8 | (uint32_t)(out) << 16)

__device__ __forceinline__ void lane_mul(Fq* s, Fq* part, uint32_t op,
                                         int, int) {
  Fq r;
  f_mul(r, s[op & 0xFF], s[(op >> 8) & 0xFF]);
  s[op >> 16] = r;
}

__device__ __forceinline__ void lane_mul(Fq2* s, Fq* part, uint32_t op,
                                         int idx, int which) {
  const Fq2& a = s[op & 0xFF];
  const Fq2& b = s[(op >> 8) & 0xFF];
  Fq x, y;
  if (which == 0) {
    x = a.c0;
    y = b.c0;
  } else if (which == 1) {
    x = a.c1;
    y = b.c1;
  } else {
    f_add(x, a.c0, a.c1);
    f_add(y, b.c0, b.c1);
  }
  f_mul(part[3 * idx + which], x, y);
}

// the k (<= 5) products of one step, each on LaneMul<F>::N lanes
template <class F>
__device__ void lanes_mul(F* s, Fq* part, int k, uint32_t o0,
                          uint32_t o1 = 0, uint32_t o2 = 0, uint32_t o3 = 0,
                          uint32_t o4 = 0) {
  constexpr int LP = LaneMul<F>::N;
  const int lane = threadIdx.x & 31, idx = lane / LP;
  const uint32_t op = idx == 0 ? o0 : idx == 1 ? o1 : idx == 2 ? o2
                    : idx == 3 ? o3 : o4;
  if (idx < k) lane_mul(s, part, op, idx, lane - idx * LP);
  __syncwarp();
  if (LP > 1) {                    // (t0 - t1) + (t2 - t0 - t1) u
    const uint32_t mine = lane == 0 ? o0 : lane == 1 ? o1 : lane == 2 ? o2
                        : lane == 3 ? o3 : o4;
    if (lane < k) {
      Fq* c = reinterpret_cast<Fq*>(&s[mine >> 16]);
      const Fq* t = part + 3 * lane;
      Fq u;
      f_sub(c[0], t[0], t[1]);
      f_sub(u, t[2], t[0]);
      f_sub(c[1], u, t[1]);
    }
    __syncwarp();
  }
}

// Every helper below starts with __syncwarp(), so that no lane writes a
// slot that a slower lane may still read (a lane that skipped a step by
// an early return runs ahead), and ends with one before its results are
// read.

// the point at slot a to infinity
template <class F>
__device__ void warp_set_inf(F* s, int a) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    f_zero(s[a]);
    f_one(s[a + 1]);
    f_zero(s[a + 2]);
  }
  __syncwarp();
}

// slots a .. a + 2 <-> raw words at p (one word a lane)
template <class F>
__device__ void warp_load(F* s, int a, const uint32_t* p) {
  __syncwarp();
  uint32_t* d = reinterpret_cast<uint32_t*>(&s[a]);
  for (int k = threadIdx.x & 31; k < 3 * FieldWords<F>::N; k += 32)
    d[k] = p[k];
  __syncwarp();
}

template <class F>
__device__ void warp_store(uint32_t* p, const F* s, int a) {
  __syncwarp();
  const uint32_t* d = reinterpret_cast<const uint32_t*>(&s[a]);
  for (int k = threadIdx.x & 31; k < 3 * FieldWords<F>::N; k += 32)
    p[k] = d[k];
  __syncwarp();
}

// s[a..a+2] = 2 s[a..a+2] (dbl-2009-l)
template <class F>
__device__ void warp_double(F* s, Fq* part, int a) {
  const int lane = threadIdx.x & 31;
  const int X = a, Y = a + 1, Z = a + 2;
  __syncwarp();
  if (f_is_zero(s[Z])) return;
  lanes_mul<F>(s, part, 3, MUL_OP(X, X, SA), MUL_OP(Y, Y, SB),
               MUL_OP(Y, Z, SU));
  if (lane == 0) f_add(s[ST], s[X], s[SB]);            // X + B
  if (lane == 1) {
    F e;
    f_add(e, s[SA], s[SA]);
    f_add(s[SE], e, s[SA]);                            // E = 3 A
  }
  __syncwarp();
  lanes_mul<F>(s, part, 3, MUL_OP(SB, SB, SC), MUL_OP(ST, ST, SD),
               MUL_OP(SE, SE, SF));
  if (lane == 0) {
    F d, x3;
    f_sub(d, s[SD], s[SA]);
    f_sub(d, d, s[SC]);
    f_add(d, d, d);                                    // D
    f_sub(x3, s[SF], d);
    f_sub(x3, x3, d);                                  // X3 = F - 2 D
    s[X] = x3;
    f_sub(s[SV], d, x3);
  }
  if (lane == 1) {
    F c8;
    f_add(c8, s[SC], s[SC]);
    f_add(c8, c8, c8);
    f_add(s[SW], c8, c8);                              // 8 C
  }
  if (lane == 2) f_add(s[Z], s[SU], s[SU]);            // Z3 = 2 Y Z
  __syncwarp();
  lanes_mul<F>(s, part, 1, MUL_OP(SE, SV, ST));
  if (lane == 0) f_sub(s[Y], s[ST], s[SW]);            // Y3 = E (D - X3) - 8 C
  __syncwarp();
}

// s[a..a+2] += s[q..q+2] (add-2007-bl, Z3 = 2 Z1 Z2 H), every case
template <class F>
__device__ void warp_add(F* s, Fq* part, int a, int q) {
  const int lane = threadIdx.x & 31;
  const int X1 = a, Y1 = a + 1, Z1 = a + 2;
  const int X2 = q, Y2 = q + 1, Z2 = q + 2;
  __syncwarp();
  if (f_is_zero(s[Z2])) return;
  const bool inf = f_is_zero(s[Z1]);
  __syncwarp();                    // every lane has read Z1
  if (inf) {
    if (lane == 0) {
      s[X1] = s[X2];
      s[Y1] = s[Y2];
      s[Z1] = s[Z2];
    }
    __syncwarp();
    return;
  }
  lanes_mul<F>(s, part, 5, MUL_OP(Z1, Z1, SA), MUL_OP(Z2, Z2, SB),
               MUL_OP(Y1, Z2, SC), MUL_OP(Y2, Z1, SD), MUL_OP(Z1, Z2, SE));
  lanes_mul<F>(s, part, 4, MUL_OP(X1, SB, SF), MUL_OP(X2, SA, ST),
               MUL_OP(SC, SB, SU), MUL_OP(SD, SA, SV));
  if (lane == 0) f_sub(s[SW], s[ST], s[SF]);           // H = U2 - U1
  if (lane == 1) f_sub(s[SD], s[SV], s[SU]);           // S2 - S1
  __syncwarp();
  if (f_is_zero(s[SW])) {
    if (f_is_zero(s[SD])) {
      warp_double(s, part, a);                         // P = Q
    } else {
      warp_set_inf(s, a);                              // P = -Q
    }
    return;
  }
  if (lane == 0) f_add(s[SA], s[SW], s[SW]);           // 2 H
  if (lane == 1) f_add(s[SD], s[SD], s[SD]);           // r = 2 (S2 - S1)
  __syncwarp();
  lanes_mul<F>(s, part, 3, MUL_OP(SA, SA, SB), MUL_OP(SD, SD, SC),
               MUL_OP(SE, SW, ST));                    // I, r^2, Z1 Z2 H
  if (lane == 0) f_add(s[Z1], s[ST], s[ST]);           // Z3
  __syncwarp();
  lanes_mul<F>(s, part, 2, MUL_OP(SW, SB, SE),         // J = H I
               MUL_OP(SF, SB, SV));                    // V = U1 I
  if (lane == 0) {
    F x3;
    f_sub(x3, s[SC], s[SE]);
    f_sub(x3, x3, s[SV]);
    f_sub(x3, x3, s[SV]);                              // X3 = r^2 - J - 2 V
    s[X1] = x3;
    f_sub(s[SA], s[SV], x3);
  }
  __syncwarp();
  lanes_mul<F>(s, part, 2, MUL_OP(SD, SA, SB),         // r (V - X3)
               MUL_OP(SU, SE, SC));                    // S1 J
  if (lane == 0) {
    F t;
    f_add(t, s[SC], s[SC]);
    f_sub(s[Y1], s[SB], t);                            // Y3
  }
  __syncwarp();
}

#define MSM_WARPS 4                // warps a block of the warp kernels
#define MSM_WARP_CHUNKS 8192       // an edge level of at most this many
                                   // chunks: one warp a chunk

// a warp's slots and the products' parts in shared memory
#define WARP_STATE(F)                                              \
  __shared__ F slots_[MSM_WARPS][N_SLOTS];                         \
  __shared__ Fq parts_[MSM_WARPS][15];                             \
  F* s = slots_[threadIdx.x / 32];                                 \
  Fq* part = parts_[threadIdx.x / 32];                             \
  const int64_t id = (int64_t)blockIdx.x * MSM_WARPS + threadIdx.x / 32

// An edge level of msm_chunks with few chunks (at most MSM_WARP_CHUNKS):
// one warp a chunk, the same runs and edge items, each full addition on
// the warp's lanes.  Only the buckets that span many chunks (the heavy
// bucket of the 0/1 witnesses) reach these levels, where the chains of
// additions, not their number, set the time.
template <class F>
__global__ void __launch_bounds__(MSM_WARPS * 32)
msm_edges_warp(const int32_t* __restrict__ keys,
               const uint32_t* __restrict__ src, int64_t count,
               int64_t chunks, int len, uint32_t* __restrict__ buckets,
               int32_t* __restrict__ out_keys,
               uint32_t* __restrict__ out_pts) {
  constexpr int fw = FieldWords<F>::N;
  WARP_STATE(F);
  if (id >= chunks) return;
  const int64_t t = id, start = t * len;
  const int64_t end = start + len < count ? start + len : count;
  int32_t head = MSM_NONE_BUCKET, tail = MSM_NONE_BUCKET;
  const int32_t before = start > 0 ? keys[start - 1] : MSM_NONE_BUCKET;
  const int32_t after = end < count ? keys[end] : MSM_NONE_BUCKET;
  warp_set_inf(s, PA);
  int32_t cur = keys[start];
  int64_t run = start;
  auto flush = [&](int64_t e) {    // as msm_chunks' flush
    if (cur == MSM_NONE_BUCKET) return;
    const bool from_before = run == start && before == cur;
    const bool on_after = e == end && after == cur;
    if (from_before) {
      head = cur;
      warp_store(out_pts + 2 * t * 3 * fw, s, PA);
      if (on_after) {
        tail = cur;
        for (int k = threadIdx.x & 31; k < 3 * fw; k += 32)
          out_pts[(2 * t + 1) * 3 * fw + k] = 0;
      }
    } else if (on_after) {
      tail = cur;
      warp_store(out_pts + (2 * t + 1) * 3 * fw, s, PA);
    } else {
      warp_store(buckets + (int64_t)cur * 3 * fw, s, PA);
    }
  };
  for (int64_t e = start; e < end; e++) {
    const int32_t b = keys[e];
    if (b != cur) {
      flush(e);
      cur = b;
      run = e;
      warp_set_inf(s, PA);
    }
    if (b == MSM_NONE_BUCKET) continue;
    warp_load(s, PQ, src + e * 3 * fw);
    warp_add(s, part, PA, PQ);
  }
  flush(end);
  if (out_keys != nullptr && (threadIdx.x & 31) == 0) {
    out_keys[2 * t] = head;
    out_keys[2 * t + 1] = tail;
  }
}

// A running-sum level above the first, one warp a segment of
// MSM_SEGMENT_HI items: msm_running's arithmetic (running at PA, sum at
// PB) with its totals times MSM_SEGMENT_HI.
template <class F>
__global__ void __launch_bounds__(MSM_WARPS * 32)
msm_running_warp(const uint32_t* __restrict__ in, int64_t in_stride,
                 int count, int groups, int windows,
                 uint32_t* __restrict__ sums, int64_t sums_stride,
                 uint32_t* __restrict__ totals) {
  constexpr int fw = FieldWords<F>::N;
  WARP_STATE(F);
  if (id >= (int64_t)windows * groups) return;
  const int w = (int)(id / groups), g = (int)(id % groups);
  warp_set_inf(s, PA);
  warp_set_inf(s, PB);
  const int lo = g * MSM_SEGMENT_HI;
  const int hi = lo + MSM_SEGMENT_HI < count ? lo + MSM_SEGMENT_HI : count;
  for (int i = hi - 1; i >= lo; i--) {
    warp_load(s, PQ, in + ((int64_t)w * in_stride + i) * 3 * fw);
    warp_add(s, part, PA, PQ);
    warp_add(s, part, PB, PA);
  }
  warp_store(sums + ((int64_t)w * sums_stride + g) * 3 * fw, s, PB);
  if (totals != nullptr) {
    for (int k = 0; k < MSM_SEGMENT_HI_BITS; k++) warp_double(s, part, PA);
    warp_store(totals + id * 3 * fw, s, PA);
  }
}

// One level of the window tree, one warp an output: items
// [g MSM_FAN, ...) of window w's `count` (at in + (w in_stride + i) 3 fw)
// summed into out[w groups + g].
template <class F>
__global__ void __launch_bounds__(MSM_WARPS * 32)
msm_tree(const uint32_t* __restrict__ in, int64_t in_stride, int count,
         int groups, int windows, uint32_t* __restrict__ out) {
  constexpr int fw = FieldWords<F>::N;
  WARP_STATE(F);
  if (id >= (int64_t)windows * groups) return;
  const int w = (int)(id / groups), g = (int)(id % groups);
  warp_set_inf(s, PA);
  const int lo = g * MSM_FAN;
  const int hi = lo + MSM_FAN < count ? lo + MSM_FAN : count;
  for (int i = lo; i < hi; i++) {
    warp_load(s, PQ, in + ((int64_t)w * in_stride + i) * 3 * fw);
    warp_add(s, part, PA, PQ);
  }
  warp_store(out + id * 3 * fw, s, PA);
}

// one warp: acc = 2^c acc + S_w from the top window down; the Jacobian
// result as canonical words ((0, 1, 0) at infinity)
template <class F>
__global__ void __launch_bounds__(32)
msm_combine(const uint32_t* __restrict__ windows_sums, int c, int windows,
            uint32_t* __restrict__ out) {
  __shared__ F s[N_SLOTS];
  __shared__ Fq part[15];
  const int fw = FieldWords<F>::N;
  warp_set_inf(s, PA);
  for (int w = windows - 1; w >= 0; w--) {
    for (int k = 0; k < c; k++) warp_double(s, part, PA);
    warp_load(s, PQ, windows_sums + (int64_t)w * 3 * fw);
    warp_add(s, part, PA, PQ);
  }
  if (threadIdx.x != 0) return;
  if (f_is_zero(s[PA + 2])) {
    for (int k = 0; k < 3 * fw; k++) out[k] = 0;
    out[fw] = 1;                     // (0, 1, 0)
    return;
  }
  f_store(out, s[PA]);
  f_store(out + fw, s[PA + 1]);
  f_store(out + 2 * fw, s[PA + 2]);
}

template <class F>
static int msm_prepare_launch(const void* points, const void* scalars,
                              int64_t n, int c, int windows, void* mont,
                              void* keys, void* stream) {
  if (n == 0) return 0;
  msm_prepare<F><<<blocks_for(n, MSM_THREADS), MSM_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)points, (const uint32_t*)scalars, (uint32_t*)mont,
      (int32_t*)keys, n, c, windows);
  return (int)cudaGetLastError();
}

template <class F>
static int msm_chunks_launch(const void* keys, const void* index,
                             const void* src, int64_t n, int c, int64_t count,
                             int64_t chunks, int len, int affine,
                             void* buckets, void* out_keys, void* out_pts,
                             void* stream) {
  if (chunks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (affine) {
    constexpr int T = MsmShape<F, true>::THREADS;
    msm_chunks<F, true><<<blocks_for(chunks, T), T, 0, st>>>(
        (const int32_t*)keys, (const int64_t*)index, (const uint32_t*)src, n,
        c, count, chunks, len, (uint32_t*)buckets, (int32_t*)out_keys,
        (uint32_t*)out_pts);
  } else if (chunks > MSM_WARP_CHUNKS) {
    constexpr int T = MsmShape<F, false>::THREADS;
    msm_chunks<F, false><<<blocks_for(chunks, T), T, 0, st>>>(
        (const int32_t*)keys, nullptr, (const uint32_t*)src, n, c, count,
        chunks, len, (uint32_t*)buckets, (int32_t*)out_keys,
        (uint32_t*)out_pts);
  } else {
    msm_edges_warp<F><<<blocks_for(chunks, MSM_WARPS), MSM_WARPS * 32, 0,
                        st>>>(
        (const int32_t*)keys, (const uint32_t*)src, count, chunks, len,
        (uint32_t*)buckets, (int32_t*)out_keys, (uint32_t*)out_pts);
  }
  return (int)cudaGetLastError();
}

// level 0: one thread a segment of MSM_SEGMENT buckets; above: one warp
// a segment of MSM_SEGMENT_HI items
template <class F>
static int msm_running_launch(const void* in, int64_t in_stride, int count,
                              int groups, int windows, int level, void* sums,
                              int64_t sums_stride, void* totals,
                              void* stream) {
  const int64_t n = (int64_t)windows * groups;
  cudaStream_t st = (cudaStream_t)stream;
  if (level == 0) {
    msm_running<F><<<blocks_for(n, MSM_THREADS), MSM_THREADS, 0, st>>>(
        (const uint32_t*)in, in_stride, count, groups, windows,
        (uint32_t*)sums, sums_stride, (uint32_t*)totals);
  } else {
    msm_running_warp<F><<<blocks_for(n, MSM_WARPS), MSM_WARPS * 32, 0, st>>>(
        (const uint32_t*)in, in_stride, count, groups, windows,
        (uint32_t*)sums, sums_stride, (uint32_t*)totals);
  }
  return (int)cudaGetLastError();
}

template <class F>
static int msm_tree_launch(const void* in, int64_t in_stride, int count,
                           int groups, int windows, void* out, void* stream) {
  msm_tree<F><<<blocks_for((int64_t)windows * groups, MSM_WARPS),
                MSM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, in_stride, count, groups, windows,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <class F>
static int msm_combine_launch(const void* windows_sums, int c, int windows,
                              void* out, void* stream) {
  msm_combine<F><<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)windows_sums, c, windows, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// -- fixed base -------------------------------------------------------------
//
// k_i G for a batch of scalars, affine words out (zeros for k_i = 0).
// Replaces native/msm.cpp fixed_base (:378, 8-bit windows over a table of
// 32 x 255 points) and its normalisations to affine, g1_normalize (:414,
// one inversion for the batch) and g2_normalize (:457, one a point).
//
// What bounds it: the 32-bit multiplies of the Montgomery products on the
// IMAD pipe.  A scalar reads 32 bytes and ~32 table entries (~2 KB of
// G1's 522 KB or G2's 1.04 MB table, which stay in the 50 MB L2) against
// ~32 mixed additions of ~2,700 (G1) or ~7,700 (G2) multiplies, so no
// staging of the table in shared memory pays.
//
// What the design does about it:
//  * 8-bit windows: the host builds entry (w, d) = d 2^(8w) G (w < 32,
//    1 <= d <= 255; affine, Montgomery form; ops/bn254_msm.py
//    _window_table), so a scalar costs one mixed addition a nonzero byte
//    (<= 32) instead of one a set bit (~127).  The first nonzero byte sets
//    the accumulator (jac_add_affine's infinity branch); the H = 0
//    branches stay, so any 256-bit input is exact.
//  * One Fermat inverse a block: Montgomery's trick over the block's Z in
//    shared memory, a product tree up (THREADS - 1 products), one f_inv
//    of the root by thread 0, and back down (two products a node), so a
//    point costs ~3 products and f_inv / THREADS instead of a whole f_inv
//    (~360 products).  A lane at infinity, or past n, enters as 1.
//  * The register file: the curve formulas keep few values live
//    (bn254_curve.cuh; an Fq2 square is two Fq products) and
//    __launch_bounds__ caps the registers.  G1 takes 640 threads a block
//    (one block, 20 warps an SM: the inverse, ~360 serial products by
//    one thread, is shared by more scalars); G2 128 threads and three
//    blocks an SM (12 warps, within 168 registers, which ptxas meets
//    without spills at -O1: kernels.py LIB_FLAGS).
// ops/bn254_msm.py _fixed_base_plain is the same function step for step.

#define FB_WINDOWS 32              // 8-bit windows (32 x 8 >= 254 bits)
#define FB_DIGITS 255              // table entries a window, d = 1..255

// the fixed-base kernel's block width (one scalar a thread, one inverse a
// block) and the blocks an SM must hold
template <class F> struct FixedBaseShape;
template <> struct FixedBaseShape<Fq> {
  static constexpr int THREADS = 640, MIN_BLOCKS = 1;
};
template <> struct FixedBaseShape<Fq2> {
  static constexpr int THREADS = 128, MIN_BLOCKS = 3;
};

// the highest power of two in x >= 1
__host__ __device__ constexpr int high_bit(int x) {
  return x & (x - 1) ? high_bit(x & (x - 1)) : x;
}

template <class F>
__global__ void __launch_bounds__(FixedBaseShape<F>::THREADS,
                                  FixedBaseShape<F>::MIN_BLOCKS)
fixed_base(const uint32_t* __restrict__ table,
           const uint32_t* __restrict__ scalars, uint32_t* __restrict__ out,
           int64_t n) {
  constexpr int T = FixedBaseShape<F>::THREADS;
  const int fw = FieldWords<F>::N;
  __shared__ F tree[2 * T];        // node k's children 2k, 2k + 1; leaves T..
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * T + t;
  Jac<F> acc;
  jac_set_inf(acc);
  if (i < n) {
    uint32_t word = 0;
    for (int w = 0; w < FB_WINDOWS; w++) {
      if ((w & 3) == 0) word = scalars[i * 8 + (w >> 2)];
      const uint32_t d = (word >> (8 * (w & 3))) & 0xFF;
      if (d == 0) continue;
      const uint32_t* e =
          table + ((int64_t)w * FB_DIGITS + d - 1) * 2 * fw;
      F x, y;
      f_load_raw(x, e);
      f_load_raw(y, e + fw);
      jac_add_affine(acc, acc, x, y);
    }
  }
  // Montgomery's trick: tree[k] = the product of its leaves, then
  // tree[k] = its inverse from the root down.  Node k < T has children
  // 2k and 2k + 1, so every T works; a round takes the nodes in [s, 2s).
  const bool inf = jac_is_inf(acc);
  if (inf) {
    f_one(tree[T + t]);
  } else {
    tree[T + t] = acc.z;
  }
  constexpr int TOP = high_bit(T - 1);        // the tree's first round
  for (int s = TOP; s > 0; s >>= 1) {
    __syncthreads();
    const int k = s + t;
    if (t < s && k < T) f_mul(tree[k], tree[2 * k], tree[2 * k + 1]);
  }
  __syncthreads();
  if (t == 0) f_inv(tree[1], tree[1]);
  for (int s = 1; s <= TOP; s <<= 1) {
    __syncthreads();
    const int k = s + t;
    if (t < s && k < T) {
      const F left = tree[2 * k];
      f_mul(tree[2 * k], tree[k], tree[2 * k + 1]);
      f_mul(tree[2 * k + 1], tree[k], left);
    }
  }
  __syncthreads();
  if (i >= n) return;
  uint32_t* o = out + i * 2 * fw;
  if (inf) {
    for (int w = 0; w < 2 * fw; w++) o[w] = 0;
    return;
  }
  F zi = tree[T + t], zi2, v;
  f_mul(zi2, zi, zi);
  f_mul(v, acc.x, zi2);
  f_store(o, v);
  f_mul(zi2, zi2, zi);
  f_mul(v, acc.y, zi2);
  f_store(o + fw, v);
}

template <class F>
static int fixed_base_launch(const void* table, const void* scalars,
                             void* out, int64_t n, void* stream) {
  constexpr int T = FixedBaseShape<F>::THREADS;
  fixed_base<F><<<(unsigned)((n + T - 1) / T), T, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
