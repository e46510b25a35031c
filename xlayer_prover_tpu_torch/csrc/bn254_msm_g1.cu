// bn254_msm_g1 and bn254_fixed_base_g1: the kernels of bn254_msm.cuh
// over BN254's G1 (Fq coordinates).
#include "bn254_msm.cuh"

extern "C" {

int bn254_msm_g1_prepare(const void* points, const void* scalars, int64_t n,
                         int c, int windows, void* mont, void* keys,
                         void* stream) {
  return msm_prepare_launch<Fq>(points, scalars, n, c, windows, mont, keys,
                                stream);
}

int bn254_msm_g1_chunks(const void* keys, const void* index, const void* src,
                        int64_t n, int c, int64_t count, int64_t chunks,
                        int len, int affine, void* buckets, void* out_keys,
                        void* out_pts, void* stream) {
  return msm_chunks_launch<Fq>(keys, index, src, n, c, count, chunks, len,
                               affine, buckets, out_keys, out_pts, stream);
}

int bn254_msm_g1_running(const void* in, int64_t in_stride, int count,
                         int groups, int windows, int level, void* sums,
                         int64_t sums_stride, void* totals, void* stream) {
  return msm_running_launch<Fq>(in, in_stride, count, groups, windows, level,
                                sums, sums_stride, totals, stream);
}

int bn254_msm_g1_tree(const void* in, int64_t in_stride, int count, int groups,
                      int windows, void* out, void* stream) {
  return msm_tree_launch<Fq>(in, in_stride, count, groups, windows, out,
                             stream);
}

int bn254_msm_g1_combine(const void* windows_sums, int c, int windows,
                         void* out, void* stream) {
  return msm_combine_launch<Fq>(windows_sums, c, windows, out, stream);
}

int bn254_fixed_base_g1_launch(const void* table, const void* scalars,
                               void* out, int64_t n, void* stream) {
  return fixed_base_launch<Fq>(table, scalars, out, n, stream);
}

}  // extern "C"
