// bn254_msm_g1 and bn254_fixed_base_g1: the kernels of bn254_msm.cuh
// over BN254's G1 (Fq coordinates).
#include "bn254_msm.cuh"

extern "C" {

int bn254_msm_g1_launch(const void* points, int64_t n, const int32_t* point,
                        const int32_t* run_start, const int32_t* run_end,
                        int64_t n_runs, const int32_t* first_run, int c,
                        int n_windows, int segments, void* scratch, void* out,
                        void* stream) {
  return msm_launch<Fq>(points, n, point, run_start, run_end, n_runs,
                        first_run, c, n_windows, segments, scratch, out,
                        stream);
}

int bn254_fixed_base_g1_launch(const void* table, const void* scalars,
                               void* out, int64_t n, void* stream) {
  return fixed_base_launch<Fq>(table, scalars, out, n, stream);
}

}  // extern "C"
