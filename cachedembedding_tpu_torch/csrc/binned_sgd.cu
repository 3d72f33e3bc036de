// Fused embedding backward + SGD update for Hopper (sm_90a): the port of the
// TPU kernel cachedembedding_tpu/ops/binned_scatter.py::_kernel_sgd (line 199;
// wrapper binned_sgd_update). Python side:
// cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   cw[v] <- round(cw[v] - slr * sum_{i : ids[i] == v} g[i])   (in place)
//
// What bounds it: bytes. g (L*D*elt), perm and ids (8 B per element), and a
// read and a write of each touched row. On the bf16 slice's first step (L =
// 425,984, D = 128 bf16, 15,982 touched rows) that is about 109 MB of g and
// 0.036 ms at 3.35 TB/s; the sums are some 0.5 f32 add per byte, far below
// what would make it bound by operations. The TPU kernel's one-hot matmul per
// bin would do 64x that arithmetic for nothing here.
//
// Design (row_runs.cuh): the host plan sorts the stream by row, the sorted
// stream is cut into chunks of 64 contributors, and one warp sums each chunk's
// runs of equal rows in registers, every grad row a coalesced 8-B-a-lane load
// with kUnroll of them in flight. So every SM streams grad rows whatever the
// skew: the step's heaviest row (11,368 ids) is spread over 178 warps
// instead of one block walking its bin. A run inside a chunk writes its row
// once as round(cw - slr*acc), one rounding to the storage dtype; a run that
// crosses chunks is finished by a second launch from per-chunk partial sums.
// Rows nobody touched are never written, so they stay bit-exact.
//
// C interface, loaded with ctypes: two CUDA launches per call (one when the
// stream fits one chunk); returns the first non-zero cudaGetLastError(). A
// plan not sorted by id stops the first launch with a device-side assert.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "row_runs.cuh"

namespace {

// cw[row] <- round(cw[row] - slr * acc), cw's row loaded ahead of the sum.
template <typename T>
struct SgdEpilogue {
  T* cw;
  float slr;

  template <int VEC>
  using Pre = typename row_runs::Pack<T, VEC>::type;

  template <int VEC>
  __device__ __forceinline__ Pre<VEC> prefetch(int row, int col, int D) const {
    return row_runs::load<VEC>(cw + static_cast<int64_t>(row) * D + col);
  }

  template <int VEC>
  __device__ __forceinline__ void apply(int row, int col, int D, const float* acc,
                                        Pre<VEC> pre) const {
    float w[VEC];
    row_runs::unpack(pre, w);
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = __fsub_rn(w[k], __fmul_rn(slr, acc[k]));
    row_runs::store<VEC>(cw + static_cast<int64_t>(row) * D + col, w);
  }
};

template <typename T>
int launch(void* cw, const void* g, const int32_t* perm, const int32_t* ids, void* partials,
           int64_t L, int64_t D, float slr, cudaStream_t stream) {
  const SgdEpilogue<T> epi{static_cast<T*>(cw), slr};
  return row_runs::launch<T>(epi, g, perm, ids, partials, L, D,
                             reinterpret_cast<uintptr_t>(cw) % 16 == 0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (cw and g share it). ids: the plan's
// ids_grouped, sorted. partials: (2 * ceil(L / 64), D) f32 scratch.
extern "C" int binned_sgd_launch(void* cw, const void* g, const int32_t* perm,
                                 const int32_t* ids, void* partials, int64_t L, int64_t D,
                                 float slr, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(cw, g, perm, ids, partials, L, D, slr, st);
  if (dtype == 1) return launch<__nv_bfloat16>(cw, g, perm, ids, partials, L, D, slr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
