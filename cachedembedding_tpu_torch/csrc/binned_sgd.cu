// Fused embedding backward + SGD update for Hopper (sm_90a): the port of the
// TPU kernel cachedembedding_tpu/ops/binned_scatter.py::_kernel_sgd (wrapper
// binned_sgd_update). Python side: cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   cw[v] <- round(cw[v] - slr * sum_{i : ids[i] == v} g[i])   (in place)
//
// Design: one thread block per bin of the host's grouping plan; the bin walk
// (binned_walk.cuh) sums the bin's contributions into an (R, D) f32
// accumulator in shared memory (R = 64, D = 128: 32 KB; the TPU kernel's
// 512-row f32 tile would be 256 KB, more than the 227 KB a block can have).
// Rows that received a contribution are flagged and written once as
// round(cw - slr*acc) with one rounding to the storage dtype; untouched rows
// are never written, so they stay bit-exact.
//
// What bounds it: bytes — g (L*D*elt) plus perm and ids (8 B each per
// element) plus a read and a write of each touched row. At the main-path shape
// that is about 109 MB of g and some 30 us at 3.35 TB/s. Skewed streams
// serialize: the small resident tables put tens of thousands of ids into a
// handful of bins, and one block walks each of those bins alone. That is
// correct and slow; splitting heavy bins is later work.
//
// C interface, loaded with ctypes: returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "binned_walk.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void binned_sgd_kernel(T* __restrict__ cw, const T* __restrict__ g,
                                  const int32_t* __restrict__ perm,
                                  const int32_t* __restrict__ grouped,
                                  const int32_t* __restrict__ bin_starts, int D,
                                  int R, float slr) {
  extern __shared__ float smem[];
  float* acc = smem;                                      // (R, D) f32
  int* touched = reinterpret_cast<int*>(smem + R * D);   // (R,)
  const int64_t b = blockIdx.x;
  const int s = bin_starts[b];
  const int e = bin_starts[b + 1];
  if (s == e) return;  // nobody touched this bin: nothing to write
  const int64_t row0 = b * R;
  binned::accumulate_bin<true>(acc, touched, g, perm, grouped, s, e, row0, D, R);
  for (int r = 0; r < R; ++r) {
    if (!touched[r]) continue;  // same branch for every thread of the block
    T* row = cw + (row0 + r) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float w = binned::to_f32(row[c]);
      row[c] = from_f32<T>(__fsub_rn(w, __fmul_rn(slr, acc[r * D + c])));
    }
  }
}

template <typename T>
int launch(void* cw, const void* g, const int32_t* perm, const int32_t* grouped,
           const int32_t* bin_starts, int64_t num_bins, int D, int R, float slr,
           cudaStream_t stream) {
  const size_t smem = binned::smem_bytes(R, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binned_sgd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  binned_sgd_kernel<T><<<static_cast<unsigned>(num_bins), binned::threads_for(D), smem,
                         stream>>>(
      static_cast<T*>(cw), static_cast<const T*>(g), perm, grouped, bin_starts, D, R,
      slr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (cw and g share it).
extern "C" int binned_sgd_launch(void* cw, const void* g, const int32_t* perm,
                                 const int32_t* grouped, const int32_t* bin_starts,
                                 int64_t num_bins, int64_t D, int64_t R, float slr,
                                 int dtype, void* stream) {
  if (num_bins == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(cw, g, perm, grouped, bin_starts, num_bins,
                         static_cast<int>(D), static_cast<int>(R), slr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(cw, g, perm, grouped, bin_starts, num_bins,
                                 static_cast<int>(D), static_cast<int>(R), slr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
