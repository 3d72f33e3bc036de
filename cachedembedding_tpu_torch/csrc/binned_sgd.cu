// Fused embedding backward + SGD update for Hopper (sm_90a): the port of the
// TPU kernel cachedembedding_tpu/ops/binned_scatter.py::_kernel_sgd (wrapper
// binned_sgd_update). Python side: cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   cw[v] <- round(cw[v] - slr * sum_{i : ids[i] == v} g[i])   (in place)
//
// The host ships a bin grouping of the step's id stream (sort_plan): perm,
// ids_grouped = ids[perm] and bin_starts, stable by id / R. Bin b owns rows
// [R*b, R*(b+1)) and its contributors are the contiguous range
// [bin_starts[b], bin_starts[b+1]) of the grouped stream.
//
// Design: one thread block per bin. The bin's (R, D) f32 accumulator lives in
// shared memory (R = 64, D = 128: 32 KB; the TPU kernel's 512-row f32 tile
// would be 256 KB, more than the 227 KB a block can have). Threads own
// columns and walk the bin's range in stream order, reading g[perm[e]]
// directly, so no permuted copy of g is made; 8 elements are loaded ahead of
// their adds for memory-level parallelism, and the adds keep stream order.
// Rows that received a contribution are flagged and written once as
// round(cw - slr*acc) with one rounding to the storage dtype; untouched rows
// are never written, so they stay bit-exact. No atomics: the sum order is
// fixed, so results are the same bits from run to run.
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

namespace {

constexpr int kAhead = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) acc[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += blockDim.x) touched[i] = 0;
  __syncthreads();
  const int64_t row0 = b * R;
  for (int base = s; base < e; base += kAhead) {
    int src[kAhead];
    int loc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + u;
      src[u] = i < e ? __ldg(perm + i) : -1;
      loc[u] = i < e ? static_cast<int>(__ldg(grouped + i) - row0) : 0;
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (src[u] >= 0) touched[loc[u]] = 1;
    }
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        v[u] = src[u] >= 0 ? to_f32(g[static_cast<int64_t>(src[u]) * D + c]) : 0.f;
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (src[u] >= 0) acc[loc[u] * D + c] += v[u];
    }
  }
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    if (!touched[r]) continue;  // same branch for every thread of the block
    T* row = cw + (row0 + r) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float w = to_f32(row[c]);
      row[c] = from_f32<T>(__fsub_rn(w, __fmul_rn(slr, acc[r * D + c])));
    }
  }
}

template <typename T>
int launch(void* cw, const void* g, const int32_t* perm, const int32_t* grouped,
           const int32_t* bin_starts, int64_t num_bins, int D, int R, float slr,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * D * sizeof(float) + R * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binned_sgd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = D < 256 ? ((D + 31) / 32) * 32 : 256;
  binned_sgd_kernel<T><<<static_cast<unsigned>(num_bins), threads, smem, stream>>>(
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
