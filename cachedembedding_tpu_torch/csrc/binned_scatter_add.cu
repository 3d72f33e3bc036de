// Binned scatter-add for Hopper (sm_90a): the port of the TPU kernel
// cachedembedding_tpu/ops/binned_scatter.py::_kernel (wrappers
// binned_scatter_add_grouped / binned_scatter_add). Python side:
// cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   out = zeros((num_rows, D), f32); out[ids[i]] += g[i]   for i in [0, L)
//
// The full (num_rows, D) f32 grad of the embedding gather, which the
// stochastic-rounding update (train/trainer.py) turns into cw - slr * out.
//
// Design: one thread block per bin of the host's grouping plan. The bin walk
// (binned_walk.cuh, shared with Kernel 2) sums the bin's contributors into a
// (64, D) f32 accumulator in shared memory (32 KB at D = 128), in stream
// order and without atomics, so two launches give the same bits. Then the
// block writes every row of its bin, untouched rows as exact zeros; an empty
// bin writes zeros without walking, and the last bin stops at num_rows. The
// TPU kernel instead ran a one-hot matmul per (bin, chunk) visit on the MXU
// over a sequential grid; Hopper's blocks run in no order, so each owns a bin.
//
// What bounds it: bytes — perm and ids (8 B per element), g (L*D*elt) and the
// (num_rows, D) f32 output written once. At the main-path shape (L = 425,984,
// D = 128 bf16, 901,228 rows) that is about 574 MB, some 0.171 ms at
// 3.35 TB/s, most of it the output. It inherits Kernel 2's cost on skewed
// streams: one block walks each heavy bin alone.
//
// C interface, loaded with ctypes: returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "binned_walk.cuh"

namespace {

template <typename G>
__global__ void binned_scatter_add_kernel(float* __restrict__ out, const G* __restrict__ g,
                                          const int32_t* __restrict__ perm,
                                          const int32_t* __restrict__ grouped,
                                          const int32_t* __restrict__ bin_starts,
                                          int64_t num_rows, int D, int R) {
  extern __shared__ float acc[];  // (R, D) f32
  const int64_t b = blockIdx.x;
  const int s = bin_starts[b];
  const int e = bin_starts[b + 1];
  const int64_t row0 = b * R;
  const int64_t rows = num_rows - row0 < R ? num_rows - row0 : R;
  float* dst = out + row0 * D;
  if (s == e) {  // nobody touched this bin: its rows are zeros
    for (int64_t i = threadIdx.x; i < rows * D; i += blockDim.x) dst[i] = 0.f;
    return;
  }
  binned::accumulate_bin<false>(acc, nullptr, g, perm, grouped, s, e, row0, D, R);
  for (int64_t i = threadIdx.x; i < rows * D; i += blockDim.x) dst[i] = acc[i];
}

template <typename G>
int launch(float* out, const void* g, const int32_t* perm, const int32_t* grouped,
           const int32_t* bin_starts, int64_t num_bins, int64_t num_rows, int D, int R,
           cudaStream_t stream) {
  const size_t smem = binned::smem_bytes(R, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        binned_scatter_add_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  binned_scatter_add_kernel<G><<<static_cast<unsigned>(num_bins), binned::threads_for(D),
                                 smem, stream>>>(
      out, static_cast<const G*>(g), perm, grouped, bin_starts, num_rows, D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16; out is always float32.
extern "C" int binned_scatter_add_launch(void* out, const void* g, const int32_t* perm,
                                         const int32_t* grouped, const int32_t* bin_starts,
                                         int64_t num_bins, int64_t num_rows, int64_t D,
                                         int64_t R, int g_dtype, void* stream) {
  if (num_bins == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (g_dtype == 0)
    return launch<float>(o, g, perm, grouped, bin_starts, num_bins, num_rows,
                         static_cast<int>(D), static_cast<int>(R), st);
  if (g_dtype == 1)
    return launch<__nv_bfloat16>(o, g, perm, grouped, bin_starts, num_bins, num_rows,
                                 static_cast<int>(D), static_cast<int>(R), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
