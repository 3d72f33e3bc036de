// Binned scatter-add for Hopper (sm_90a): the port of the TPU kernel
// cachedembedding_tpu/ops/binned_scatter.py::_kernel (line 64; wrappers
// binned_scatter_add_grouped / binned_scatter_add). Python side:
// cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   out = zeros((num_rows, D), f32); out[ids[i]] += g[i]   for i in [0, L)
//
// The full (num_rows, D) f32 grad of the embedding gather, which the
// stochastic-rounding update (train/trainer.py) turns into cw - slr * out.
//
// What bounds it: bytes. perm and ids (8 B per element), g (L*D*elt) and the
// (num_rows, D) f32 output written once. On the fp8 slice's first step (L =
// 425,984, D = 128 bf16 grads, 901,228 rows) that is about 574 MB and
// 0.171 ms at 3.35 TB/s, 461 MB of it the output.
//
// Design: the output is written in two passes, both streaming. First a
// zero-fill kernel writes the whole (num_rows, D) output, 16 B a thread; that
// is the bound's largest term. Then the run reduction of row_runs.cuh (shared
// with Kernel 2) writes each touched row once: the host plan sorts the stream
// by row, one warp sums each chunk of 64 contributors in registers, each grad
// row one coalesced 8-B (bf16) or 16-B (f32) load a lane with kUnroll in
// flight, and a second launch finishes the runs that cross chunks. Every SM
// streams grad rows whatever the skew, and no atomics are used: two launches
// give the same bits. The TPU kernel instead ran a one-hot matmul per (bin,
// chunk) visit on the MXU over a sequential grid: 64x the arithmetic of the
// sums, which are bytes-bound here.
//
// C interface, loaded with ctypes: three CUDA launches per call (the zero
// fill, the chunks, the crossing runs); returns the first non-zero
// cudaGetLastError(). A plan not sorted by id stops the chunk launch with a
// device-side assert.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "row_runs.cuh"

namespace {

struct Nothing {};

// out[row] <- acc.
struct ScatterEpilogue {
  static constexpr bool kStaged = false;  // the chunks' loads overlap their sums: chunk_kernel
  float* out;

  template <int VEC>
  using Pre = Nothing;

  template <int VEC>
  __device__ __forceinline__ Nothing prefetch(int, int, int) const {
    return {};
  }

  template <int VEC>
  __device__ __forceinline__ void apply(int row, int col, int D, const float* acc, Nothing,
                                        bool mine) const {
    if (mine) row_runs::store<VEC>(out + static_cast<int64_t>(row) * D + col, acc);
  }
};

// out[0:n) <- 0, 16 B a thread where the vector part allows.
__global__ void zero_kernel(float* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t i = t; i < n4; i += stride) out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = 4 * n4 + t; i < n; i += stride) out[i] = 0.f;
}

template <typename G>
int launch(float* out, const void* g, const int32_t* perm, const int32_t* ids, void* partials,
           int64_t L, int64_t num_rows, int64_t D, cudaStream_t stream) {
  const int64_t n = num_rows * D;
  if (n > 0) {
    const int64_t threads = 256, want = (n / 4 + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
    zero_kernel<<<blocks, threads, 0, stream>>>(out, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return row_runs::launch<G>(ScatterEpilogue{out}, g, perm, ids, partials, L, D,
                             reinterpret_cast<uintptr_t>(out) % 16 == 0, stream);
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16; out is float32, 16-byte aligned. ids:
// the plan's ids_grouped, sorted. partials: (2 * ceil(L / 64), D) f32 scratch.
extern "C" int binned_scatter_add_launch(void* out, const void* g, const int32_t* perm,
                                         const int32_t* ids, void* partials, int64_t L,
                                         int64_t num_rows, int64_t D, int g_dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (g_dtype == 0) return launch<float>(o, g, perm, ids, partials, L, num_rows, D, st);
  if (g_dtype == 1)
    return launch<__nv_bfloat16>(o, g, perm, ids, partials, L, num_rows, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
