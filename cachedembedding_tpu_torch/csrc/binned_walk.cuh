// The bin walk shared by binned_sgd.cu (Kernel 2) and binned_scatter_add.cu
// (Kernel 3): one thread block sums the contributions of one bin of the host's
// grouping plan into an (R, D) f32 accumulator in shared memory.
//
// The plan (sort_plan) groups the step's id stream stably by id / R: perm,
// ids_grouped = ids[perm] and bin_starts. Bin b owns rows [R*b, R*(b+1)) and
// its contributors are the contiguous range [bin_starts[b], bin_starts[b+1])
// of the grouped stream. Threads own columns and walk the range in stream
// order, reading g[perm[e]] directly, so no permuted copy of g is made; kAhead
// elements are loaded ahead of their adds for memory-level parallelism, and
// the adds keep stream order. No atomics: the sum order is fixed, so two
// launches give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace binned {

constexpr int kAhead = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// acc (R * D floats) <- sum over e in [s, e) of g[perm[e]] into row
// grouped[e] - row0. With kFlagRows, rows that receive a contribution are
// flagged in touched (R ints). Ends with __syncthreads(): acc is complete.
// Forced inline: without it Kernel 2 ran some 23% slower on the H100 (13.2
// against 10.8 ms on the bf16 slice's first step, timed in one run by
// tools/kernel_ab.py).
template <bool kFlagRows, typename G>
__device__ __forceinline__ void accumulate_bin(float* acc, int* touched,
                                               const G* __restrict__ g,
                                               const int32_t* __restrict__ perm,
                                               const int32_t* __restrict__ grouped, int s,
                                               int e, int64_t row0, int D, int R) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) acc[i] = 0.f;
  if (kFlagRows)
    for (int i = threadIdx.x; i < R; i += blockDim.x) touched[i] = 0;
  __syncthreads();
  for (int base = s; base < e; base += kAhead) {
    int src[kAhead];
    int loc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + u;
      src[u] = i < e ? __ldg(perm + i) : -1;
      loc[u] = i < e ? static_cast<int>(__ldg(grouped + i) - row0) : 0;
    }
    if (kFlagRows && threadIdx.x == 0) {
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
}

// Dynamic shared memory of the walk: the (R, D) f32 accumulator plus R flags.
inline size_t smem_bytes(int R, int D) {
  return static_cast<size_t>(R) * D * sizeof(float) + R * sizeof(int);
}

// Threads per block: the columns, rounded up to a warp, at most 256.
inline int threads_for(int D) { return D < 256 ? ((D + 31) / 32) * 32 : 256; }

}  // namespace binned
