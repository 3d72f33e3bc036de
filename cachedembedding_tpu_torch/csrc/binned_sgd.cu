// Fused embedding backward + SGD or row-wise Adagrad update for Hopper
// (sm_90a): the port of the TPU kernel
// cachedembedding_tpu/ops/binned_scatter.py::_kernel_sgd (line 199; wrapper
// binned_sgd_update), and of the Adagrad update that the JAX trainer runs on
// the (C, D) f32 grad (train/trainer.py, _scan_window). Python side:
// cachedembedding_tpu_torch/ops/binned_scatter.py.
//
//   SGD:      cw[v] <- round(cw[v] - slr * s_v)                      (in place)
//   Adagrad:  acc[v] <- acc[v] + mean(s_v * s_v)
//             cw[v] <- round(cw[v] - slr * s_v / (sqrt(acc[v]) + eps))
//   with s_v = sum_{i : ids[i] == v} g[i] in f32.
//
// Rows are f32, bf16, float8_e4m3fn or float8_e5m2; the grads have the rows'
// dtype or are f32. round() is the one cast to the rows' dtype, to nearest
// even as jnp.astype casts (row_runs.cuh, Cvt).
//
// What bounds it: bytes. g (L*D*elt), perm and ids (8 B per element), and a
// read and a write of each touched row (and, for Adagrad, of its 4-byte
// accumulator). On the bf16 slice's first step (L = 425,984, D = 128 bf16,
// 15,982 touched rows) that is about 109 MB of g and 0.036 ms at 3.35 TB/s;
// the sums are some 0.5 f32 add per byte, far below what would make it bound
// by operations. The TPU kernel's one-hot matmul per bin would do 64x that
// arithmetic for nothing here.
//
// Design (row_runs.cuh): the host plan sorts the stream by row, the sorted
// stream is cut into chunks of 64 contributors, and one warp sums each chunk's
// runs of equal rows in registers, every grad row a coalesced 8-B-a-lane load
// with kUnroll of them in flight. So every SM streams grad rows whatever the
// skew: the step's heaviest row (11,368 ids) is spread over 178 warps
// instead of one block walking its bin. A run inside a chunk writes its row
// once, one rounding to the storage dtype; a run that crosses chunks is
// finished by a second launch from per-chunk partial sums. Rows nobody
// touched are never written, so they and their accumulators stay bit-exact.
// fp8 rows are narrowed by the card's conversion (row_runs.cuh, CvtFp8): the
// emulated no-saturation cast it replaces took about half of every fp8-row
// entry's time. The Adagrad epilogue takes the row's mean square by a warp
// reduction over the lanes' columns (so it needs the whole row in one warp:
// D <= 128 on the 4-a-lane path, D <= 32 on the one-a-lane path), updates
// acc[v], scales and writes the row: the (C, D) f32 grad that JAX builds is
// never made (on the resident Criteo-Kaggle table it would be 17.3 GB,
// zero-filled every step). Its chain (five dependent shuffles, a square root,
// divisions) stalled the loads of the warp that ran it, so the Adagrad
// launch stages each chunk's grad rows in shared memory by bulk copies and
// runs its final runs' epilogues eight at a time, interleaved
// (apply_group); each row's arithmetic, and so its bits, is unchanged.
//
// C interface, loaded with ctypes: two CUDA launches per call (one when the
// stream fits one chunk); returns the first launch error. A plan not sorted
// by id stops the first launch with a device-side assert.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "row_runs.cuh"

namespace {

// cw[row] <- round(cw[row] - slr * acc), cw's row loaded ahead of the sum.
template <typename T>
struct SgdEpilogue {
  static constexpr bool kStaged = false;  // the chunks' loads overlap their sums: chunk_kernel
  T* cw;
  float slr;

  template <int VEC>
  using Pre = typename row_runs::Pack<T, VEC>::type;

  template <int VEC>
  __device__ __forceinline__ Pre<VEC> prefetch(int row, int col, int D) const {
    return row_runs::load<VEC>(cw + static_cast<int64_t>(row) * D + col);
  }

  template <int VEC>
  __device__ __forceinline__ void apply(int row, int col, int D, const float* acc, Pre<VEC> pre,
                                        bool mine) const {
    if (!mine) return;
    float w[VEC];
    row_runs::unpack<T>(pre, w);
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = __fsub_rn(w[k], __fmul_rn(slr, acc[k]));
    row_runs::store<VEC>(cw + static_cast<int64_t>(row) * D + col, w);
  }
};

template <typename P>
struct RowAndAccum {
  P w;
  float a;
};

// Row-wise Adagrad (torchrec's ROWWISE_ADAGRAD, as the JAX trainer computes
// it on the f32 grad): a <- a + sum(s*s) / D, then
// cw <- round(cw - slr * (s / (sqrt(a) + eps))). The row and its accumulator
// are loaded ahead of the sum.
template <typename T>
struct AdagradEpilogue {
  static constexpr bool kStaged = true;  // the epilogues of several runs at once: staged_chunk_kernel
  T* cw;
  float* accum;
  float slr;
  float eps;

  template <int VEC>
  using Pre = RowAndAccum<typename row_runs::Pack<T, VEC>::type>;

  template <int VEC>
  __device__ __forceinline__ Pre<VEC> prefetch(int row, int col, int D) const {
    return {row_runs::load<VEC>(cw + static_cast<int64_t>(row) * D + col), accum[row]};
  }

  template <int VEC>
  __device__ __forceinline__ void apply(int row, int col, int D, const float* acc, Pre<VEC> pre,
                                        bool mine) const {
    float ss = 0.f;  // lanes past D summed copies of column 0: they add nothing
#pragma unroll
    for (int k = 0; k < VEC; ++k) ss = mine ? __fadd_rn(ss, __fmul_rn(acc[k], acc[k])) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(row_runs::kFull, ss, o));
    const float a = __fadd_rn(pre.a, __fdiv_rn(ss, static_cast<float>(D)));
    const float den = __fadd_rn(__fsqrt_rn(a), eps);
    if ((threadIdx.x & 31) == 0) accum[row] = a;
    if (!mine) return;
    float w[VEC];
    row_runs::unpack<T>(pre.w, w);
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = __fsub_rn(w[k], __fmul_rn(slr, __fdiv_rn(acc[k], den)));
    row_runs::store<VEC>(cw + static_cast<int64_t>(row) * D + col, w);
  }

  // The group's rows at once, each as apply computes it (the same bits): the
  // mean squares' shuffle trees interleaved, then every row's square root
  // and divisions, independent of one another, then the writes of the final
  // runs (fins). pre of a run that is not final is zero.
  template <int VEC, int N>
  __device__ __forceinline__ void apply_group(const int* row, int col, int D, float (*acc)[VEC],
                                              const Pre<VEC>* pre, unsigned fins, bool mine) const {
    float ss[N], a[N], w[N][VEC];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      ss[u] = 0.f;  // lanes past D summed copies of column 0: they add nothing
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss[u] = mine ? __fadd_rn(ss[u], __fmul_rn(acc[u][k], acc[u][k])) : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < N; ++u) ss[u] = __fadd_rn(ss[u], __shfl_xor_sync(row_runs::kFull, ss[u], o));
#pragma unroll
    for (int u = 0; u < N; ++u) {
      a[u] = __fadd_rn(pre[u].a, __fdiv_rn(ss[u], static_cast<float>(D)));
      const float den = __fadd_rn(__fsqrt_rn(a[u]), eps);
      row_runs::unpack<T>(pre[u].w, w[u]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) w[u][k] = __fsub_rn(w[u][k], __fmul_rn(slr, __fdiv_rn(acc[u][k], den)));
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (!((fins >> u) & 1)) continue;
      if ((threadIdx.x & 31) == 0) accum[row[u]] = a[u];
      if (mine) row_runs::store<VEC>(cw + static_cast<int64_t>(row[u]) * D + col, w[u]);
    }
  }
};

template <typename T, typename G>
int launch(void* cw, const void* g, float* accum, const int32_t* perm, const int32_t* ids,
           void* partials, int64_t L, int64_t D, float slr, float eps, cudaStream_t stream) {
  const bool aligned16 = reinterpret_cast<uintptr_t>(cw) % 16 == 0;
  if (accum == nullptr)
    return row_runs::launch<G>(SgdEpilogue<T>{static_cast<T*>(cw), slr}, g, perm, ids, partials, L, D,
                               aligned16, stream);
  // the mean square is one warp's reduction: the whole row in one warp
  if (D > 32 * (row_runs::vec4_path(g, partials, D, aligned16) ? 4 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return row_runs::launch<G>(AdagradEpilogue<T>{static_cast<T*>(cw), accum, slr, eps}, g, perm, ids,
                             partials, L, D, aligned16, stream);
}

template <typename T>
int launch_rows(void* cw, const void* g, float* accum, const int32_t* perm, const int32_t* ids,
                void* partials, int64_t L, int64_t D, float slr, float eps, bool f32_grads,
                cudaStream_t stream) {
  return f32_grads ? launch<T, float>(cw, g, accum, perm, ids, partials, L, D, slr, eps, stream)
                   : launch<T, T>(cw, g, accum, perm, ids, partials, L, D, slr, eps, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2.
// g_dtype is row_dtype or 0. accum: (C,) f32 Adagrad accumulators, or null
// for SGD (eps then unused). ids: the plan's ids_grouped, sorted. partials:
// (2 * ceil(L / 64), D) f32 scratch.
extern "C" int binned_sgd_launch(void* cw, const void* g, void* accum, const int32_t* perm,
                                 const int32_t* ids, void* partials, int64_t L, int64_t D,
                                 float slr, float eps, int row_dtype, int g_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(accum);
  if (g_dtype != row_dtype && g_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32g = g_dtype == 0;
  switch (row_dtype) {
    case 0: return launch<float, float>(cw, g, a, perm, ids, partials, L, D, slr, eps, st);
    case 1: return launch_rows<__nv_bfloat16>(cw, g, a, perm, ids, partials, L, D, slr, eps, f32g, st);
    case 2: return launch_rows<__nv_fp8_e4m3>(cw, g, a, perm, ids, partials, L, D, slr, eps, f32g, st);
    case 3: return launch_rows<__nv_fp8_e5m2>(cw, g, a, perm, ids, partials, L, D, slr, eps, f32g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
