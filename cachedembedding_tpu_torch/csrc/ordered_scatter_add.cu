// Ordered adds into rows of the storage dtype for Hopper (sm_90a): Kernel 5
// of the port, two entries that walk the same row-sorted plan. Neither is a
// Pallas kernel: both port XLA scatters of the JAX trainer
// (cachedembedding_tpu/train/trainer.py, _scan_window), whose combiner adds
// in the storage dtype, one rounding per add, in stream order. No PyTorch call
// computes the ordered function (index_add_ on CUDA adds with atomics, in no
// fixed order, and has no fp8). Python side:
// cachedembedding_tpu_torch/ops/ordered_scatter.py.
//
//   ordered_scatter_add (the sparse-gradient branch,
//   cw = cw.at[v].add((-slr * g.astype(f32)).astype(cw.dtype))):
//     for i in stream order:  a = round(-slr * g[i]);  cw[v_i] = round(cw[v_i] + a)
//
//   ordered_grad_update (the dense branch of ragged windows: JAX takes the
//   grad w.r.t. the whole cw in its storage dtype, so the transpose of the
//   row gather adds the rows' grads in that dtype into zero rows; then one
//   f32 update):
//     s_v = +0;  for i in stream order with v_i = v:  s_v = round(s_v + g[i])
//     SGD:      cw[v] = round(cw[v] - slr * s_v)
//     Adagrad:  acc[v] += mean(s_v * s_v);  cw[v] = round(cw[v] - slr * (s_v / (sqrt(acc[v]) + eps)))
//   Rows nobody touched are not visited (JAX's cw - slr * 0 leaves them
//   bit-equal), and the (C, D) grad that JAX builds is never made.
//
// round() casts f32 to the rows' dtype (f32, bf16, float8_e4m3fn or
// float8_e5m2) to nearest even, as jnp.astype does (row_runs.cuh, Cvt); g
// has the rows' dtype.
//
// What bounds it: bytes. g (L*D*elt), perm and ids (8 B per element), and a
// read and a write of each touched row (and of its 4-byte accumulator). But
// a row's adds form a dependent chain, so a row with n contributors costs n
// dependent adds after its loads: the heaviest row of a step is serial by
// definition, and the kernel's time follows it where the step is skewed. On
// the Criteo-1TB step (425,984 ids, heaviest run 11,355) an H100 80GB HBM3 at
// 700 W took 1.55 ms for the scatter entry, 1.25 of it that run alone (about
// 110 ns an add), against a 0.036 ms bound in bytes.
//
// Design: the host plan sorts the stream stably by row (sort_plan), so each
// row's contributors are one run, contiguous and in stream order. One warp
// takes each 32 positions of the sorted stream and, one after another, the
// runs that start among them (a ballot marks the starts); for each run its
// lanes own columns (4 elements a lane where D and the pointers allow), and
// walk the run 32 contributors at a time: the batch's grad rows all in flight
// together (16 for f32 rows), the next batch's ids and sources loaded behind
// them, then the adds in order in registers, rounded after each; the row is
// written once at the end. A heavy run thus costs about one memory round
// trip and 32 dependent adds per 32 contributors. No atomics: each row is
// written by one warp, and two launches give the same bits. A run longer
// than the warp's 32 positions is walked by that warp alone. The Adagrad
// epilogue reduces the row's mean square over the warp's lanes, so it needs
// the whole row in one warp (D <= 128 on the 4-a-lane path, D <= 32
// otherwise). A plan not sorted by id stops the launch with a device-side
// assert (a row split over two runs would be written twice, the second from
// a stale value).
//
// C interface, loaded with ctypes: one CUDA launch per call; returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

#include "row_runs.cuh"

namespace {

constexpr int kWarps = 4;   // warps per block
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kScatter = 0, kSgd = 1, kAdagrad = 2 };

// Adds the run of row v that starts at sorted position k0 into w, one rounded
// add at a time, in stream order: round(-slr * g[i]) (kScaled) or g[i]. The
// run's contributors are taken 32 positions of the stream at a time (a
// prefix of each batch, since the stream is sorted); the next batch's ids and
// sources load behind this batch's grad rows.
template <int VEC, bool kScaled, typename T>
__device__ __forceinline__ void walk_run(float* w, const T* __restrict__ g, const int32_t* __restrict__ perm,
                                         const int32_t* __restrict__ ids, int L, int D, int v, int k0,
                                         int colc, float neg_slr) {
  using row_runs::Cvt;
  using Pack = typename row_runs::Pack<T, VEC>::type;
  constexpr int kAhead = sizeof(Pack) > 8 ? 16 : 32;  // grad rows in flight per lane
  const int lane = threadIdx.x & 31;
  int k = k0 + lane;
  bool in = k < L && __ldg(ids + k) == v;
  int src = in ? __ldg(perm + k) : 0;
  for (;;) {
    const int n = __popc(__ballot_sync(kFull, in));
    const int cur = src;
    for (int u0 = 0; u0 < n; u0 += kAhead) {
      Pack gv[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int from = __shfl_sync(kFull, cur, (u0 + u) & 31);
        gv[u] = u0 + u < n ? row_runs::ldg<VEC>(g + static_cast<int64_t>(from) * D + colc) : Pack{};
      }
      if (u0 == 0) {
        k += 32;
        in = n == 32 && k < L && __ldg(ids + k) == v;
        src = in ? __ldg(perm + k) : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (u0 + u >= n) continue;  // no break: the loop must unroll fully
        float x[VEC];
        row_runs::unpack<T>(gv[u], x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float a = kScaled ? Cvt<T>::round(__fmul_rn(neg_slr, x[e])) : x[e];
          w[e] = Cvt<T>::round(__fadd_rn(w[e], a));
        }
      }
    }
    if (n < 32) break;
  }
}

template <int VEC, typename T, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
    ordered_kernel(T* cw, float* accum, const T* __restrict__ g, const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ ids, int L, int D, float slr, float eps) {
  const int lane = threadIdx.x & 31;
  const int s = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (s >= L) return;  // the whole warp leaves together
  const int j = s + lane;
  const int my_id = j < L ? __ldg(ids + j) : -1;
  const int prev = j < L && j > 0 ? __ldg(ids + j - 1) : -1;
  assert(!(j < L && j > 0 && prev > my_id));  // the plan must be sorted by id
  unsigned starts = __ballot_sync(kFull, j < L && (j == 0 || prev != my_id));
  while (starts) {
    const int b = __ffs(starts) - 1;
    starts &= starts - 1;
    const int v = __shfl_sync(kFull, my_id, b);
    T* row = cw + static_cast<int64_t>(v) * D;
    for (int col0 = 0; col0 < D; col0 += 32 * VEC) {
      const int col = col0 + lane * VEC;
      const bool mine = col < D;
      const int colc = mine ? col : 0;  // lanes past D load a valid address, store nothing
      float w[VEC];
      if (kMode == kScatter) {
        row_runs::unpack<T>(row_runs::load<VEC>(row + colc), w);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) w[e] = 0.f;  // +0: JAX's zero grad rows
      }
      walk_run<VEC, kMode == kScatter>(w, g, perm, ids, L, D, v, s + b, colc, -slr);
      if (kMode != kScatter) {  // w holds s_v: the f32 epilogue, one rounding
        float c[VEC];
        row_runs::unpack<T>(row_runs::load<VEC>(row + colc), c);
        if (kMode == kAdagrad) {  // the whole row is this warp's (the launch checks D)
          float ss = 0.f;  // lanes past D summed copies of column 0: they add nothing
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss = mine ? __fadd_rn(ss, __fmul_rn(w[e], w[e])) : 0.f;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
          const float a = __fadd_rn(accum[v], __fdiv_rn(ss, static_cast<float>(D)));
          const float den = __fadd_rn(__fsqrt_rn(a), eps);
          __syncwarp();  // every lane has read accum[v]
          if (lane == 0) accum[v] = a;
#pragma unroll
          for (int e = 0; e < VEC; ++e) w[e] = __fdiv_rn(w[e], den);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) w[e] = __fsub_rn(c[e], __fmul_rn(slr, w[e]));
      }
      if (mine) row_runs::store<VEC>(row + col, w);
    }
  }
}

template <typename T, int kMode>
int launch(void* cw, float* accum, const void* g, const int32_t* perm, const int32_t* ids, int64_t L,
           int64_t D, float slr, float eps, cudaStream_t stream) {
  if (L == 0) return 0;
  const int blocks = static_cast<int>((L + 32 * kWarps - 1) / (32 * kWarps));
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(cw) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  if (kMode == kAdagrad && D > 32 * (vec ? 4 : 1)) return static_cast<int>(cudaErrorInvalidValue);
  T* c = static_cast<T*>(cw);
  const T* gp = static_cast<const T*>(g);
  const int l = static_cast<int>(L), d = static_cast<int>(D);
  if (vec)
    ordered_kernel<4, T, kMode><<<blocks, kWarps * 32, 0, stream>>>(c, accum, gp, perm, ids, l, d, slr, eps);
  else
    ordered_kernel<1, T, kMode><<<blocks, kWarps * 32, 0, stream>>>(c, accum, gp, perm, ids, l, d, slr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_rows(void* cw, float* accum, const void* g, const int32_t* perm, const int32_t* ids, int64_t L,
                int64_t D, float slr, float eps, int dtype, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch<float, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, st);
    case 1: return launch<__nv_bfloat16, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, st);
    case 2: return launch<__nv_fp8_e4m3, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, st);
    case 3: return launch<__nv_fp8_e5m2, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2 (cw
// and g share it). ids: the plan's ids_grouped, sorted stably by id; perm
// the stream positions. neg_slr: -slr.
extern "C" int ordered_scatter_add_launch(void* cw, const void* g, const int32_t* perm,
                                          const int32_t* ids, int64_t L, int64_t D, float neg_slr,
                                          int dtype, void* stream) {
  return launch_rows<kScatter>(cw, nullptr, g, perm, ids, L, D, -neg_slr, 0.f, dtype,
                               static_cast<cudaStream_t>(stream));
}

// The same codes and plan. accum: (C,) f32 row-wise Adagrad accumulators, or
// null for SGD (eps then unused).
extern "C" int ordered_grad_update_launch(void* cw, void* accum, const void* g, const int32_t* perm,
                                          const int32_t* ids, int64_t L, int64_t D, float slr, float eps,
                                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(accum);
  return a == nullptr ? launch_rows<kSgd>(cw, nullptr, g, perm, ids, L, D, slr, 0.f, dtype, st)
                      : launch_rows<kAdagrad>(cw, a, g, perm, ids, L, D, slr, eps, dtype, st);
}
