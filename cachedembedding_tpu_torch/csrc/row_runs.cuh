// Runs of one row, cut into fixed chunks: the reduction shared by
// binned_sgd.cu (Kernel 2, with its SGD and row-wise Adagrad epilogues) and
// binned_scatter_add.cu (Kernel 3).
//
// The host plan (sort_plan) sorts the step's id stream stably by id: perm and
// ids = v[perm], so every row's contributors form one run of equal ids,
// contiguous and in stream order. The sorted stream is cut into chunks of
// kChunk contributors and one warp takes each chunk, whatever rows it holds: a
// heavy row (the slice's first step has one of 11,368 ids) is spread over
// many warps, and the card's 132 SMs share the stream evenly. A stream that is
// not sorted (the JAX package's plan, grouped by bin only) would split a row
// into several runs, each written on its own: the chunk launch checks every
// adjacent pair of ids and stops with a device-side assert on a decrease.
//
// Inside a warp, lanes own columns (VEC = 4 a lane: 8 B of bf16 or 16 B of
// f32 grads, one 256-B or 512-B row of D = 128 per warp instruction). The
// warp walks its chunk 32 elements at a time: each lane reads one element's
// id and perm, one ballot marks where runs end, and the warp loads kUnroll
// grad rows g[perm[i]] at a time, all in flight together with the
// destination rows of the runs that end among them, and sums each run in
// registers, in stream order from zero. A run that starts and ends inside the
// chunk is final: the warp applies the epilogue to its row. A run that
// crosses a chunk boundary leaves a partial sum in a scratch slot (each chunk
// has a head slot, for the run that crossed in, and a tail slot, for the run
// that crosses out), and a second launch finishes it:
//   * a crossing run of at most kChunk contributors is summed again from g in
//     stream order from zero, so every row with at most kChunk contributors
//     is summed exactly as inside one chunk;
//   * a longer run sums its partials in chunk order, kPartialsAhead loads in
//     flight.
// No atomics anywhere: the sum order is fixed, so two launches give the same
// bits. Each row is written by one warp only.
//
// What bounds it: bytes, the grad rows above all, read in row order and so
// scattered over g. kChunk = 64 gives the slice's step 6,656 warps, enough to
// keep every SM's loads in flight; a sweep on the H100 found 64 and 128
// within 4% of each other and 32 and 256 slower (PERF.md).
//
// The epilogue is the caller's (Epi): prefetch<VEC>(row, col, D) loads what
// the epilogue needs of the row before the sum is done, apply<VEC>(row, col,
// D, acc, pre, mine) writes the row. Every lane of the warp calls apply, so
// that an epilogue may reduce over the row; lanes past D have mine false, and
// their acc holds sums of column 0 (they load a valid address), which such a
// reduction must leave out. An epilogue that needs the whole row at once
// takes D <= 32 * VEC (vec4_path says which VEC a launch takes).
//
// Grads and rows may be f32, bf16, float8_e4m3fn or float8_e5m2 (Cvt): the
// sums are f32 whatever the grads' type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace row_runs {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 64;           // contributors per warp (ROW_CHUNK in ops/binned_scatter.py)
constexpr int kWarps = 4;            // warps (chunks) per block
constexpr int kUnroll = 8;           // grad rows in flight per lane
constexpr int kPartialsAhead = 16;   // partials in flight per lane

// VEC elements of T, moved by one instruction (raw bits for the narrow types).
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> { using type = float4; };
template <>
struct Pack<float, 1> { using type = float; };
template <>
struct Pack<__nv_bfloat16, 4> { using type = uint2; };
template <>
struct Pack<__nv_bfloat16, 1> { using type = unsigned short; };
template <>
struct Pack<__nv_fp8_e4m3, 4> { using type = unsigned int; };
template <>
struct Pack<__nv_fp8_e4m3, 1> { using type = unsigned char; };
template <>
struct Pack<__nv_fp8_e5m2, 4> { using type = unsigned int; };
template <>
struct Pack<__nv_fp8_e5m2, 1> { using type = unsigned char; };

// T <-> f32. Widening is exact. Narrowing rounds to nearest even as
// jnp.astype does: bf16 by __float2bfloat16_rn; fp8 by the __NV_NOSAT
// conversions, which give NaN (e4m3fn) or inf (e5m2) beyond the largest
// finite value, as ml_dtypes does, where __NV_SATFINITE would clamp.
template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ void widen(float4 p, float* v) {
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
  }
  static __device__ __forceinline__ void widen(float p, float* v) { v[0] = p; }
  static __device__ __forceinline__ void narrow(const float* v, float4& p) {
    p = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void narrow(const float* v, float& p) { p = v[0]; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  // the bf16 bits are the top half of the f32 bits
  static __device__ __forceinline__ void widen(uint2 p, float* v) {
    v[0] = __uint_as_float(p.x << 16);
    v[1] = __uint_as_float(p.x & 0xffff0000u);
    v[2] = __uint_as_float(p.y << 16);
    v[3] = __uint_as_float(p.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void widen(unsigned short p, float* v) {
    v[0] = __uint_as_float(static_cast<unsigned>(p) << 16);
  }
  static __device__ __forceinline__ unsigned bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void narrow(const float* v, uint2& p) {
    p.x = bits(v[0]) | (bits(v[1]) << 16);
    p.y = bits(v[2]) | (bits(v[3]) << 16);
  }
  static __device__ __forceinline__ void narrow(const float* v, unsigned short& p) {
    p = static_cast<unsigned short>(bits(v[0]));
  }
  static __device__ __forceinline__ float round(float x) { return __uint_as_float(bits(x) << 16); }
};
template <__nv_fp8_interpretation_t kKind>
struct CvtFp8 {
  static __device__ __forceinline__ float value(unsigned c) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(c), kKind)));
  }
  static __device__ __forceinline__ unsigned bits(float x) {
    return __nv_cvt_float_to_fp8(x, __NV_NOSAT, kKind);
  }
  static __device__ __forceinline__ void widen(unsigned int p, float* v) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = value((p >> (8 * k)) & 0xffu);
  }
  static __device__ __forceinline__ void widen(unsigned char p, float* v) { v[0] = value(p); }
  static __device__ __forceinline__ void narrow(const float* v, unsigned int& p) {
    p = bits(v[0]) | (bits(v[1]) << 8) | (bits(v[2]) << 16) | (bits(v[3]) << 24);
  }
  static __device__ __forceinline__ void narrow(const float* v, unsigned char& p) {
    p = static_cast<unsigned char>(bits(v[0]));
  }
  static __device__ __forceinline__ float round(float x) { return value(bits(x)); }
};
template <>
struct Cvt<__nv_fp8_e4m3> : CvtFp8<__NV_E4M3> {};
template <>
struct Cvt<__nv_fp8_e5m2> : CvtFp8<__NV_E5M2> {};

// g and, in the finishing launch, the partials are read through the
// read-only path; the destination rows (cw) with plain loads.
template <int VEC, typename T>
__device__ __forceinline__ typename Pack<T, VEC>::type ldg(const T* p) {
  return __ldg(reinterpret_cast<const typename Pack<T, VEC>::type*>(p));
}
template <int VEC, typename T>
__device__ __forceinline__ typename Pack<T, VEC>::type load(const T* p) {
  return *reinterpret_cast<const typename Pack<T, VEC>::type*>(p);
}
template <typename T, typename P>
__device__ __forceinline__ void unpack(P p, float* v) {
  Cvt<T>::widen(p, v);
}
template <int VEC, typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  typename Pack<T, VEC>::type x;
  Cvt<T>::narrow(v, x);
  *reinterpret_cast<typename Pack<T, VEC>::type*>(p) = x;
}

// Scratch slot of chunk c: 0 = head (the run that crossed in), 1 = tail.
__device__ __forceinline__ int64_t slot_offset(int c, int slot, int D) {
  return (static_cast<int64_t>(c) * 2 + slot) * D;
}

// One warp per chunk of kChunk contributors of the sorted stream. The warp
// takes the chunk 32 elements at a time: lane t loads element t's id and
// source row, the run ends are one ballot, and the rows are loaded kUnroll at
// a time (the element's lane a compile-time shuffle index, so the loop body
// is small).
template <int VEC, typename G, class Epi>
__global__ void __launch_bounds__(kWarps * 32)
    chunk_kernel(Epi epi, const G* __restrict__ g, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ ids, int L, int D, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int s = c * kChunk;
  if (s >= L) return;  // the whole warp leaves together
  const int n = L - s < kChunk ? L - s : kChunk;
  const int after = s + n < L ? __ldg(ids + s + n) : -1;
  const bool head_in = s > 0 && __ldg(ids + s - 1) == __ldg(ids + s);  // the first run crossed in
  const bool tail_out = after == __ldg(ids + s + n - 1);              // the last run crosses out

  for (int col0 = 0; col0 < D; col0 += 32 * VEC) {
    const int col = col0 + lane * VEC;
    const bool mine = col < D;
    const int colc = mine ? col : 0;  // lanes past D load a valid address, store nothing
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    bool head_open = head_in;  // the run being summed crossed in
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int m = n - j0 < 32 ? n - j0 : 32;
      const int j = s + j0 + lane;
      // past m: id -1 (equals no row), source 0 (a valid row to load)
      const int my_id = lane < m ? __ldg(ids + j) : -1;
      const int my_src = lane < m ? __ldg(perm + j) : 0;
      int next = __shfl_down_sync(kFull, my_id, 1);
      if (lane == m - 1) next = j0 + m < n ? __ldg(ids + j + 1) : after;
      assert(!(lane < m && next >= 0 && next < my_id));  // the plan must be sorted by id
      // elements that close their run inside the chunk, and those of them
      // whose run is whole (final): all but a first end while a run is open
      const unsigned ends = __ballot_sync(kFull, lane < m && next != my_id);
      unsigned fins = ends;
      if (head_open && ends) {
        fins &= ends - 1;
        head_open = false;
      }
#pragma unroll
      for (int r = 0; r < 32; r += kUnroll) {
        if (r >= m) continue;  // no break: the loop must unroll fully
        int row[kUnroll];
        typename Pack<G, VEC>::type gv[kUnroll];
        typename Epi::template Pre<VEC> pre[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          row[u] = __shfl_sync(kFull, my_id, r + u);
          const int from = __shfl_sync(kFull, my_src, r + u);
          gv[u] = ldg<VEC>(g + static_cast<int64_t>(from) * D + colc);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if ((fins >> (r + u)) & 1) pre[u] = epi.template prefetch<VEC>(row[u], colc, D);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + u >= m) continue;
          float v[VEC];
          unpack<G>(gv[u], v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += v[k];
          if ((ends >> (r + u)) & 1) {
            if ((fins >> (r + u)) & 1)  // every lane: an epilogue may reduce over the warp
              epi.template apply<VEC>(row[u], col, D, acc, pre[u], mine);
            else if (mine)
              store<VEC>(partials + slot_offset(c, 0, D) + col, acc);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
          }
        }
      }
    }
    // the run still open crosses out: the whole chunk if it also crossed in
    if (tail_out && mine) store<VEC>(partials + slot_offset(c, head_open ? 0 : 1, D) + col, acc);
  }
}

// One warp per chunk boundary c (between chunks c - 1 and c): the warp of a
// run's first crossed boundary finishes that run.
template <int VEC, typename G, class Epi>
__global__ void __launch_bounds__(kWarps * 32)
    finish_kernel(Epi epi, const G* __restrict__ g, const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ ids, int L, int D,
                  const float* __restrict__ partials, int num_chunks) {
  const int lane = threadIdx.x & 31;
  const int c = 1 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= num_chunks) return;
  const int b = c * kChunk;
  const int v = __ldg(ids + b);
  if (__ldg(ids + b - 1) != v) return;                // no run crosses here
  if (c >= 2 && __ldg(ids + b - kChunk - 1) == v) return;  // it crossed an earlier boundary
  // the run's last chunk c1: its chunks are consecutive, so the chunks after
  // c that open with v are a prefix
  int c1 = c;
  for (int base = c + 1; base < num_chunks; base += 32) {
    const int cc = base + lane;
    const unsigned m =
        __ballot_sync(kFull, cc < num_chunks && __ldg(ids + static_cast<int64_t>(cc) * kChunk) == v);
    c1 += __popc(m);
    if (m != kFull) break;
  }
  // a run over two chunks may hold at most kChunk contributors: [lo, hi)
  int lo = 0, hi = 0;
  bool direct = false;
  if (c1 == c) {
    int n_prev = 0, n_cur = 0;
    for (int j = lane; j < kChunk; j += 32) n_prev += __ldg(ids + b - kChunk + j) == v;
    const int cend = b + kChunk < L ? b + kChunk : L;
    for (int j = b + lane; j < cend; j += 32) n_cur += __ldg(ids + j) == v;
    n_prev = __reduce_add_sync(kFull, n_prev);
    n_cur = __reduce_add_sync(kFull, n_cur);
    lo = b - n_prev;
    hi = b + n_cur;
    direct = hi - lo <= kChunk;
  }
  const int n_parts = c1 - c + 2;  // the tail slot of chunk c - 1, the head slots of c..c1
  for (int col0 = 0; col0 < D; col0 += 32 * VEC) {
    const int col = col0 + lane * VEC;
    const bool mine = col < D;
    const int colc = mine ? col : 0;
    typename Epi::template Pre<VEC> pre = epi.template prefetch<VEC>(v, colc, D);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (direct) {  // from g, in stream order from zero
      for (int base = lo; base < hi; base += 32) {
        const int m = hi - base < 32 ? hi - base : 32;
        const int mine_src = lane < m ? __ldg(perm + base + lane) : 0;
        for (int u0 = 0; u0 < m; u0 += kUnroll) {
          typename Pack<G, VEC>::type gv[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int r = __shfl_sync(kFull, mine_src, (u0 + u) & 31);
            gv[u] = ldg<VEC>(g + static_cast<int64_t>(r) * D + colc);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (u0 + u >= m) continue;
            float x[VEC];
            unpack<G>(gv[u], x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += x[k];
          }
        }
      }
    } else {  // from the partials, in chunk order
      for (int base = 0; base < n_parts; base += kPartialsAhead) {
        typename Pack<float, VEC>::type pv[kPartialsAhead];
#pragma unroll
        for (int u = 0; u < kPartialsAhead; ++u) {
          const int k = base + u < n_parts ? base + u : n_parts - 1;
          const int64_t off = k == 0 ? slot_offset(c - 1, 1, D) : slot_offset(c - 1 + k, 0, D);
          pv[u] = ldg<VEC>(partials + off + colc);
        }
#pragma unroll
        for (int u = 0; u < kPartialsAhead; ++u) {
          if (base + u >= n_parts) continue;
          float x[VEC];
          unpack<float>(pv[u], x);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += x[k];
        }
      }
    }
    epi.template apply<VEC>(v, col, D, acc, pre, mine);
  }
}

// Both launches; returns the first cudaGetLastError() that is not
// cudaSuccess.
template <int VEC, typename G, class Epi>
int launch_chunks(const Epi& epi, const G* g, const int32_t* perm, const int32_t* ids,
                  float* partials, int L, int D, cudaStream_t stream) {
  const int chunks = (L + kChunk - 1) / kChunk;
  if (chunks == 0) return 0;
  chunk_kernel<VEC, G, Epi><<<(chunks + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      epi, g, perm, ids, L, D, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  finish_kernel<VEC, G, Epi><<<(chunks - 1 + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      epi, g, perm, ids, L, D, partials, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Whether a launch moves 4 elements a lane: D a multiple of 4 and every
// pointer 16-byte aligned (the destination's alignment is the caller's
// aligned16).
inline bool vec4_path(const void* g, const void* partials, int64_t D, bool aligned16) {
  return D % 4 == 0 && aligned16 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(partials) % 16 == 0;
}

// The reduction of the sorted stream (L contributors, rows of D). Lanes move
// 4 elements at a time where vec4_path allows, one element otherwise.
// partials: (2 * ceil(L / kChunk), D) f32 scratch.
template <typename G, class Epi>
int launch(const Epi& epi, const void* g, const int32_t* perm, const int32_t* ids,
           void* partials, int64_t L, int64_t D, bool aligned16, cudaStream_t stream) {
  const G* gp = static_cast<const G*>(g);
  float* pp = static_cast<float*>(partials);
  const int l = static_cast<int>(L), d = static_cast<int>(D);
  return vec4_path(g, partials, D, aligned16) ? launch_chunks<4>(epi, gp, perm, ids, pp, l, d, stream)
                                              : launch_chunks<1>(epi, gp, perm, ids, pp, l, d, stream);
}

}  // namespace row_runs
