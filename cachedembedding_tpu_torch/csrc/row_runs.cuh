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
// f32 grads, one 256-B or 512-B row of D = 128 per warp instruction). Two
// chunk launches, by epilogue (Epi::kStaged):
//   * chunk_kernel (SGD, Kernel 3): the warp walks its chunk 32 elements at a
//     time: each lane reads one element's id and perm, one ballot marks where
//     runs end, and the warp loads kUnroll grad rows g[perm[i]] at a time,
//     all in flight together with the destination rows of the runs that end
//     among them, and sums each run in registers, in stream order from zero;
//   * staged_chunk_kernel (Adagrad): the chunk's grad rows are staged in
//     shared memory by bulk asynchronous copies, all in flight at once, and
//     the finished runs' epilogues run kGroup at a time, so that their
//     reductions overlap instead of stalling the loads.
// A run that starts and ends inside the chunk is final: the warp applies the
// epilogue to its row. A run that crosses a chunk boundary leaves a partial
// sum in a scratch slot (each chunk has a head slot, for the run that crossed
// in, and a tail slot, for the run that crosses out), and a second launch,
// finish_kernel, finishes it:
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
// within 4% of each other and 32 and 256 slower (PERF.md). Staging SGD's
// chunks too, more rows in flight (kUnroll 16 or 32 for narrow grads), or
// all of a chunk's ids loaded at once measured no faster. fp8 grads stay at
// about 30% of their bound: their bytes are few, and the time goes to the
// walk of ids and sources, the epilogues and the finishing launch's tail
// (PERF.md).
//
// The epilogue is the caller's (Epi): prefetch<VEC>(row, col, D) loads what
// the epilogue needs of the row before the sum is done, apply<VEC>(row, col,
// D, acc, pre, mine) writes the row (chunk_kernel, finish_kernel), and a
// staged epilogue's apply_group<VEC, N>(rows, col, D, accs, pres, fins, mine)
// writes the final runs (bits fins) of a group of N. Every lane of the warp
// calls apply, so that an epilogue may reduce over the row; lanes past D have
// mine false, and their acc holds sums of column 0 (they load a valid
// address), which such a reduction must leave out. An epilogue that needs the
// whole row at once takes D <= 32 * VEC (vec4_path says which VEC a launch
// takes).
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
constexpr int kPartialsAhead = 32;   // partials in flight per lane (16: 2-4% slower on fp8 grads, PERF.md)

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
// jnp.astype does: bf16 by __float2bfloat16_rn; fp8 as ml_dtypes does, NaN
// (e4m3fn) or inf (e5m2) beyond the largest finite value (CvtFp8).
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

// The no-saturation cast (__NV_NOSAT, emulated in software: some hundred
// cycles), kept out of line: one copy, not one per unrolled element.
template <__nv_fp8_interpretation_t kKind>
__device__ __noinline__ unsigned fp8_bits_nosat(float x) {
  return __nv_cvt_float_to_fp8(x, __NV_NOSAT, kKind);
}

// fp8 narrowing takes the card's conversion (cvt.rn.satfinite, two values
// an instruction) wherever |x| is at most the largest finite value
// kMaxFinite: saturation never applies there, and it rounds as the
// no-saturation cast does. The rest (larger |x|, +-inf, NaN) takes the
// no-saturation cast, which gives e4m3fn NaN (0x7F, signed) past 464 and
// e5m2 inf (0x7C, signed) from 61,440, as ml_dtypes does, where the
// saturating cast would clamp to +-kMaxFinite. chip_smoke.py holds Kernel 2's
// narrowing to ops/rounding.astype_storage on every f32 bit pattern.
template <__nv_fp8_interpretation_t kKind, int kMaxFinite>
struct CvtFp8 {
  static __device__ __forceinline__ bool finite_range(float x) {
    return fabsf(x) <= static_cast<float>(kMaxFinite);
  }
  // the card's conversion of two values: hi in the high byte, lo in the low
  static __device__ __forceinline__ unsigned sat2(float hi, float lo) {
    unsigned short r;
    if (kKind == __NV_E4M3)
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(hi), "f"(lo));
    else
      asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(hi), "f"(lo));
    return r;
  }
  static __device__ __forceinline__ unsigned bits(float x) {
    return finite_range(x) ? sat2(0.f, x) & 0xffu : fp8_bits_nosat<kKind>(x);
  }
  // lo in the low byte, hi in the high
  static __device__ __forceinline__ unsigned bits2(float lo, float hi) {
    return finite_range(lo) && finite_range(hi) ? sat2(hi, lo) : bits(lo) | (bits(hi) << 8);
  }
  static __device__ __forceinline__ float value(unsigned c) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(c), kKind)));
  }
  static __device__ __forceinline__ void widen(unsigned int p, float* v) {
#pragma unroll
    for (int k = 0; k < 4; k += 2) {  // two codes a conversion
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(p >> (8 * k)), kKind);
      const float2 f = __half22float2(__half2(h));
      v[k] = f.x;
      v[k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void widen(unsigned char p, float* v) { v[0] = value(p); }
  static __device__ __forceinline__ void narrow(const float* v, unsigned int& p) {
    p = bits2(v[0], v[1]) | (bits2(v[2], v[3]) << 16);
  }
  static __device__ __forceinline__ void narrow(const float* v, unsigned char& p) {
    p = static_cast<unsigned char>(bits(v[0]));
  }
  static __device__ __forceinline__ float round(float x) { return value(bits(x)); }
};
template <>
struct Cvt<__nv_fp8_e4m3> : CvtFp8<__NV_E4M3, 448> {};
template <>
struct Cvt<__nv_fp8_e5m2> : CvtFp8<__NV_E5M2, 57344> {};

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

// Shared-memory barriers and Hopper's bulk asynchronous copy (1-D TMA).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// Arrives and expects `bytes` more of the copies that complete on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)), "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
}
// src (16-byte aligned, `bytes` a multiple of 16) to dst in this block's
// shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(b))
               : "memory");
}
// Programmatic dependent launch: the next launch on the stream may start
// (launch_dependents); this launch waits for the one before it to finish
// and its writes to be visible (wait).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// One warp per chunk of kChunk contributors of the sorted stream. The warp
// takes the chunk 32 elements at a time: lane t loads element t's id and
// source row, the run ends are one ballot, and the rows are loaded kUnroll at
// a time (the element's lane a compile-time shuffle index, so the loop body
// is small).
template <int VEC, typename G, class Epi>
__global__ void __launch_bounds__(kWarps * 32)
    chunk_kernel(Epi epi, const G* __restrict__ g, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ ids, int L, int D, float* __restrict__ partials) {
  launch_dependents();  // the finishing launch may take the SMs this launch leaves
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

// The staged reduction keeps a whole chunk's grad rows in shared memory.
constexpr int kGroup = 8;                 // runs summed, then finished, together
constexpr int kStageBytes = 32 * 1024;    // at most: the chunk's grad rows in shared memory
constexpr int kStageBarrierBytes = 16;    // the barrier, ahead of the rows (16-byte aligned)

// Whether a launch of four elements a lane may stage its chunks
// (staged_chunk_kernel): a grad row of whole 16-byte units, whose kChunk
// copies fit in kStageBytes (D = 128: f32, bf16 and fp8 grads).
template <typename G>
inline bool staged_path(int64_t D) {
  const int64_t row_bytes = D * static_cast<int64_t>(sizeof(G));
  return row_bytes % 16 == 0 && kChunk * row_bytes <= kStageBytes;
}

// Sum of the staged rows [lo, hi) at column col, in stream order from zero.
template <int VEC, typename G>
__device__ __forceinline__ void sum_staged(const G* rows, int lo, int hi, int D, int col, float* acc) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  int i = lo;
  for (; i + 4 <= hi; i += 4) {  // four shared-memory loads in flight, the adds in order
    typename Pack<G, VEC>::type p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = load<VEC>(rows + static_cast<int64_t>(i + q) * D + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[VEC];
      unpack<G>(p[q], v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
  }
  for (; i < hi; ++i) {
    float v[VEC];
    unpack<G>(load<VEC>(rows + static_cast<int64_t>(i) * D + col), v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += v[k];
  }
}

// One warp (one block) per chunk of kChunk contributors, its grad rows
// staged in shared memory: the launch of epilogues that reduce over the row
// (Adagrad). The warp reads the chunk's ids and sources (two a lane) and
// finds every run end with two ballots; each lane then issues the bulk
// copies of its two grad rows g[perm[i]], all completing on one barrier, so
// the whole chunk is in flight at once. While they fly, the warp loads the
// destination rows of its first kGroup final runs. The runs are then taken
// kGroup at a time: each summed from shared memory in stream order from
// zero, then their epilogues together (Epi::apply_group), so that the
// reductions of several rows overlap; the destination rows of each group are
// loaded before its sums. The run that crossed in and the run that crosses
// out leave their partial sums in the chunk's scratch slots, as in
// chunk_kernel.
template <int VEC, typename G, class Epi>
__global__ void __launch_bounds__(32, 16)
    staged_chunk_kernel(Epi epi, const G* __restrict__ g, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ ids, int L, int D, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char stage[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage);
  const G* rows = reinterpret_cast<const G*>(stage + kStageBarrierBytes);
  launch_dependents();  // the finishing launch may take the SMs this launch leaves
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  const int s = c * kChunk;
  const int n = L - s < kChunk ? L - s : kChunk;
  // lane t holds elements t and t + 32: past n, id -1 (equals no row)
  const bool has0 = lane < n, has1 = lane + 32 < n;
  const int id0 = has0 ? __ldg(ids + s + lane) : -1;
  const int id1 = has1 ? __ldg(ids + s + 32 + lane) : -1;
  const int src0 = has0 ? __ldg(perm + s + lane) : 0;
  const int src1 = has1 ? __ldg(perm + s + 32 + lane) : 0;
  const int after = s + n < L ? __ldg(ids + s + n) : -1;
  const int before = s > 0 ? __ldg(ids + s - 1) : -1;
  const uint32_t row_bytes = static_cast<uint32_t>(D) * sizeof(G);
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar, static_cast<uint32_t>(n) * row_bytes);
  }
  __syncwarp();
  unsigned char* dst = stage + kStageBarrierBytes;
  if (has0) bulk_load(dst + lane * row_bytes, g + static_cast<int64_t>(src0) * D, row_bytes, bar);
  if (has1) bulk_load(dst + (lane + 32) * row_bytes, g + static_cast<int64_t>(src1) * D, row_bytes, bar);

  // run ends: element j ends its run where ids[j + 1] (or the next chunk's first id) differs
  const int up0 = __shfl_down_sync(kFull, id0, 1);
  const int first1 = __shfl_sync(kFull, id1, 0);
  const int up1 = __shfl_down_sync(kFull, id1, 1);
  const int next0 = lane + 1 < n ? (lane < 31 ? up0 : first1) : after;
  const int next1 = lane + 33 < n ? up1 : after;
  assert(!(has0 && next0 >= 0 && next0 < id0));  // the plan must be sorted by id
  assert(!(has1 && next1 >= 0 && next1 < id1));
  const unsigned long long ends = static_cast<unsigned long long>(__ballot_sync(kFull, has0 && next0 != id0)) |
                                  (static_cast<unsigned long long>(__ballot_sync(kFull, has1 && next1 != id1)) << 32);
  const bool head_in = before >= 0 && before == __shfl_sync(kFull, id0, 0);  // the first run crossed in
  const bool tail_out = after >= 0 && after == __shfl_sync(kFull, n - 1 < 32 ? id0 : id1, (n - 1) & 31);

  bool staged = false;
  for (int col0 = 0; col0 < D; col0 += 32 * VEC) {
    const int col = col0 + lane * VEC;
    const bool mine = col < D;
    const int colc = mine ? col : 0;  // lanes past D read a valid column, store nothing
    unsigned long long rest = ends;   // the run ends not yet taken
    int start = 0;                    // the next run's first element
    bool head_open = head_in;         // the next run to end crossed in: its sum is a partial
    do {
      int lo[kGroup], hi[kGroup], row[kGroup];
      unsigned fins = 0, head = 0;  // the group's final runs; the one that crossed in
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        lo[u] = hi[u] = start;
        row[u] = 0;
        if (rest) {
          const int e = __ffsll(static_cast<long long>(rest)) - 1;
          rest &= rest - 1;
          hi[u] = start = e + 1;
          row[u] = __shfl_sync(kFull, e < 32 ? id0 : id1, e & 31);
          (head_open ? head : fins) |= 1u << u;
          head_open = false;
        }
      }
      typename Epi::template Pre<VEC> pre[kGroup] = {};
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if ((fins >> u) & 1) pre[u] = epi.template prefetch<VEC>(row[u], colc, D);
      if (!staged) {
        mbar_wait(bar, 0);
        staged = true;
      }
      float acc[kGroup][VEC];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) sum_staged<VEC>(rows, lo[u], hi[u], D, colc, acc[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (((head >> u) & 1) && mine) store<VEC>(partials + slot_offset(c, 0, D) + col, acc[u]);
      if (fins) epi.template apply_group<VEC, kGroup>(row, col, D, acc, pre, fins, mine);
    } while (rest);
    if (tail_out) {  // the run still open crosses out: the whole chunk if it also crossed in
      float acc[VEC];
      sum_staged<VEC>(rows, start, n, D, colc, acc);
      if (mine) store<VEC>(partials + slot_offset(c, head_open ? 0 : 1, D) + col, acc);
    }
  }
}

// One warp per chunk boundary c (between chunks c - 1 and c): the warp of a
// run's first crossed boundary finishes that run. Launched behind the chunk
// launch with programmatic stream serialization: its warps find their runs
// (ids only) while the chunk launch ends, and wait for it (wait_for_previous)
// only before they read its partials; block 0 waits before it exits, so
// that the call ends when both launches have.
template <int VEC, typename G, class Epi>
__global__ void __launch_bounds__(kWarps * 32)
    finish_kernel(Epi epi, const G* __restrict__ g, const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ ids, int L, int D,
                  const float* __restrict__ partials, int num_chunks) {
  constexpr int kAhead = 32 / static_cast<int>(sizeof(G));  // a crossing run's rows in flight: 4 KB of D = 128
  const int lane = threadIdx.x & 31;
  const int c = 1 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blockIdx.x == 0) wait_for_previous();
  if (c >= num_chunks) return;
  const int b = c * kChunk;
  const int v = __ldg(ids + b);
  if (__ldg(ids + b - 1) != v) return;                // no run crosses here
  if (c >= 2 && __ldg(ids + b - kChunk - 1) == v) return;  // it crossed an earlier boundary
  // the run's last chunk c1: its chunks are consecutive, so the chunks after
  // c that open with v are a prefix; most runs end among the next 32, a
  // longer one is found by a 32-way search of the chunks' first ids
  int c1 = c;
  {
    const int cc = c + 1 + lane;
    const unsigned m =
        __ballot_sync(kFull, cc < num_chunks && __ldg(ids + static_cast<int64_t>(cc) * kChunk) == v);
    c1 += __popc(m);
    if (m == kFull) {
      int lo = c1, hi = num_chunks;  // chunk lo opens with v; hi == num_chunks or chunk hi does not
      while (hi - lo > 1) {
        const int x = lo + static_cast<int>(static_cast<int64_t>(hi - lo) * (lane + 1) / 33);
        const int k = __popc(__ballot_sync(kFull, __ldg(ids + static_cast<int64_t>(x) * kChunk) == v));
        const int x_lo = __shfl_sync(kFull, x, k > 0 ? k - 1 : 0);
        const int x_hi = __shfl_sync(kFull, x, k < 32 ? k : 31);
        if (k > 0) lo = x_lo;
        if (k < 32) hi = x_hi;
      }
      c1 = lo;
    }
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
  if (!direct) wait_for_previous();  // the partials are the chunk launch's
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
        for (int u0 = 0; u0 < m; u0 += kAhead) {
          typename Pack<G, VEC>::type gv[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const int r = __shfl_sync(kFull, mine_src, (u0 + u) & 31);
            gv[u] = ldg<VEC>(g + static_cast<int64_t>(r) * D + colc);
          }
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
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

// Both launches; returns the first error of either (cudaGetLastError()
// or the launch's own). The chunks take staged_chunk_kernel where the
// epilogue asks for it and staged_path allows, else chunk_kernel; the
// finishing launch overlaps the chunk launch's end (programmatic stream
// serialization).
template <int VEC, typename G, class Epi>
int launch_chunks(const Epi& epi, const G* g, const int32_t* perm, const int32_t* ids,
                  float* partials, int L, int D, cudaStream_t stream) {
  const int chunks = (L + kChunk - 1) / kChunk;
  if (chunks == 0) return 0;
  bool staged = false;
  if constexpr (VEC == 4 && Epi::kStaged) {
    staged = staged_path<G>(D);
    if (staged) {
      const int smem = kStageBarrierBytes + kChunk * D * static_cast<int>(sizeof(G));  // <= 48 KB: no opt-in
      staged_chunk_kernel<VEC, G, Epi><<<chunks, 32, smem, stream>>>(epi, g, perm, ids, L, D, partials);
    }
  }
  if (!staged)
    chunk_kernel<VEC, G, Epi><<<(chunks + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        epi, g, perm, ids, L, D, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((chunks - 1 + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, finish_kernel<VEC, G, Epi>, epi, g, perm, ids, L, D,
                           static_cast<const float*>(partials), chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
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
