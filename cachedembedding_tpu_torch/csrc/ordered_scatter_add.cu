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
//     Adagrad:  acc[v] += (sum over columns, in column order, of s_v * s_v) / D
//               cw[v] = round(cw[v] - slr * (s_v / (sqrt(acc[v]) + eps)))
//   Rows nobody touched are not visited (JAX's cw - slr * 0 leaves them
//   bit-equal), and the (C, D) grad that JAX builds is never made.
//
// round() casts f32 to the rows' dtype (f32, bf16, float8_e4m3fn or
// float8_e5m2) to nearest even, as jnp.astype does (row_runs.cuh, Cvt); g
// has the rows' dtype.
//
// What bounds it: two things. Bytes: g (L*D*elt), perm and ids (8 B per
// element), and a read and a write of each touched row (and of its 4-byte
// accumulator): 0.187 ms on the ragged step (1.49M ids, 456,283 touched bf16
// rows of 128) and 0.036 ms on the Criteo-1TB step (425,984 ids) at the H100's
// 3.35 TB/s. And the chain: a row's adds depend on one another, each
// __fadd_rn then the cast, so a row with n contributors costs n times the
// chain's latency whatever the memory does; the heaviest run of the ragged
// step has 32,665 contributors, of the 1TB step 11,355. The first design
// (one warp a run, each batch of 32 paced by dependent loads of ids, perm and
// the grad rows) spent 81-110 ns an add on them: 2.66 of the ragged entry's
// 3.68 device ms, 1.25 of the scatter's 1.55 (H100 80GB HBM3, 700 W).
//
// Design: one launch sequence per call, on the caller's stream.
//   1. classify_kernel: a warp per 32 positions of the sorted stream checks
//      that the plan is sorted (a device-side assert, else a row split over
//      two runs would be written twice) and finds the heavy runs, those of
//      more than T contributors (T = heavy_threshold(L) >= kHeavyMin): a run
//      start with ids[start + T] equal to its own id. At most one heavy run
//      starts among 32 positions; the warp finds its end by a 32-way search
//      of the sorted ids and appends (length, start) to a list in the
//      caller's scratch. The append slot comes from an atomic counter: it
//      hands out places, never touches a value.
//   2. sort_kernel: one block sorts the list in shared memory, longest run
//      first, ties by start: the same order on every launch.
//   3. heavy_kernel: a persistent block per SM takes the runs in that order
//      from a counter, so the longest chain starts first. For each run (its
//      start and length known, so no ids load paces the walk) kProducers
//      warps load its perm slice and gather its grad rows, 32 rows a stage,
//      into a ring of kStages shared-memory slots, a stage each in flight
//      and the next stage's sources loading behind it; the scatter entry's
//      producers also form a = round(-slr * g), off the chain. kSlab / 32
//      consumer warps, one column a thread, run only w = round(w + a) from
//      shared memory, reading two whole stages per wait (a wait, a read
//      and a release cost about as much as 32 adds). Stages are handed
//      over with mbarriers (full: the 32 lanes of the stage's producer
//      warp; empty: the consumer threads). The ring holds kRingBytes (bf16
//      12 stages, fp8 16), so two blocks would still fit an SM. The
//      block's first act releases the next launch
//      (griddepcontrol.launch_dependents).
//   4. light_kernel, launched with programmatic stream serialization so that
//      it fills the SMs beside the heavy blocks: a warp per 32 positions
//      takes the runs that start among them and are not heavy. Their ids and
//      sources load at once, then the grad rows and the runs' rows, 16
//      positions in flight (8 for f32), and the adds run in order in
//      registers, lanes owning columns (4 a lane where D and the pointers
//      allow); a run that goes on past the 32 positions is walked on 32
//      contributors at a time. Its block 0 waits for the heavy launch before
//      it exits (griddepcontrol.wait), so the sequence ends when both have.
// A plan whose runs are all light (L <= T), and f32 rows (kHasRing), take
// launch 4 alone. No atomics
// on values: each row is written by one warp or one block, in stream order,
// and two launches give the same bits. Adagrad's mean square is summed in
// column order (XLA's order on its CPU backend for D <= 32, and the plain
// version's): by one thread from shared memory in a heavy block, by a chain
// of shuffles in a light warp, which needs the whole row in the warp (D <=
// 128 on the 4-a-lane path, D <= 32 otherwise).
//
// On the same card and steps (chip_smoke.py --kernel5-against with the
// first design's source, in turns): the ragged entry 0.42 device ms against
// 3.69, its heaviest run alone 0.31 (2.65); the 1TB scatter 0.19 (1.56), its
// heaviest run 0.14 (1.24). The chain's link alone, in registers, takes 4.1
// ns in bf16 (f32 2.2, fp8 28): the heaviest runs sit at 42% and 32% of
// that chain bound. With every contributor on one grad row the heavy block
// runs at 9.7-12.3 ns an add, which is the ring's pace (each stage's wait,
// read and release), not the add's. The light part alone runs at about
// half its bytes bound: random 256-byte rows. (H100 80GB HBM3, 700 W.) f32
// rows take the light launch alone; PERF.md gives their times beside the
// first design's.
//
// C interface, loaded with ctypes; each entry returns cudaGetLastError() (the
// first error of its launches). scratch: 1 + L / (heavy_threshold(L) + 1)
// 8-byte words (two counters, then the heavy-run list), unused if L <= T.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

#include "row_runs.cuh"

namespace {

constexpr int kWarps = 4;  // light and classify kernels: warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeavyMin = 256;     // HEAVY_RUN_MIN in ops/ordered_scatter.py
constexpr int kMaxHeavy = 16384;   // MAX_HEAVY_RUNS: the sort's shared-memory list
constexpr int kSlab = 128;         // columns a heavy block walks at once, one a consumer thread
constexpr int kProducers = 8;      // producer warps of a heavy block
constexpr int kHeavyThreads = kProducers * 32 + kSlab;
constexpr int kRingBytes = 96 * 1024;
constexpr int kSortThreads = 1024;

enum Mode { kScatter = 0, kSgd = 1, kAdagrad = 2 };

// Runs of more than this many contributors take the ring; the list then
// holds fewer than kMaxHeavy runs.
inline int heavy_threshold(int64_t L) {
  const int64_t t = (L + kMaxHeavy - 1) / kMaxHeavy;
  return static_cast<int>(t > kHeavyMin ? t : kHeavyMin);
}

// f32 rows take no ring: a producer may wait on a slot only one round
// behind (kStages >= kProducers, asserted in heavy_kernel), and 8 stages of
// 32 f32 rows of a slab (128 KB) would leave one block an SM. They reach
// this kernel from caches of f32 rows (--cache_dtype float32: the dense
// ragged and the sparse branches) and resident tables' ragged windows; the
// light launch walks their heavy runs (walk_run), as the first design did.
template <typename T>
constexpr bool kHasRing = sizeof(T) < 4;

template <typename T>
struct Ring {
  using Elem = typename row_runs::Pack<T, 1>::type;
  static constexpr int kSlotElems = 32 * kSlab;  // a stage: 32 grad rows of a slab
  static constexpr int kSlotBytes = kSlotElems * static_cast<int>(sizeof(T));
  static constexpr int kStages = kRingBytes / kSlotBytes > 16 ? 16 : kRingBytes / kSlotBytes;  // RING_STAGES
  static constexpr int kBarrierOffset = kStages * kSlotBytes;
  // the ring, full and empty barriers, the Adagrad squares, the run index and the denominator
  static constexpr int kSmemBytes = kBarrierOffset + 2 * kStages * 8 + kSlab * 4 + 16;
};

// round() of the chain: Cvt<T>::round (for fp8 the card's conversion inside
// the largest finite value, row_runs.cuh's CvtFp8). bf16 takes the packing
// convert (cvt.rn.bf16x2.f32, F2FP on the ALU pipe) in place of
// F2F.BF16.F32 and a shift: the same bits in fewer cycles.
template <typename T>
struct Round {
  static __device__ __forceinline__ float of(float x) { return row_runs::Cvt<T>::round(x); }
};
template <>
struct Round<__nv_bfloat16> {  // one packing convert: bf16(x) in the high half, bf16(0) = 0 in the low
  static __device__ __forceinline__ float of(float x) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x), "f"(0.f));
    return __uint_as_float(r);
  }
};

// One link of the chain: round(w + a) for w and a values of T held in f32,
// the f32 add then Round. bf16 takes the card's bf16 add instead: w and a
// hold their bf16 bits in the high half and zeros in the low, so one
// add.rn.bf16x2 gives round(w + a) in the high half and +0 in the low, the
// f32 value of the rounded sum, in one instruction. A bf16 sum of two bf16
// values is one rounding of the exact sum; the f32 add then Round is two,
// which agree since f32 carries more than 2 * 8 + 2 bits (chip_smoke.py
// holds the two equal on all 2^32 pairs of bf16 operands: bf16_add_sweep).
template <typename T>
__device__ __forceinline__ float chain_add(float w, float a) {
  return Round<T>::of(__fadd_rn(w, a));
}
template <>
__device__ __forceinline__ float chain_add<__nv_bfloat16>(float w, float a) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(__float_as_uint(w)), "r"(__float_as_uint(a)));
  return __uint_as_float(r);
}

using row_runs::mbar_arrive;
using row_runs::mbar_init;
using row_runs::mbar_wait;
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kSlab) : "memory"); }

// Heavy-run list entries: longest first, then by start, as one ascending key.
__device__ __forceinline__ unsigned long long heavy_key(int len, int start) {
  return (static_cast<unsigned long long>(0x7fffffff - len) << 32) | static_cast<unsigned>(start);
}

__global__ void __launch_bounds__(kWarps * 32)
    classify_kernel(const int32_t* __restrict__ ids, int L, int T, unsigned long long* __restrict__ heavy,
                    int* __restrict__ counters, int cap) {
  const int lane = threadIdx.x & 31;
  const int s = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (s >= L) return;  // the whole warp leaves together
  const int j = s + lane;
  const int my_id = j < L ? __ldg(ids + j) : -1;
  const int prev = j < L && j > 0 ? __ldg(ids + j - 1) : -1;
  assert(!(j < L && j > 0 && prev > my_id));  // the plan must be sorted by id
  const bool start = j < L && (j == 0 || prev != my_id);
  const unsigned hv = __ballot_sync(kFull, start && j + T < L && __ldg(ids + j + T) == my_id);
  if (!hv) return;
  const int b = __ffs(hv) - 1;  // the only one: a heavy run covers the rest of these 32 positions
  const int v = __shfl_sync(kFull, my_id, b);
  const int p = s + b;
  int lo = p + T, hi = L;  // ids[lo] == v; hi == L or ids[hi] != v
  while (hi - lo > 1) {    // 32 probes in (lo, hi): those equal to v are a prefix
    const int x = lo + static_cast<int>(static_cast<int64_t>(hi - lo) * (lane + 1) / 33);
    const int c = __popc(__ballot_sync(kFull, __ldg(ids + x) == v));
    const int x_lo = __shfl_sync(kFull, x, c > 0 ? c - 1 : 0);
    const int x_hi = __shfl_sync(kFull, x, c < 32 ? c : 31);
    if (c > 0) lo = x_lo;
    if (c < 32) hi = x_hi;
  }
  if (lane == 0) {
    const int slot = atomicAdd(counters, 1);
    assert(slot < cap);
    if (slot < cap) heavy[slot] = heavy_key(hi - p, p);
  }
}

// One block: the list, padded to a power of two, by a bitonic sort in shared
// memory.
__global__ void __launch_bounds__(kSortThreads)
    sort_kernel(unsigned long long* __restrict__ heavy, const int* __restrict__ counters) {
  extern __shared__ unsigned long long keys[];
  const int n = counters[0];
  if (n <= 1) return;
  int np = 2;
  while (np < n) np <<= 1;
  for (int i = threadIdx.x; i < np; i += kSortThreads) keys[i] = i < n ? heavy[i] : ~0ull;
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < np / 2; i += kSortThreads) {
        const int lo = 2 * stride * (i / stride) + i % stride, hi = lo + stride;
        const unsigned long long a = keys[lo], c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += kSortThreads) heavy[i] = keys[i];
}

// Producer warp w of a heavy block: stages q = w, w + kProducers, ... of the
// run (start s, n contributors, nb stages a slab). Stage q holds the grad rows
// of contributors 32 * (q % nb) + [0, 32) over columns (q / nb) * kSlab +
// [0, kSlab); the ring's stage count so far is `used`.
template <int VEC, typename T, int kMode>
__device__ __forceinline__ void produce(typename Ring<T>::Elem* ring, uint64_t* full, uint64_t* empty,
                                        const T* __restrict__ g, const int32_t* __restrict__ perm, int s,
                                        int n, int nb, int total, uint32_t used, int D, float neg_slr,
                                        int warp, int lane) {
  using R = Ring<T>;
  using P = typename row_runs::Pack<T, VEC>::type;
  using row_runs::Cvt;
  constexpr int kAhead = sizeof(P) > 8 ? 16 : 32;  // grad rows in flight per lane
  constexpr int kGroups = kSlab / (32 * VEC);      // loads per lane to cover a slab's row
  auto sources = [&](int q) {  // the stage's stream positions, one a lane
    const int b = q % nb, m = n - 32 * b < 32 ? n - 32 * b : 32;
    return q < total && lane < m ? __ldg(perm + s + 32 * b + lane) : 0;
  };
  int src = sources(warp);
  for (int q = warp; q < total; q += kProducers) {
    const int b = q % nb, col0 = (q / nb) * kSlab;
    const int m = n - 32 * b < 32 ? n - 32 * b : 32;
    const uint32_t gq = used + q, slot = gq % R::kStages, round = gq / R::kStages;
    typename R::Elem* st = ring + slot * R::kSlotElems;
    int src_next = 0;
#pragma unroll 1
    for (int cg = 0; cg < kGroups; ++cg) {
      const int c = (cg * 32 + lane) * VEC;  // the lane's first column in the slab
      const bool mine = col0 + c < D;
      const int colc = mine ? col0 + c : 0;  // lanes past D load a valid address
      if (!__any_sync(kFull, mine)) break;
      for (int u0 = 0; u0 < m; u0 += kAhead) {
        P gv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int from = __shfl_sync(kFull, src, (u0 + u) & 31);
          gv[u] = u0 + u < m ? row_runs::ldg<VEC>(g + static_cast<int64_t>(from) * D + colc) : P{};
        }
        if (cg == 0 && u0 == 0) {
          src_next = sources(q + kProducers);  // loads behind this stage's rows
          if (round > 0) mbar_wait(empty + slot, (round - 1) & 1);  // the slot's last stage is consumed
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (u0 + u >= m) continue;  // no break: the loop must unroll fully
          P out = gv[u];
          if (kMode == kScatter) {  // the addend, off the consumer's chain
            float x[VEC];
            row_runs::unpack<T>(gv[u], x);
#pragma unroll
            for (int e = 0; e < VEC; ++e) x[e] = Round<T>::of(__fmul_rn(neg_slr, x[e]));
            Cvt<T>::narrow(x, out);
          }
          *reinterpret_cast<P*>(st + (u0 + u) * kSlab + c) = out;
        }
      }
    }
    mbar_arrive(full + slot);  // each of the 32 lanes: its stores are released
    src = src_next;
  }
}

// Consumer thread t (0 <= t < kSlab) of a heavy block: column t of each slab
// of row v, the run's adds in stream order from shared memory, then the
// epilogue.
template <typename T, int kMode>
__device__ __forceinline__ void consume(T* cw, float* accum, typename Ring<T>::Elem* ring, uint64_t* full,
                                        uint64_t* empty, float* sq, float* s_den, int v, int n, int nb,
                                        uint32_t used, int D, float slr, float eps, int t) {
  using R = Ring<T>;
  T* row = cw + static_cast<int64_t>(v) * D;
  int q = 0;
  for (int col0 = 0; col0 < D; col0 += kSlab) {
    const int col = col0 + t;
    const bool mine = col < D;
    float w = 0.f;  // +0: JAX's zero grad rows
    if (kMode == kScatter && mine) row_runs::unpack<T>(row_runs::load<1>(row + col), &w);
    for (int b = 0; b < nb;) {
      if (n - 32 * b >= 64) {  // two whole stages: their column read at once, then 64 adds with no test
        typename R::Elem x[64];
        uint32_t slots[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t gq = used + q + h;
          slots[h] = gq % R::kStages;
          mbar_wait(full + slots[h], (gq / R::kStages) & 1);
          const typename R::Elem* st = ring + slots[h] * R::kSlotElems + t;
#pragma unroll
          for (int u = 0; u < 32; ++u) x[32 * h + u] = st[u * kSlab];
        }
        mbar_arrive(empty + slots[0]);  // the slots are free once read
        mbar_arrive(empty + slots[1]);
        if (mine) {
#pragma unroll
          for (int u = 0; u < 64; ++u) {
            float a;
            row_runs::unpack<T>(x[u], &a);
            w = chain_add<T>(w, a);
          }
        }
        b += 2;
        q += 2;
      } else {  // the slab's last stage or two: element by element
        const uint32_t gq = used + q, slot = gq % R::kStages;
        mbar_wait(full + slot, (gq / R::kStages) & 1);
        const typename R::Elem* st = ring + slot * R::kSlotElems + t;
        const int m = n - 32 * b < 32 ? n - 32 * b : 32;
        for (int u = 0; mine && u < m; ++u) {
          float a;
          row_runs::unpack<T>(st[u * kSlab], &a);
          w = chain_add<T>(w, a);
        }
        mbar_arrive(empty + slot);
        b += 1;
        q += 1;
      }
    }
    if (kMode == kAdagrad) {  // one slab (the launch checks D): the row's squares in column order
      sq[t] = mine ? __fmul_rn(w, w) : 0.f;
      consumers_sync();
      if (t == 0) {
        float ss = 0.f;
        for (int j = 0; j < D; ++j) ss = __fadd_rn(ss, sq[j]);
        const float a = __fadd_rn(accum[v], __fdiv_rn(ss, static_cast<float>(D)));
        accum[v] = a;
        *s_den = __fadd_rn(__fsqrt_rn(a), eps);
      }
      consumers_sync();
      w = __fdiv_rn(w, *s_den);
    }
    if (mine) {
      if (kMode != kScatter) {  // w holds s_v: the f32 epilogue, one rounding
        float c;
        row_runs::unpack<T>(row_runs::load<1>(row + col), &c);
        w = __fsub_rn(c, __fmul_rn(slr, w));
      }
      row_runs::store<1>(row + col, &w);
    }
  }
}

template <int VEC, typename T, int kMode>
__global__ void __launch_bounds__(kHeavyThreads)
    heavy_kernel(T* cw, float* accum, const T* __restrict__ g, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ ids, const unsigned long long* __restrict__ heavy,
                 int* counters, int D, float slr, float eps) {
  using R = Ring<T>;
  // A producer warp's stages are kProducers apart; its wait on a slot's
  // empty barrier is by parity, so the slot's round before must be consumed
  // when it waits: guaranteed by its own previous wait if kStages >= kProducers.
  static_assert(R::kStages >= kProducers, "a producer would pass a parity wait two rounds ahead");
  row_runs::launch_dependents();  // the light launch may start
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<typename R::Elem*>(smem);
  auto* full = reinterpret_cast<uint64_t*>(smem + R::kBarrierOffset);
  uint64_t* empty = full + R::kStages;
  auto* sq = reinterpret_cast<float*>(empty + R::kStages);
  auto* s_run = reinterpret_cast<int*>(sq + kSlab);
  auto* s_den = reinterpret_cast<float*>(s_run + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, kSlab);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_heavy = counters[0];
  uint32_t used = 0;  // stages through this block's ring so far
  for (;;) {
    if (threadIdx.x == 0) *s_run = atomicAdd(counters + 1, 1);  // the next run, longest first
    __syncthreads();
    const int r = *s_run;
    __syncthreads();
    if (r >= n_heavy) break;
    const unsigned long long key = heavy[r];
    const int n = 0x7fffffff - static_cast<int>(key >> 32), s = static_cast<int>(key & 0xffffffffu);
    const int nb = (n + 31) >> 5, total = nb * ((D + kSlab - 1) / kSlab);
    if (warp < kProducers)
      produce<VEC, T, kMode>(ring, full, empty, g, perm, s, n, nb, total, used, D, -slr, warp, lane);
    else
      consume<T, kMode>(cw, accum, ring, full, empty, sq, s_den, __ldg(ids + s), n, nb, used, D, slr, eps,
                        threadIdx.x - kProducers * 32);
    used += total;
  }
}

// Adds the rest of the run of row v, from sorted position k0 on, into w, one
// rounded add at a time, in stream order: round(-slr * g[i]) (kScaled) or
// g[i]. The
// run's contributors are taken 32 positions of the stream at a time (a
// prefix of each batch, since the stream is sorted); the next batch's ids and
// sources load behind this batch's grad rows.
template <int VEC, bool kScaled, typename T>
__device__ __forceinline__ void walk_run(float* w, const T* __restrict__ g, const int32_t* __restrict__ perm,
                                         const int32_t* __restrict__ ids, int L, int D, int v, int k0,
                                         int colc, float neg_slr) {
  using row_runs::Cvt;
  using Pack = typename row_runs::Pack<T, VEC>::type;
  // grad rows in flight per lane: f32 rows walk their heavy runs here (no
  // ring) and keep the first design's depth; other rows walk only the tails
  // of light runs here, at half of it, which keeps the build shorter
  constexpr int kAhead = sizeof(T) == 4 && VEC == 1 ? 32 : 16;
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
          const float a = kScaled ? Round<T>::of(__fmul_rn(neg_slr, x[e])) : x[e];
          w[e] = chain_add<T>(w[e], a);
        }
      }
    }
    if (n < 32) break;
  }
}

// The f32 epilogue of the run of row v on every lane of the warp (Adagrad
// reduces over the row, which the launch keeps in one warp): w holds the run's
// sum (dense entries) or the updated row (scatter), c the row before the run.
template <int VEC, typename T, int kMode>
__device__ __forceinline__ void finish_run(T* cw, float* accum, int v, float* w, const float* c, int D, int col,
                                           bool mine, float slr, float eps) {
  if (kMode != kScatter) {  // the f32 epilogue, one rounding
    if (kMode == kAdagrad) {  // the row's squares in column order
      float ss = 0.f;
#pragma unroll 1
      for (int l = 0; l < 32; ++l) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float x = __shfl_sync(kFull, __fmul_rn(w[e], w[e]), l);
          if (l * VEC + e < D) ss = __fadd_rn(ss, x);
        }
      }
      const float a = __fadd_rn(accum[v], __fdiv_rn(ss, static_cast<float>(D)));
      const float den = __fadd_rn(__fsqrt_rn(a), eps);
      __syncwarp();  // every lane has read accum[v]
      if ((threadIdx.x & 31) == 0) accum[v] = a;
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[e] = __fdiv_rn(w[e], den);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[e] = __fsub_rn(c[e], __fmul_rn(slr, w[e]));
  }
  if (mine) row_runs::store<VEC>(cw + static_cast<int64_t>(v) * D + col, w);
}

// One warp per 32 positions of the sorted stream: the runs that start there
// and have at most T contributors (a heavy run is a heavy block's, and one
// that started before these positions another warp's). The positions' ids,
// sources and neighbours load at once; then, kAhead positions at a time, the
// grad rows and the rows of the runs that start there load together, and
// the adds run in order in registers, each run's epilogue at its end. A run
// that goes on past the 32 positions is walked on from there (walk_run).
// Lanes own VEC columns.
template <int VEC, typename T, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
    light_kernel(T* cw, float* accum, const T* __restrict__ g, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ ids, int L, int D, float slr, float eps, int T_heavy) {
  using P = typename row_runs::Pack<T, VEC>::type;
  // positions in flight (their grad rows and rows); Adagrad's longer epilogue, once a position, takes 8
  constexpr int kAhead = sizeof(P) > 8 || kMode == kAdagrad ? 8 : 16;
  const int lane = threadIdx.x & 31;
  const int s = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (s < L) {
    const int j = s + lane;
    const int my_id = j < L ? __ldg(ids + j) : -1;
    const int prev = j < L && j > 0 ? __ldg(ids + j - 1) : -1;
    const int my_src = j < L ? __ldg(perm + j) : 0;
    const int after = lane == 31 && j + 1 < L ? __ldg(ids + j + 1) : -1;
    assert(!(j < L && j > 0 && prev > my_id));  // the plan must be sorted by id
    const bool start = j < L && (j == 0 || prev != my_id);
    const bool heavy = start && j + T_heavy < L && __ldg(ids + j + T_heavy) == my_id;
    int next = __shfl_down_sync(kFull, my_id, 1);
    if (lane == 31) next = after;
    const unsigned starts = __ballot_sync(kFull, start);
    const unsigned ends = __ballot_sync(kFull, j < L && next != my_id);
    const unsigned hv = __ballot_sync(kFull, heavy);
    const int first = starts ? __ffs(starts) - 1 : 32;     // the first run that starts here
    const int lim = hv ? __ffs(hv) - 1 : (L - s < 32 ? L - s : 32);  // a heavy run takes the rest
    const bool tail = lim == 32 && !(ends >> 31 & 1);       // the last run goes on past these positions
    for (int col0 = 0; first < lim && col0 < D; col0 += 32 * VEC) {
      const int col = col0 + lane * VEC;
      const bool mine = col < D;
      const int colc = mine ? col : 0;  // lanes past D load a valid address, store nothing
      float w[VEC] = {}, c[VEC] = {};
      int v = 0;
      for (int u0 = first; u0 < lim; u0 += kAhead) {
        P gv[kAhead], pv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int pos = u0 + u;
          const int from = __shfl_sync(kFull, my_src, pos & 31);
          const int rid = __shfl_sync(kFull, my_id, pos & 31);
          gv[u] = pos < lim ? row_runs::ldg<VEC>(g + static_cast<int64_t>(from) * D + colc) : P{};
          pv[u] = pos < lim && (starts >> pos & 1) ? row_runs::load<VEC>(cw + static_cast<int64_t>(rid) * D + colc)
                                                   : P{};
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int pos = u0 + u;
          if (pos >= lim) continue;  // no break: the loop must unroll fully
          if (starts >> pos & 1) {   // a run starts: its row, and its sum from the row (scatter) or +0
            v = __shfl_sync(kFull, my_id, pos);
            row_runs::unpack<T>(pv[u], c);
#pragma unroll
            for (int e = 0; e < VEC; ++e) w[e] = kMode == kScatter ? c[e] : 0.f;
          }
          float x[VEC];
          row_runs::unpack<T>(gv[u], x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float a = kMode == kScatter ? Round<T>::of(__fmul_rn(-slr, x[e])) : x[e];
            w[e] = chain_add<T>(w[e], a);
          }
          if (ends >> pos & 1) finish_run<VEC, T, kMode>(cw, accum, v, w, c, D, col, mine, slr, eps);
        }
      }
      if (tail) {
        walk_run<VEC, kMode == kScatter>(w, g, perm, ids, L, D, v, s + 32, colc, -slr);
        finish_run<VEC, T, kMode>(cw, accum, v, w, c, D, col, mine, slr, eps);
      }
    }
  }
  // the launch ends after the heavy launch it overlaps (a no-op without one)
  if (blockIdx.x == 0 && threadIdx.x == 0) row_runs::wait_for_previous();
}

inline int first_error(cudaError_t e, int rc) { return rc != 0 ? rc : static_cast<int>(e); }

template <int VEC, typename T, int kMode>
int launch_vec(T* cw, float* accum, const T* g, const int32_t* perm, const int32_t* ids, int L, int D,
               float slr, float eps, unsigned long long* scratch, cudaStream_t stream) {
  using R = Ring<T>;
  const int t_heavy = kHasRing<T> ? heavy_threshold(L) : L;  // L: no run is heavy
  const int blocks = (L + 32 * kWarps - 1) / (32 * kWarps);
  if (L <= t_heavy) {  // no heavy run: the light launch alone
    light_kernel<VEC, T, kMode><<<blocks, kWarps * 32, 0, stream>>>(cw, accum, g, perm, ids, L, D, slr, eps,
                                                                     t_heavy);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (!kHasRing<T>) {
    return static_cast<int>(cudaErrorInvalidValue);  // unreachable: t_heavy == L
  } else {
    int rc = 0;
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, sms = 0;
    rc = first_error(cudaGetDevice(&device), rc);
    rc = first_error(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device), rc);
    const int cap = L / (t_heavy + 1);  // at most this many heavy runs (< kMaxHeavy)
    int sort_n = 2;
    while (sort_n < cap) sort_n <<= 1;
    const int sort_smem = sort_n * static_cast<int>(sizeof(unsigned long long));
    rc = first_error(cudaFuncSetAttribute(sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sort_smem),
                     rc);
    rc = first_error(cudaFuncSetAttribute(heavy_kernel<VEC, T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          R::kSmemBytes),
                     rc);
    if (rc != 0) return rc;
    int* counters = reinterpret_cast<int*>(scratch);  // [0] heavy runs found, [1] runs handed out
    unsigned long long* heavy = scratch + 1;
    rc = first_error(cudaMemsetAsync(counters, 0, 2 * sizeof(int), stream), rc);
    classify_kernel<<<blocks, kWarps * 32, 0, stream>>>(ids, L, t_heavy, heavy, counters, cap);
    sort_kernel<<<1, kSortThreads, sort_smem, stream>>>(heavy, counters);
    heavy_kernel<VEC, T, kMode><<<sms, kHeavyThreads, R::kSmemBytes, stream>>>(cw, accum, g, perm, ids, heavy,
                                                                               counters, D, slr, eps);
    rc = first_error(cudaGetLastError(), rc);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kWarps * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = first_error(cudaLaunchKernelEx(&cfg, light_kernel<VEC, T, kMode>, cw, accum, g, perm, ids, L, D, slr, eps,
                                        t_heavy),
                     rc);
    return first_error(cudaGetLastError(), rc);
  }
}

template <typename T, int kMode>
int launch(void* cw, float* accum, const void* g, const int32_t* perm, const int32_t* ids, int64_t L,
           int64_t D, float slr, float eps, void* scratch, cudaStream_t stream) {
  if (L == 0) return 0;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(cw) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  if (kMode == kAdagrad && D > 32 * (vec ? 4 : 1)) return static_cast<int>(cudaErrorInvalidValue);
  T* c = static_cast<T*>(cw);
  const T* gp = static_cast<const T*>(g);
  auto* sc = static_cast<unsigned long long*>(scratch);
  const int l = static_cast<int>(L), d = static_cast<int>(D);
  return vec ? launch_vec<4, T, kMode>(c, accum, gp, perm, ids, l, d, slr, eps, sc, stream)
             : launch_vec<1, T, kMode>(c, accum, gp, perm, ids, l, d, slr, eps, sc, stream);
}

template <int kMode>
int launch_rows(void* cw, float* accum, const void* g, const int32_t* perm, const int32_t* ids, int64_t L,
                int64_t D, float slr, float eps, int dtype, void* scratch, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch<float, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, scratch, st);
    case 1: return launch<__nv_bfloat16, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, scratch, st);
    case 2: return launch<__nv_fp8_e4m3, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, scratch, st);
    case 3: return launch<__nv_fp8_e5m2, kMode>(cw, accum, g, perm, ids, L, D, slr, eps, scratch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// All 2^32 pairs of bf16 operands, 256 a thread: chain_add<bf16> against the
// f32 add then Cvt's rounding. counts[0]: pairs whose bits differ; counts[1]:
// of them, pairs where both are NaN.
__global__ void __launch_bounds__(256) bf16_add_sweep_kernel(unsigned long long* counts) {
  const unsigned gid = blockIdx.x * 256u + threadIdx.x;  // < 2^24
  const float a = __uint_as_float((gid >> 8) << 16);
  unsigned bad = 0, nan = 0;
  for (unsigned k = 0; k < 256; ++k) {
    const float b = __uint_as_float((((gid & 255u) << 8) | k) << 16);
    const float x = chain_add<__nv_bfloat16>(a, b);
    const float y = row_runs::Cvt<__nv_bfloat16>::round(__fadd_rn(a, b));
    if (__float_as_uint(x) != __float_as_uint(y)) {
      ++bad;
      nan += x != x && y != y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_xor_sync(kFull, bad, o);
    nan += __shfl_xor_sync(kFull, nan, o);
  }
  if ((threadIdx.x & 31) == 0 && bad) {
    atomicAdd(counts, static_cast<unsigned long long>(bad));
    atomicAdd(counts + 1, static_cast<unsigned long long>(nan));
  }
}

// The chain's own latency, with no memory and no ring: each of 32 lanes runs
// n dependent links w = chain_add<T>(w, a) in registers from +0, cycling
// through its 8 addends (values of T held in f32), and writes its w.
template <typename T>
__global__ void __launch_bounds__(32) chain_latency_kernel(const float* __restrict__ addends, float* out, int n) {
  float a[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) a[u] = addends[threadIdx.x * 8 + u];
  float w = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) w = chain_add<T>(w, a[u]);
  }
  out[threadIdx.x] = w;
}

}  // namespace

// The check of chain_add<bf16> (not a step's kernel): counts, two 8-byte
// counters, zeroed here.
extern "C" int bf16_add_sweep_launch(void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(counts);
  int rc = static_cast<int>(cudaMemsetAsync(c, 0, 2 * sizeof(unsigned long long), st));
  bf16_add_sweep_kernel<<<1 << 16, 256, 0, st>>>(c);
  return first_error(cudaGetLastError(), rc);
}

// The chain bound's time an add (not a step's kernel): one warp, n links a
// lane (n a multiple of 8); addends: 32 x 8 f32 values of the dtype's rows
// (dtype codes as below); out: 32 f32.
extern "C" int chain_latency_launch(const void* addends, void* out, int64_t n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(addends);
  auto* o = static_cast<float*>(out);
  const int k = static_cast<int>(n);
  if (n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: chain_latency_kernel<float><<<1, 32, 0, st>>>(a, o, k); break;
    case 1: chain_latency_kernel<__nv_bfloat16><<<1, 32, 0, st>>>(a, o, k); break;
    case 2: chain_latency_kernel<__nv_fp8_e4m3><<<1, 32, 0, st>>>(a, o, k); break;
    case 3: chain_latency_kernel<__nv_fp8_e5m2><<<1, 32, 0, st>>>(a, o, k); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2 (cw
// and g share it). ids: the plan's ids_grouped, sorted stably by id; perm
// the stream positions. neg_slr: -slr. scratch: see the head of this file.
extern "C" int ordered_scatter_add_launch(void* cw, const void* g, const int32_t* perm, const int32_t* ids,
                                          int64_t L, int64_t D, float neg_slr, int dtype, void* scratch,
                                          void* stream) {
  return launch_rows<kScatter>(cw, nullptr, g, perm, ids, L, D, -neg_slr, 0.f, dtype, scratch,
                               static_cast<cudaStream_t>(stream));
}

// The same codes, plan and scratch. accum: (C,) f32 row-wise Adagrad
// accumulators, or null for SGD (eps then unused).
extern "C" int ordered_grad_update_launch(void* cw, void* accum, const void* g, const int32_t* perm,
                                          const int32_t* ids, int64_t L, int64_t D, float slr, float eps,
                                          int dtype, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(accum);
  return a == nullptr ? launch_rows<kSgd>(cw, nullptr, g, perm, ids, L, D, slr, 0.f, dtype, scratch, st)
                      : launch_rows<kAdagrad>(cw, a, g, perm, ids, L, D, slr, eps, dtype, scratch, st);
}
