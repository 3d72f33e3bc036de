// Stochastic rounding f32 -> bf16 / fp8 for Hopper (sm_90a): the port of the
// TPU kernel cachedembedding_tpu/ops/rounding.py::_sr_kernel (wrapper
// _stochastic_astype_pallas). Python side: cachedembedding_tpu_torch/ops/rounding.py.
//
//   out[i] = hi if u[i] < (x - lo) / (hi - lo) else lo,   x = clip(x[i], +-max)
//
// lo <= x <= hi are x's neighbours in the target type; u[i] is word i % 4 of
// Philox4x32-10 at counter (i / 4, 0, 0, 0) with key (seed, 0), as
// (word >> 8) * 2^-24. E[out] = x. The TPU kernel used the TPU's hardware
// generator and pltpu.stochastic_round; this kernel gives the plain version's
// bits (sr_from_uniform on philox_uniform) for every f32 input and seed.
//
// Two entries share one kernel: stochastic_round_launch rounds an f32 array
// into another; stochastic_sgd_round_launch rounds x = cw - slr * g into the
// storage rows cw in place (x formed in registers as fmaf(-slr, g, cw), which
// is what torch.sub(cw.float(), g, alpha=slr) computes on the card), so the
// step never writes a (C, D) f32 x.
//
// The rounding in integer arithmetic. Write |x| (clipped) in units of 2^-24
// of the target's grid step at |x|: V = n * 2^24 + D, with n whole steps and
// D the dropped part. For a normal target value D is the dropped mantissa
// bits shifted left (by 4 for e4m3, 3 for e5m2, 8 for bf16); below the
// target's smallest normal more than 24 bits can drop, and D keeps a
// fraction. With u = k * 2^-24 the plain version's test becomes exactly:
//   x > 0: the magnitude goes up iff (2^24 - 1 - k) + ceil(D) >= 2^24;
//   x < 0: iff k + rne(D) >= 2^24, because the plain version's x - lo =
//          step - |d| rounds to f32 (round to nearest even) where D has a
//          fraction; elsewhere it is exact and rne(D) = ceil(D) = D.
// The output code is the truncated code plus that carry, which rolls into
// the exponent field by itself. NaN inputs follow the plain version: +NaN ->
// 448 (0x7E) and -NaN -> 0xFF for e4m3fn, NaN kept for e5m2, and for bf16 the
// plain version's own casts (__float2bfloat16_rn, as torch) are replayed.
// Subnormal f32 inputs are kept (no -ftz): CUDA and torch keep them.
//
// What bounds it: not the bytes — the (n,) f32 read and the 1- or 2-byte
// write, 577 MB at the main path's (901,228 x 128) fp8 rows, 0.172 ms at
// 3.35 TB/s (the fused entry: rows read and written, f32 grad read, 692
// MB) — but the integer pipe, which runs at half rate on Hopper: Philox is
// 10 rounds of two 32x32->64 multiplies and two XORs per 4 elements, and the
// rounding some 25 integer operations an element, with no conversion or
// division. Layout: a warp takes 128 Philox groups (512 elements) at a
// time, lane l groups l, l + 32, l + 64, l + 96: four 16-byte loads per
// lane, each warp-coalesced, all in flight before any arithmetic, and packed
// 4- (fp8) or 8-byte (bf16) stores; a grid-stride loop over a grid of as
// many resident blocks as the card holds. Unaligned pointers and the ragged
// end take element-wise loads and stores.
//
// C interface, loaded with ctypes: each entry returns cudaGetLastError() of
// its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kOne = 1u << 24;  // u = k * 2^-24 with k < kOne
constexpr int kThreads = 256;
constexpr int kGroupsPerLane = 4;    // Philox groups of 4 elements a lane per pass

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

struct Bf16 {
  using Store = uint16_t;
  using Pack = uint2;  // the codes of one group of 4
  // b: the f32 bits of x; k: the 24-bit uniform integer
  __device__ static uint32_t code(uint32_t b, uint32_t k) {
    const uint32_t s = static_cast<uint32_t>(static_cast<int32_t>(b) >> 31);  // all ones where x < 0
    const uint32_t ax = b & 0x7FFFFFFFu;
    if (ax > 0x7F800000u) return nan_code(b);
    const uint32_t a = min(ax, 0x7F7F0000u);     // clip to +-max (inf included)
    const uint32_t kk = k ^ (~s & (kOne - 1));   // k for x < 0, 2^24 - 1 - k for x > 0
    return ((a >> 16) + ((kk + ((a & 0xFFFFu) << 8)) >> 24)) | (s & 0x8000u);
  }
  // NaN: the plain version's steps with its casts: a = bf16(x) (a NaN);
  // below is false, so it returns the code one step below a by the
  // monotonic key, cast through f32 and back.
  __device__ static uint32_t nan_code(uint32_t b) {
    const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(b)));
    uint32_t key = (a & 0x8000u) ? 0xFFFFu - a : (a | 0x8000u);
    key = key ? key - 1 : 0;
    const uint32_t lo = (key & 0x8000u) ? (key ^ 0x8000u) : 0xFFFFu - key;
    return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(lo << 16)));
  }
  __device__ static float value(uint32_t c) { return __uint_as_float(c << 16); }
  __device__ static void values(Pack p, float* v) {
    v[0] = value(p.x & 0xFFFFu); v[1] = value(p.x >> 16);
    v[2] = value(p.y & 0xFFFFu); v[3] = value(p.y >> 16);
  }
  __device__ static Pack pack(const uint32_t* c) {
    return make_uint2(c[0] | (c[1] << 16), c[2] | (c[3] << 16));
  }
};

// kM mantissa bits, kEmin the biased f32 exponent of the smallest normal,
// kMaxBits the f32 bits of the largest finite value
template <__nv_fp8_interpretation_t kKind, int kM, int kEmin, uint32_t kMaxBits>
struct Fp8 {
  using Store = uint8_t;
  using Pack = uint32_t;
  __device__ static uint32_t code(uint32_t b, uint32_t k) {
    const uint32_t s = static_cast<uint32_t>(static_cast<int32_t>(b) >> 31);  // all ones where x < 0
    const uint32_t ax = b & 0x7FFFFFFFu;
    const uint32_t a = min(ax, kMaxBits);             // clip to +-max (inf included)
    const int e = max(static_cast<int>(a >> 23), 1);  // biased exponent; f32 subnormals at 1
    const uint32_t m = a - (static_cast<uint32_t>(e - 1) << 23);  // significand, leading bit included
    const int lo = min(e, kEmin);
    const int sh = lo - (kEmin - kM - 1);             // |x| = m * 2^sh grid units of 2^-24 steps
    const uint32_t v = m << max(sh, 0);
    // below half the smallest step D keeps r fraction bits: ceil(D) for x > 0,
    // rne(D) for x < 0; beyond 25 bits the outcome no longer changes
    const int r = min(max(-sh, 0), 25);
    const uint32_t mask = (1u << r) - 1;
    const uint32_t add = (s & ((mask + ((v >> r) & 1u)) >> 1)) | (~s & mask);
    const uint32_t w = (v + add) >> r;                // n * 2^24 + D, n whole steps
    const uint32_t kk = k ^ (~s & (kOne - 1));        // k for x < 0, 2^24 - 1 - k for x > 0
    const uint32_t c = (static_cast<uint32_t>(e - lo) << kM) + ((kk + w) >> 24);
    return ax > 0x7F800000u ? nan_code(s) : c | (s & 0x80u);
  }
  __device__ static uint32_t nan_code(uint32_t s) {
    // e4m3fn: the cast of +NaN is 0x7F, whose step below is 448; -NaN stays
    // 0xFF. e5m2: both NaN codes step down to another NaN, cast back to
    // 0x7F | sign.
    return kKind == __NV_E4M3 ? (s ? 0xFFu : 0x7Eu) : (0x7Fu | (s & 0x80u));
  }
  __device__ static float value(uint32_t c) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(c), kKind)));
  }
  __device__ static void values(Pack p, float* v) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2 w(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(p >> (16 * h)), kKind));
      const float2 f = __half22float2(w);
      v[2 * h] = f.x;
      v[2 * h + 1] = f.y;
    }
  }
  __device__ static Pack pack(const uint32_t* c) { return c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24); }
};

using E4M3 = Fp8<__NV_E4M3, 3, 121, 0x43E00000u>;  // max 448, smallest normal 2^-6
using E5M2 = Fp8<__NV_E5M2, 2, 113, 0x47600000u>;  // max 57344, smallest normal 2^-14

// kFused: x = fmaf(neg_slr, src, value(rows)), rounded into rows in place
// (rows is read and written at the same index, so it is not __restrict__);
// else x = src, rounded into rows. kVec: every pointer aligned for the
// group-wide loads and stores.
template <class T, bool kFused, bool kVec>
__global__ void __launch_bounds__(kThreads) stochastic_round_kernel(
    const float* __restrict__ src, typename T::Store* rows, int64_t n, uint32_t seed, float neg_slr) {
  using Store = typename T::Store;
  using Pack = typename T::Pack;
  const int lane = threadIdx.x & 31;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kThreads / 32) * 32 * kGroupsPerLane;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) *
                      32 * kGroupsPerLane;
       base < groups; base += stride) {
    float x[kGroupsPerLane][4];
#pragma unroll
    for (int q = 0; q < kGroupsPerLane; ++q) {  // every load first
      const int64_t j = base + q * 32 + lane, i0 = 4 * j;
      if (kVec && i0 + 3 < n) {
        const float4 s = reinterpret_cast<const float4*>(src)[j];
        x[q][0] = s.x; x[q][1] = s.y; x[q][2] = s.z; x[q][3] = s.w;
        if (kFused) {
          float c[4];
          T::values(reinterpret_cast<const Pack*>(rows)[j], c);
#pragma unroll
          for (int t = 0; t < 4; ++t) x[q][t] = fmaf(neg_slr, x[q][t], c[t]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int64_t i = i0 + t;
          x[q][t] = i < n ? (kFused ? fmaf(neg_slr, src[i], T::value(rows[i])) : src[i]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kGroupsPerLane; ++q) {
      const int64_t j = base + q * 32 + lane, i0 = 4 * j;
      if (j >= groups) continue;
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<uint32_t>(j), static_cast<uint32_t>(j >> 32), 0u, 0u), seed, 0u);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t c[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) c[t] = T::code(__float_as_uint(x[q][t]), words[t] >> 8);
      if (kVec && i0 + 3 < n) {
        reinterpret_cast<Pack*>(rows)[j] = T::pack(c);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (i0 + t < n) rows[i0 + t] = static_cast<Store>(c[t]);
      }
    }
  }
}

template <class T, bool kFused, bool kVec>
int launch_with(const float* src, void* rows, int64_t n, uint32_t seed, float neg_slr, cudaStream_t st) {
  auto kernel = stochastic_round_kernel<T, kFused, kVec>;
  static int resident = 0;  // blocks the card holds at once, found at the first launch
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t per_block = static_cast<int64_t>(kThreads) * kGroupsPerLane;  // groups a block takes a pass
  const int64_t need = ((n + 3) / 4 + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  kernel<<<blocks, kThreads, 0, st>>>(src, static_cast<typename T::Store*>(rows), n, seed, neg_slr);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool kFused>
int launch(const float* src, void* rows, int64_t n, uint32_t seed, float neg_slr, cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % sizeof(typename T::Pack) == 0);
  return vec ? launch_with<T, kFused, true>(src, rows, n, seed, neg_slr, st)
             : launch_with<T, kFused, false>(src, rows, n, seed, neg_slr, st);
}

template <bool kFused>
int dispatch(const float* src, void* rows, int64_t n, uint32_t seed, float neg_slr, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<Bf16, kFused>(src, rows, n, seed, neg_slr, st);
  if (dtype == 1) return launch<E4M3, kFused>(src, rows, n, seed, neg_slr, st);
  if (dtype == 2) return launch<E5M2, kFused>(src, rows, n, seed, neg_slr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float8_e4m3fn, 2 = float8_e5m2.
extern "C" int stochastic_round_launch(const float* x, void* out, int64_t n, uint32_t seed, int dtype,
                                       void* stream) {
  return dispatch<false>(x, out, n, seed, 0.f, dtype, stream);
}

// rows (n elements of dtype) = stochastic_round(rows - slr * g), in place.
extern "C" int stochastic_sgd_round_launch(void* rows, const float* g, int64_t n, float slr, uint32_t seed,
                                           int dtype, void* stream) {
  return dispatch<true>(g, rows, n, seed, -slr, dtype, stream);
}
