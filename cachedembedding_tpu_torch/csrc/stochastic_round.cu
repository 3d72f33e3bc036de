// Stochastic rounding f32 -> bf16 / fp8 for Hopper (sm_90a): the port of the
// TPU kernel cachedembedding_tpu/ops/rounding.py::_sr_kernel (wrapper
// _stochastic_astype_pallas). Python side: cachedembedding_tpu_torch/ops/rounding.py.
//
//   out[i] = hi if u[i] < (x - lo) / (hi - lo) else lo,   x = clip(x[i], +-max)
//
// lo <= x <= hi are x's neighbours in the target type, found from the
// round-to-nearest value by one step of the monotonic bit key; u[i] is word
// i % 4 of Philox4x32-10 at counter (i / 4, 0, 0, 0) with key (seed, 0), as
// (word >> 8) * 2^-24. E[out] = x. The TPU kernel used the TPU's hardware
// generator and pltpu.stochastic_round; this kernel computes the plain
// version's arithmetic (sr_from_uniform) step for step, every float operation
// correctly rounded (__fsub_rn, __fdiv_rn, nothing to contract), so the two
// give the same bits for the same seed. The clamps are written as selects,
// which keep NaN as torch.clamp does (fminf would drop it): at x = 448 the
// e4m3fn step above is NaN, and both must then take lo.
//
// What bounds it: bytes — the (n,) f32 read and the (n,) 1- or 2-byte write,
// about 577 MB at the main path's (901,228 x 128) fp8 rows, some 0.172 ms at
// 3.35 TB/s. Philox adds 10 rounds of two 32-bit multiplies per 4 elements.
// Design: one thread per Philox call, i.e. per 4 consecutive elements, read
// as one float4 where x is 16-byte aligned.
//
// C interface, loaded with ctypes: returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Bf16 {
  using Store = uint16_t;
  static constexpr uint32_t kSign = 0x8000u;
  __device__ static float max() { return __uint_as_float(0x7F7F0000u); }
  __device__ static uint32_t round(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static float value(uint32_t b) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
  }
};

template <__nv_fp8_interpretation_t kKind, uint32_t kMaxBits>
struct Fp8 {
  using Store = uint8_t;
  static constexpr uint32_t kSign = 0x80u;
  __device__ static float max() { return value(kMaxBits); }
  __device__ static uint32_t round(float x) {
    return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, kKind);  // nearest even; x is in range
  }
  __device__ static float value(uint32_t b) {
    return __half2float(
        __half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), kKind)));
  }
};

using E4M3 = Fp8<__NV_E4M3, 0x7Eu>;  // max 448
using E5M2 = Fp8<__NV_E5M2, 0x7Bu>;  // max 57344

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

// monotonic unsigned key of a bit pattern, and its inverse
template <class T>
__device__ __forceinline__ uint32_t key_of(uint32_t u) {
  return (u & T::kSign) ? (2 * T::kSign - 1) - u : (u | T::kSign);
}
template <class T>
__device__ __forceinline__ uint32_t key_inv(uint32_t k) {
  return (k & T::kSign) ? (k ^ T::kSign) : (2 * T::kSign - 1) - k;
}

template <class T>
__device__ __forceinline__ typename T::Store round_one(float x, float u) {
  const float fmax = T::max();
  x = x < -fmax ? -fmax : x;  // torch.clamp: NaN passes
  x = x > fmax ? fmax : x;
  const uint32_t a = T::round(x);
  const float af = T::value(a);
  const uint32_t key = key_of<T>(a);
  const uint32_t kup = key + 1 < 2 * T::kSign - 1 ? key + 1 : 2 * T::kSign - 1;
  const uint32_t kdn = key == 0 ? 0 : key - 1;
  const float upf = T::value(key_inv<T>(kup));
  const float dnf = T::value(key_inv<T>(kdn));
  const bool below = af <= x;
  float lo = below ? af : dnf;
  float hi = below ? upf : af;
  hi = hi > fmax ? fmax : hi;  // clamp_max: NaN stays NaN, +inf becomes max
  lo = lo < -fmax ? -fmax : lo;
  const float span = __fsub_rn(hi, lo);
  const float p = span > 0.f ? __fdiv_rn(__fsub_rn(x, lo), span) : 0.f;
  return static_cast<typename T::Store>(T::round(u < p ? hi : lo));
}

template <class T>
__global__ void stochastic_round_kernel(const float* __restrict__ x,
                                        typename T::Store* __restrict__ out, int64_t n,
                                        uint32_t seed, bool x_aligned) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t i0 = 4 * j;
  if (i0 >= n) return;
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(j), static_cast<uint32_t>(j >> 32), 0u, 0u), seed, 0u);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  float v[4];
  if (x_aligned && i0 + 3 < n) {
    const float4 q = reinterpret_cast<const float4*>(x)[j];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < n ? x[i0 + k] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < n)
      out[i0 + k] = round_one<T>(v[k], static_cast<float>(words[k] >> 8) * 0x1p-24f);
  }
}

template <class T>
int launch(const float* x, void* out, int64_t n, uint32_t seed, cudaStream_t stream) {
  const int threads = 256;
  const int64_t groups = (n + 3) / 4;
  const int64_t blocks = (groups + threads - 1) / threads;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  stochastic_round_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, static_cast<typename T::Store*>(out), n, seed, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float8_e4m3fn, 2 = float8_e5m2.
extern "C" int stochastic_round_launch(const float* x, void* out, int64_t n, uint32_t seed,
                                       int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<Bf16>(x, out, n, seed, st);
  if (dtype == 1) return launch<E4M3>(x, out, n, seed, st);
  if (dtype == 2) return launch<E5M2>(x, out, n, seed, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
