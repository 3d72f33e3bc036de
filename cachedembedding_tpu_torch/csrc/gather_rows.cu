// Row gather for Hopper (sm_90a): the port of the TPU kernel
// cachedembedding_tpu/ops/pallas_bag.py::_gather_kernel (wrapper
// gather_rows_pallas). Python side: cachedembedding_tpu_torch/ops/gather_rows.py.
//
//   out[n * F + f, :] = w[ids[f * N + n], :]     for f < F, n < N
//
// ids arrive feature-major (F, N) as the cache plans them, and the rows land
// straight in the (N, F, D) layout the DLRM interaction consumes, so no
// transpose of the gathered rows follows (the JAX path transposes after the
// Pallas call). F == 1 is the plain flat gather w[ids].
//
// What bounds it: bytes. Each output row is one random read of a row of w
// and one coalesced write; the ids add 4 bytes a row. At the main-path shape
// (425,984 rows of 256 B bf16) that is at most about 220 MB, some 65 us at
// 3.35 TB/s; skewed ids repeat rows, which then come from L2, so the least
// device-memory traffic reads each distinct row once.
// Design: a group of row_bytes/16 threads copies one row with 16-byte vector
// loads and stores (a 256 B bf16 row is 16 lanes, so a warp moves two rows);
// every thread makes one independent load, so the latency of the random row
// reads is hidden by the many rows in flight per SM, where the TPU kernel
// kept a rolling window of 16 row DMAs per tile. No tiling restriction on the
// row count (the TPU kernel needed L % 1024 == 0).
//
// C interface, loaded with ctypes: returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void gather_rows_kernel(const uint4* __restrict__ w,
                                   const int32_t* __restrict__ ids,
                                   uint4* __restrict__ out, int64_t F, int64_t N,
                                   int vecs_per_row, int lanes_per_row,
                                   int rows_per_block) {
  const int rib = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x - rib * lanes_per_row;
  if (rib >= rows_per_block) return;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows_per_block + rib;
  if (row >= F * N) return;
  const int64_t n = row / F;
  const int64_t f = row - n * F;
  const int64_t src = __ldg(ids + f * N + n);
  const uint4* s = w + src * vecs_per_row;
  uint4* d = out + row * vecs_per_row;
  for (int v = lane; v < vecs_per_row; v += lanes_per_row) d[v] = __ldg(s + v);
}

}  // namespace

extern "C" int gather_rows_launch(const void* w, const int32_t* ids, void* out,
                                  int64_t F, int64_t N, int64_t row_bytes,
                                  void* stream) {
  if (F * N == 0) return 0;
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vecs_per_row = static_cast<int>(row_bytes / 16);
  const int lanes_per_row = vecs_per_row < 256 ? vecs_per_row : 256;
  const int rows_per_block = 256 / lanes_per_row;
  const int threads = rows_per_block * lanes_per_row;
  const int64_t blocks = (F * N + rows_per_block - 1) / rows_per_block;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), ids, static_cast<uint4*>(out), F, N,
      vecs_per_row, lanes_per_row, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
