// Native host-DRAM staging ops: the port's own copy of the functions of
// cachedembedding_tpu/_native/hostops.cpp that the cached-training slice
// calls. Keep them bit-for-bit in step with the JAX package's copy
// (tests/test_torch_native.py and tests/test_torch_ops.py hold the two
// against each other):
//   * multithreaded row gather/scatter over a large f32 host table;
//   * the canonical procedural row init (gen_row_canonical), shared
//     bit-for-bit with ops/synth_rows.py on the device;
//   * the overlay (virtual) host table;
//   * sort_plan_i32, the bin-grouping plan of the fused embedding update.
//
// Built at first use by cachedembedding_tpu_torch/_native/hostops.py
// (g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread) together with
// directory.cpp into one libhostops.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline unsigned n_workers(int64_t items, int64_t min_per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t want = items / min_per_thread;
  if (want < 1) want = 1;
  return static_cast<unsigned>(want < hw ? want : hw);
}

template <typename Fn>
void parallel_for(int64_t n, int64_t min_per_thread, Fn fn) {
  unsigned workers = n_workers(n, min_per_thread);
  if (workers <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (unsigned w = 0; w < workers; ++w) {
    int64_t lo = static_cast<int64_t>(w) * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// out[i, :] = table[idx[i], :]
// Random-access rows from a huge table are DRAM-latency bound; software
// prefetch of rows a few iterations ahead hides most of it.
void gather_rows_f32(const float* table, const int64_t* idx, float* out,
                     int64_t n, int64_t dim, int64_t num_rows) {
  const size_t row_bytes = static_cast<size_t>(dim) * sizeof(float);
  constexpr int64_t kAhead = 8;
  parallel_for(n, 4096, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kAhead < hi) {
        int64_t pr = idx[i + kAhead];
        if (pr >= 0 && pr < num_rows) {
          const char* p = reinterpret_cast<const char*>(table + pr * dim);
          for (size_t b = 0; b < row_bytes; b += 64) __builtin_prefetch(p + b, 0, 0);
        }
      }
      int64_t r = idx[i];
      if (r < 0 || r >= num_rows) r = 0;  // defensive clamp (padded entries)
      std::memcpy(out + i * dim, table + r * dim, row_bytes);
    }
  });
}

// table[idx[i], :] = values[i, :]
void scatter_rows_f32(float* table, const int64_t* idx, const float* values,
                      int64_t n, int64_t dim, int64_t num_rows) {
  const size_t row_bytes = static_cast<size_t>(dim) * sizeof(float);
  // Duplicate idx entries would race under threads; the cache never passes
  // duplicates (victim slots / evicted rows are unique per plan).
  parallel_for(n, 4096, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = idx[i];
      if (r < 0 || r >= num_rows) continue;
      std::memcpy(table + r * dim, values + i * dim, row_bytes);
    }
  });
}

// Bin-grouping plan for the fused embedding update
// (cachedembedding_tpu_torch/ops/binned_scatter.py): stable counting sort of
// the id stream by (id / block_rows) bin, in two linear passes. The kernel
// needs only bin-contiguity, not a full sort.
// Outputs: perm (n), ids_grouped (n), bin_starts (nb+1).
void sort_plan_i32(const int32_t* ids, int64_t n, int64_t num_rows,
                   int64_t block_rows, int32_t* perm, int32_t* ids_grouped,
                   int32_t* bin_starts) {
  const int64_t nb = (num_rows + block_rows - 1) / block_rows;
  std::vector<int64_t> cur(nb + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++cur[ids[i] / block_rows + 1];
  int64_t cum = 0;
  for (int64_t b = 0; b <= nb; ++b) {
    cum += cur[b];
    cur[b] = cum;
    bin_starts[b] = static_cast<int32_t>(cum);
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = cur[ids[i] / block_rows]++;
    perm[p] = static_cast<int32_t>(i);
    ids_grouped[p] = ids[i];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical procedural row init, shared bit-for-bit with the device-side
// generator (cachedembedding_tpu_torch/ops/synth_rows.py). Embedding init is a
// pure function of (global row id, column, seed), so a never-trained row never
// has to cross the host->device link: the device materializes it locally.
// 32-bit ops only.
// ---------------------------------------------------------------------------

namespace {

inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// out[j] = U(-bound, bound) from hash(row, j, seed). The value is one fused
// multiply-add, fma(h>>8, scale, -bound), rounded once — what the JAX
// package's generators compute (g++ -march=native and XLA both contract it);
// std::fma makes it independent of the compiler's contraction choice, and
// ops/synth_rows.py computes the same single rounding on the device.
inline void gen_row_canonical(int64_t row_id, uint32_t seed, float bound,
                              float* out, int64_t dim) {
  const uint32_t h0 = mix32(static_cast<uint32_t>(row_id) * 0x9e3779b1U + seed);
  const float scale = 2.0f * bound * (1.0f / 16777216.0f);
  for (int64_t j = 0; j < dim; ++j) {
    const uint32_t h = mix32(h0 ^ (static_cast<uint32_t>(j) * 0x85ebca77U + 1U));
    out[j] = std::fma(static_cast<float>(h >> 8), scale, -bound);
  }
}

}  // namespace

extern "C" {

// Initialize rows [start_row, start_row + n) of a table slab with the
// canonical generator (multithreaded).
void fill_rows_canonical(float* buf, int64_t start_row, int64_t n, int64_t dim,
                         uint32_t seed, float bound) {
  parallel_for(n, 1 << 14, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      gen_row_canonical(start_row + i, seed, bound, buf + i * dim, dim);
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Overlay table: a virtual host embedding table. Un-written rows are generated
// procedurally (the canonical generator with a per-row bound); written rows
// live in an open-addressing hash table. Host memory cost is the touched
// working set, not num_rows * dim.
// ---------------------------------------------------------------------------

namespace {

struct Overlay {
  int64_t dim;
  uint64_t seed;
  uint64_t mask;        // slots - 1 (power of two)
  int64_t used;
  std::vector<int64_t> keys;   // -1 = empty
  std::vector<float> rows;     // slots * dim

  explicit Overlay(int64_t d, uint64_t s, uint64_t slots) : dim(d), seed(s) {
    uint64_t cap = 64;
    while (cap < slots) cap <<= 1;
    mask = cap - 1;
    used = 0;
    keys.assign(cap, -1);
    rows.assign(cap * static_cast<uint64_t>(d), 0.f);
  }
};

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

// find slot for key; returns slot index, or the empty slot where it would go.
inline uint64_t probe(const Overlay& t, int64_t key) {
  uint64_t h = mix64(static_cast<uint64_t>(key) ^ t.seed) & t.mask;
  while (t.keys[h] != -1 && t.keys[h] != key) h = (h + 1) & t.mask;
  return h;
}

void overlay_grow(Overlay& t) {
  Overlay bigger(t.dim, t.seed, (t.mask + 1) * 2);
  for (uint64_t s = 0; s <= t.mask; ++s) {
    if (t.keys[s] == -1) continue;
    uint64_t ns = probe(bigger, t.keys[s]);
    bigger.keys[ns] = t.keys[s];
    std::memcpy(&bigger.rows[ns * t.dim], &t.rows[s * t.dim], t.dim * sizeof(float));
  }
  bigger.used = t.used;
  t = std::move(bigger);
}

}  // namespace

extern "C" {

void* overlay_create(int64_t dim, uint64_t seed, int64_t capacity_hint) {
  return new Overlay(dim, seed, static_cast<uint64_t>(capacity_hint * 2));
}

void overlay_free(void* h) { delete static_cast<Overlay*>(h); }

int64_t overlay_used(void* h) { return static_cast<Overlay*>(h)->used; }

// Dump the written row ids (out must have room for overlay_used entries).
void overlay_keys(void* h, int64_t* out) {
  Overlay& t = *static_cast<Overlay*>(h);
  int64_t j = 0;
  for (uint64_t s = 0; s <= t.mask; ++s) {
    if (t.keys[s] != -1) out[j++] = t.keys[s];
  }
}

// out[i] = overlay[ids[i]] if written else procedural(ids[i], bounds[i])
void overlay_gather_f32(void* h, const int64_t* ids, const float* bounds,
                        float* out, int64_t n) {
  Overlay& t = *static_cast<Overlay*>(h);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t s = probe(t, ids[i]);
    if (t.keys[s] == ids[i]) {
      std::memcpy(out + i * t.dim, &t.rows[s * t.dim], t.dim * sizeof(float));
    } else {
      gen_row_canonical(ids[i], static_cast<uint32_t>(t.seed), bounds[i],
                        out + i * t.dim, t.dim);
    }
  }
}

// out[i] = 1 if ids[i] has been written (lives in the overlay), else 0.
void overlay_contains(void* h, const int64_t* ids, uint8_t* out, int64_t n) {
  Overlay& t = *static_cast<Overlay*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = t.keys[probe(t, ids[i])] == ids[i] ? 1 : 0;
  }
}

void overlay_scatter_f32(void* h, const int64_t* ids, const float* vals, int64_t n) {
  Overlay& t = *static_cast<Overlay*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (static_cast<uint64_t>(t.used) * 4 >= (t.mask + 1) * 3) overlay_grow(t);
    uint64_t s = probe(t, ids[i]);
    if (t.keys[s] == -1) {
      t.keys[s] = ids[i];
      ++t.used;
    }
    std::memcpy(&t.rows[s * t.dim], vals + i * t.dim, t.dim * sizeof(float));
  }
}

}  // extern "C"
