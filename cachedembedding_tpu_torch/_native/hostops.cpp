// Native host-DRAM staging ops: the port's own copy of the functions of
// cachedembedding_tpu/_native/hostops.cpp that the cached-training slice
// calls. Keep them bit-for-bit in step with the JAX package's copy, but for
// the plan's order inside a bin (tests/test_torch_native.py and
// tests/test_torch_ops.py hold the two against each other):
//   * multithreaded row gather/scatter over a large f32 host table, the
//     gather writing f32 or bf16 rows (the port's own: the device planner's
//     admits land in the pinned buffer that the host->device copy reads);
//   * concat_minmax_i32, the device planner's window ids copied back to
//     back with their min and max (the port's own: the JAX package
//     concatenates, then scans);
//   * the canonical procedural row init (gen_row_canonical), shared
//     bit-for-bit with ops/synth_rows.py on the device;
//   * the overlay (virtual) host table, its gathers multithreaded, the rows'
//     writing f32 or bf16 rows and the accumulators' a default for rows
//     never written (the port's own);
//   * sort_plan_i32, the plan of the embedding update kernels (the JAX
//     copy's bin grouping, sorted by row within each bin);
//   * bincount_i64, the id-frequency pass;
//   * the window id wire: fixed-width packing, the escape-coded pack and
//     the rank-tier encoder (the end of this file).
//
// Built at first use by cachedembedding_tpu_torch/_native/hostops.py
// (g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread) together with
// directory.cpp into one libhostops.so.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

inline unsigned n_workers(int64_t items, int64_t min_per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t want = items / min_per_thread;
  if (want < 1) want = 1;
  return static_cast<unsigned>(want < hw ? want : hw);
}

template <typename Fn>
void parallel_for(int64_t n, int64_t min_per_thread, Fn fn, unsigned max_workers = ~0u) {
  unsigned workers = std::min(n_workers(n, min_per_thread), max_workers);
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

// d[0, m) = s[0, m), folding each value into [l, h]. Where AVX2 is built
// in, by streaming stores: the destination is read next by the card's copy
// engine, not by this core, so its lines need not be read in first.
inline void copy_minmax_i32(const int32_t* __restrict s, int32_t* __restrict d, int64_t m, int32_t& l,
                            int32_t& h) {
  int64_t i = 0;
#if defined(__AVX2__)
  for (; i < m && (reinterpret_cast<uintptr_t>(d + i) & 31); ++i) {
    l = std::min(l, s[i]);
    h = std::max(h, s[i]);
    d[i] = s[i];
  }
  __m256i vl = _mm256_set1_epi32(l), vh = _mm256_set1_epi32(h);
  for (; i + 8 <= m; i += 8) {
    const __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    _mm256_stream_si256(reinterpret_cast<__m256i*>(d + i), v);
    vl = _mm256_min_epi32(vl, v);
    vh = _mm256_max_epi32(vh, v);
  }
  alignas(32) int32_t lanes_l[8], lanes_h[8];
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes_l), vl);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes_h), vh);
  for (int j = 0; j < 8; ++j) {
    l = std::min(l, lanes_l[j]);
    h = std::max(h, lanes_h[j]);
  }
#endif
  for (; i < m; ++i) {
    l = std::min(l, s[i]);
    h = std::max(h, s[i]);
    d[i] = s[i];
  }
}

// Row gathers: at most 4 workers, each of at least kRowsPerWorker rows,
// prefetching kAhead rows ahead. On the 8-core host of an H100, a
// 50,000-row bf16 chunk of a 204M-row virtual table (3M rows written) took
// 4.3 ms (median) with 4 workers against 11.6 with one, 5.4 without the
// rows' prefetch, and 3.7 with 8 workers and a two-stage prefetch, under
// the 4.3-7.4 that this setting read on two such hosts; the single-threaded
// gather it replaced took 10.5 for f32 rows alone.
constexpr int64_t kRowsPerWorker = 2048;
constexpr unsigned kRowWorkers = 4;
constexpr int64_t kAhead = 8;

inline void prefetch_bytes(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t b = 0; b < bytes; b += 64) __builtin_prefetch(c + b, 0, 0);
}

// f32 -> bf16 bits, rounded to nearest even: torch's Tensor.to(bfloat16) on
// every non-NaN value (ties, infinities and subnormals included); a NaN
// becomes a quiet NaN of the same sign. Branch-free, so the row loop
// vectorizes.
inline uint16_t bf16_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  const uint32_t rounded = (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
  const uint32_t quiet = (u >> 16) | 0x0040u;
  return static_cast<uint16_t>((u & 0x7FFFFFFFu) > 0x7F800000u ? quiet : rounded);
}

// row i of out (dim values, f32 or bf16) = src[0, dim)
inline void store_row(const float* __restrict src, void* out, int64_t i, int64_t dim, bool bf16) {
  if (bf16) {
    uint16_t* __restrict d = static_cast<uint16_t*>(out) + i * dim;
    for (int64_t j = 0; j < dim; ++j) d[j] = bf16_bits(src[j]);
  } else {
    std::memcpy(static_cast<float*>(out) + i * dim, src, static_cast<size_t>(dim) * sizeof(float));
  }
}

}  // namespace

extern "C" {

// out[i, :] = table[idx[i], :], f32 or (out_bf16) bf16 rounded to nearest
// even. Random-access rows from a huge table are DRAM-latency bound;
// software prefetch of rows a few iterations ahead hides most of it.
void gather_rows(const float* table, const int64_t* idx, void* out, int64_t n, int64_t dim,
                 int64_t num_rows, int32_t out_bf16) {
  const size_t row_bytes = static_cast<size_t>(dim) * sizeof(float);
  parallel_for(n, kRowsPerWorker, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kAhead < hi) {
        int64_t pr = idx[i + kAhead];
        if (pr >= 0 && pr < num_rows) prefetch_bytes(table + pr * dim, row_bytes);
      }
      int64_t r = idx[i];
      if (r < 0 || r >= num_rows) r = 0;  // defensive clamp (padded entries)
      store_row(table + r * dim, out, i, dim, out_bf16 != 0);
    }
  }, kRowWorkers);
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

// dst = the n_src int32 arrays srcs[k] (lens[k] ids each) back to back, and
// minmax = {min, max} over them ({INT32_MAX, INT32_MIN} for no ids), in one
// multithreaded pass: the device planner's window ids copied into the pinned
// staging buffer that the host->device copy reads, range-checked on the way.
// At most 4 workers: the pass is bound by the host's memory. On the 8-core
// Xeon host of an H100, 4 workers with streaming stores took 7.4 ms (median)
// for 14.0M ids where 8 workers with plain stores took 11.0.
void concat_minmax_i32(const int32_t* const* srcs, const int64_t* lens, int64_t n_src,
                       int32_t* dst, int32_t* minmax) {
  std::vector<int64_t> starts(n_src + 1, 0);
  for (int64_t k = 0; k < n_src; ++k) starts[k + 1] = starts[k] + lens[k];
  std::atomic<int32_t> lo{INT32_MAX}, hi{INT32_MIN};
  parallel_for(starts[n_src], 1 << 18, [&](int64_t a, int64_t b) {
    int32_t l = INT32_MAX, h = INT32_MIN;
    // the source that holds position a (past any empty ones that start there)
    int64_t k = std::upper_bound(starts.begin(), starts.end(), a) - starts.begin() - 1;
    for (; a < b; ++k) {
      const int64_t e = std::min(b, starts[k + 1]);
      copy_minmax_i32(srcs[k] + (a - starts[k]), dst + a, e - a, l, h);
      a = e;
    }
#if defined(__AVX2__)
    _mm_sfence();  // the streaming stores are visible before the copy is enqueued
#endif
    int32_t cur = lo.load();
    while (l < cur && !lo.compare_exchange_weak(cur, l)) {}
    cur = hi.load();
    while (h > cur && !hi.compare_exchange_weak(cur, h)) {}
  }, 4);
  minmax[0] = lo.load();
  minmax[1] = hi.load();
}

// out[id] += 1 for every id in [0, num_rows) (the id-frequency pass of
// data/feature_counter.py; ids outside the range are skipped).
void bincount_i64(const int64_t* ids, int64_t* out, int64_t n, int64_t num_rows) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = ids[i];
    if (r >= 0 && r < num_rows) ++out[r];
  }
}

// Row-sorted plan for the embedding update kernels
// (cachedembedding_tpu_torch/ops/binned_scatter.py): the id stream stably
// sorted by id, so every row's contributors end up contiguous and in stream
// order, by an LSD radix sort whose cost follows the n ids, not the table
// (a counting sort over the rows zeroes and sums a num_rows vector: 135 MB a
// step over a 33.8M-row table). Ids below 2^bits take ceil(bits / 20)
// passes of equal digits (at most 2 for int32 ids), each a stable scatter of
// the stream into its digit's buckets; both histograms come from one read
// of the ids. Up to 2^20 rows that is one pass into num_rows buckets, the
// counting sort over the rows, which two scatters of the stream do not beat
// there on the card machine's host; past it, two passes beat a top-bits
// scatter followed by a local sort of each bucket (plan_ab.py, PERF.md).
// bin_starts, the bin-grouping plan's (the JAX package's copy counts by
// id / block_rows and stops there, bin-contiguous only), is one walk of the
// sorted ids.
// Outputs: perm (n), ids_grouped (n), bin_starts (nb+1).
void sort_plan_i32(const int32_t* ids, int64_t n, int64_t num_rows,
                   int64_t block_rows, int32_t* perm, int32_t* ids_grouped,
                   int32_t* bin_starts) {
  const int64_t nb = (num_rows + block_rows - 1) / block_rows;
  int bits = 1;
  while (bits < 31 && (int64_t{1} << bits) < num_rows) ++bits;
  const int passes = (bits + 19) / 20;
  const int digit = (bits + passes - 1) / passes;
  const uint32_t mask = (1u << digit) - 1;
  const size_t buckets = passes > 1 ? size_t{1} << digit : static_cast<size_t>(num_rows);
  std::vector<int32_t> count(passes * buckets, 0);  // n < 2^31
  int32_t* const lo_next = count.data();
  int32_t* const hi_next = lo_next + (passes - 1) * buckets;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t v = static_cast<uint32_t>(ids[i]);
    ++lo_next[v & mask];
    if (passes > 1) ++hi_next[v >> digit];
  }
  for (int p = 0; p < passes; ++p) {  // counts -> first slot of each bucket
    int32_t run = 0;
    for (size_t d = 0; d < buckets; ++d) {
      const int32_t c = count[p * buckets + d];
      count[p * buckets + d] = run;
      run += c;
    }
  }
  std::vector<int32_t> tmp_ids(passes > 1 ? n : 0), tmp_perm(passes > 1 ? n : 0);
  int32_t* dst_ids = passes > 1 ? tmp_ids.data() : ids_grouped;
  int32_t* dst_perm = passes > 1 ? tmp_perm.data() : perm;
  for (int64_t i = 0; i < n; ++i) {  // by the low digit
    const int32_t q = lo_next[static_cast<uint32_t>(ids[i]) & mask]++;
    dst_ids[q] = ids[i];
    dst_perm[q] = static_cast<int32_t>(i);
  }
  if (passes > 1) {  // by the high digit, stable
    for (int64_t i = 0; i < n; ++i) {
      const int32_t q = hi_next[static_cast<uint32_t>(tmp_ids[i]) >> digit]++;
      ids_grouped[q] = tmp_ids[i];
      perm[q] = tmp_perm[i];
    }
  }
  int64_t j = 0;
  for (int64_t b = 0; b <= nb; ++b) {
    const int64_t lo = std::min(b * block_rows, num_rows);
    while (j < n && ids_grouped[j] < lo) ++j;
    bin_starts[b] = static_cast<int32_t>(j);
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
// Columns [col0, col0 + dim) of the row: bit-equal to slicing the full row
// (a column-sharded table keeps only its ranks' columns).
inline void gen_row_canonical(int64_t row_id, uint32_t seed, float bound,
                              float* out, int64_t dim, int64_t col0 = 0) {
  const uint32_t h0 = mix32(static_cast<uint32_t>(row_id) * 0x9e3779b1U + seed);
  const float scale = 2.0f * bound * (1.0f / 16777216.0f);
  for (int64_t j = 0; j < dim; ++j) {
    const uint32_t h = mix32(h0 ^ (static_cast<uint32_t>(col0 + j) * 0x85ebca77U + 1U));
    out[j] = std::fma(static_cast<float>(h >> 8), scale, -bound);
  }
}

}  // namespace

extern "C" {

// Initialize rows [start_row, start_row + n) of a table slab with the
// canonical generator (multithreaded): columns [col0, col0 + dim) of each row.
void fill_rows_canonical(float* buf, int64_t start_row, int64_t n, int64_t dim,
                         uint32_t seed, float bound, int64_t col0) {
  parallel_for(n, 1 << 14, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      gen_row_canonical(start_row + i, seed, bound, buf + i * dim, dim, col0);
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
  int64_t col0;         // first column of the rows it holds and generates
  uint64_t seed;
  uint64_t mask;        // slots - 1 (power of two)
  int64_t used;
  std::vector<int64_t> keys;   // -1 = empty
  std::vector<float> rows;     // slots * dim

  explicit Overlay(int64_t d, int64_t c0, uint64_t s, uint64_t slots) : dim(d), col0(c0), seed(s) {
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
  Overlay bigger(t.dim, t.col0, t.seed, (t.mask + 1) * 2);
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

void* overlay_create(int64_t dim, int64_t col0, uint64_t seed, int64_t capacity_hint) {
  return new Overlay(dim, col0, seed, static_cast<uint64_t>(capacity_hint * 2));
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

// out[i] = overlay[ids[i]] if written, else the canonical row of ids[i]
// with its table's bound: table_bounds[k] for the table k whose rows
// [table_offsets[k], table_offsets[k + 1]) hold it, found by a binary search
// (n_tables tables, table_offsets of n_tables + 1 entries). Rows f32 or
// (out_bf16) bf16 rounded to nearest even; several workers, each probing
// the hash slots of rows kAhead ahead. The overlay must not change meanwhile
// (the caller holds the lock the writeback drain's scatter takes).
void overlay_gather_rows(void* h, const int64_t* ids, int64_t n, const int64_t* table_offsets,
                         const float* table_bounds, int64_t n_tables, void* out, int32_t out_bf16) {
  const Overlay& t = *static_cast<const Overlay*>(h);
  const int64_t dim = t.dim;
  const bool bf16 = out_bf16 != 0;
  const size_t row_bytes = static_cast<size_t>(dim) * sizeof(float);
  parallel_for(n, kRowsPerWorker, [&](int64_t lo, int64_t hi) {
    std::vector<float> made(bf16 ? dim : 0);  // a canonical row before its rounding
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kAhead < hi) {
        const uint64_t home = mix64(static_cast<uint64_t>(ids[i + kAhead]) ^ t.seed) & t.mask;
        __builtin_prefetch(&t.keys[home], 0, 0);
        prefetch_bytes(&t.rows[home * dim], row_bytes);
      }
      const int64_t id = ids[i];
      const uint64_t s = probe(t, id);
      if (t.keys[s] == id) {
        store_row(&t.rows[s * dim], out, i, dim, bf16);
        continue;
      }
      int64_t k = std::upper_bound(table_offsets, table_offsets + n_tables + 1, id) - table_offsets - 1;
      k = std::min(std::max<int64_t>(k, 0), n_tables - 1);
      float* dst = bf16 ? made.data() : static_cast<float*>(out) + i * dim;
      gen_row_canonical(id, static_cast<uint32_t>(t.seed), table_bounds[k], dst, dim, t.col0);
      if (bf16) store_row(dst, out, i, dim, true);
    }
  }, kRowWorkers);
}

// out[i, :] = overlay[ids[i]] if written, else dim copies of fill (the
// row-wise Adagrad accumulators' host store: one probe a row), by several
// workers; the overlay must not change meanwhile.
void overlay_gather_or_fill(void* h, const int64_t* ids, int64_t n, float fill, float* out) {
  const Overlay& t = *static_cast<const Overlay*>(h);
  const int64_t dim = t.dim;
  parallel_for(n, 4 * kRowsPerWorker, [&](int64_t lo, int64_t hi) {  // rows of 4 bytes: more a worker
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kAhead < hi) {
        const uint64_t home = mix64(static_cast<uint64_t>(ids[i + kAhead]) ^ t.seed) & t.mask;
        __builtin_prefetch(&t.keys[home], 0, 0);
        __builtin_prefetch(&t.rows[home * dim], 0, 0);
      }
      const uint64_t s = probe(t, ids[i]);
      if (t.keys[s] == ids[i]) {
        std::memcpy(out + i * dim, &t.rows[s * dim], static_cast<size_t>(dim) * sizeof(float));
      } else {
        std::fill(out + i * dim, out + (i + 1) * dim, fill);
      }
    }
  }, kRowWorkers);
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

// ---------------------------------------------------------------------------
// The window id wire (the JAX package's pack_ids_u8, escape_pack_window_i32
// and rank-tier encoder rt_state_create / rt_encode_window). On valid input
// the bytes are that copy's bytes. Three guards it lacks:
//   * a rank rebuild counts slot ids only after checking them against
//     [0, max_val), and any dictionary feature's id outside it fails the
//     call (the JAX copy indexes its counts unchecked);
//   * tier limits are 64-bit, so a width of 32 never shifts 1u by 32;
//   * the tier caps come with each call, not with the state, so windows of
//     every size share one state and one set of rank arrays (the JAX trainer
//     keeps one state, about 94 MB of rank arrays at Criteo-Kaggle width,
//     per window size).
// ---------------------------------------------------------------------------

namespace {

// two w-bit values little-endian in w/4 bytes (w nibble-aligned, w % 8 != 0)
inline void pack_pair_le(uint8_t* dst, uint64_t a, uint64_t b, int w) {
  const uint64_t combined = a | (b << w);
  const int k = w / 4;
  for (int j = 0; j < k; ++j) dst[j] = (combined >> (8 * j)) & 0xFF;
}

struct RtPacker {  // carry-based nibble-aligned bit packer (pairs for w % 8)
  uint8_t* dst;
  int w;
  uint32_t pending;
  bool has_pending;
  int64_t count;
  void init(uint8_t* d, int width) {
    dst = d;
    w = width;
    pending = 0;
    has_pending = false;
    count = 0;
  }
  inline void push(uint32_t v) {
    ++count;
    if (w == 32) {
      std::memcpy(dst, &v, 4);
      dst += 4;
    } else if (w == 8) {
      *dst++ = static_cast<uint8_t>(v);
    } else if (w % 8 == 0) {  // 16 / 24
      for (int j = 0; j < w / 8; ++j) *dst++ = (v >> (8 * j)) & 0xFF;
    } else if (has_pending) {
      pack_pair_le(dst, pending, v, w);
      dst += w / 4;
      has_pending = false;
    } else {
      pending = v;
      has_pending = true;
    }
  }
  // zero-pad to cap elements (the bytes of packing a zero-padded stream)
  void finish(int64_t cap) {
    if (has_pending) {
      pack_pair_le(dst, pending, 0, w);
      dst += w / 4;
      has_pending = false;
      ++count;
    }
    const int64_t rest = cap - count;
    if (rest > 0) {
      const int64_t nb = (rest * w) / 8;
      std::memset(dst, 0, static_cast<size_t>(nb));
      dst += nb;
    }
  }
};

inline uint32_t low_mask(int w) { return w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1); }

struct RtState {
  int64_t F = 0, max_val = 0;
  std::vector<int32_t> ent_type, deltas, plain_w, dict_ks;  // (F,)
  std::vector<int32_t> widths;                              // (F, 4)
  std::vector<std::vector<int32_t>> rank;   // dict features: rank_of[value], -1 unranked
  std::vector<std::vector<int32_t>> dictv;  // (dict_k,) current dictionary
  std::vector<std::vector<int32_t>> uniq;   // values touched at the last rebuild
};

}  // namespace

extern "C" {

// Bit-pack non-negative int32 ids into a u8 stream at 16, 24 or 20 bits (20:
// pairs in 5 bytes, n even).
void pack_ids_u8(const int32_t* ids, int64_t n, int64_t width_bits, uint8_t* out) {
  if (width_bits == 16) {
    parallel_for(n, 1 << 18, [=](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        const uint32_t v = static_cast<uint32_t>(ids[i]);
        out[2 * i] = v & 0xFF;
        out[2 * i + 1] = (v >> 8) & 0xFF;
      }
    });
  } else if (width_bits == 24) {
    parallel_for(n, 1 << 18, [=](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        const uint32_t v = static_cast<uint32_t>(ids[i]);
        out[3 * i] = v & 0xFF;
        out[3 * i + 1] = (v >> 8) & 0xFF;
        out[3 * i + 2] = (v >> 16) & 0xFF;
      }
    });
  } else {  // 20-bit pairs
    parallel_for(n / 2, 1 << 17, [=](int64_t lo, int64_t hi) {
      for (int64_t p = lo; p < hi; ++p) {
        const uint32_t a = static_cast<uint32_t>(ids[2 * p]);
        const uint32_t b = static_cast<uint32_t>(ids[2 * p + 1]);
        out[5 * p] = a & 0xFF;
        out[5 * p + 1] = (a >> 8) & 0xFF;
        out[5 * p + 2] = ((a >> 16) & 0xF) | ((b & 0xF) << 4);
        out[5 * p + 3] = (b >> 4) & 0xFF;
        out[5 * p + 4] = (b >> 12) & 0xFF;
      }
    });
  }
}

// Escape-coded pack of a uniform window: slot3 is (P, F, Bf) C-order;
// feature f packs at widths[f] bits after subtracting deltas[f]; where
// widths[f] < plain_widths[f], a local id that does not fit is recorded as
// a (flat position, raw id) escape and its base lane masked. Blocks are
// feature-major at out_offsets[f]; escapes are ordered (feature, p, j).
// Returns the escape count, or -1 when it exceeds max_overflow.
int64_t escape_pack_window_i32(
    const int32_t* slot3, int64_t P, int64_t F, int64_t Bf,
    const int32_t* widths, const int32_t* plain_widths, const int32_t* deltas,
    const int64_t* out_offsets, uint8_t* out,
    uint32_t* opos, int32_t* oval, int64_t max_overflow) {
  const int64_t L = F * Bf;
  std::vector<int64_t> counts(F, 0);
  parallel_for(F, 1, [&](int64_t flo, int64_t fhi) {
    for (int64_t f = flo; f < fhi; ++f) {
      if (widths[f] >= plain_widths[f]) continue;
      const uint32_t mask = low_mask(widths[f]);
      const int32_t delta = deltas[f];
      int64_t c = 0;
      for (int64_t p = 0; p < P; ++p) {
        const int32_t* v = slot3 + (p * F + f) * Bf;
        for (int64_t j = 0; j < Bf; ++j) c += (static_cast<uint32_t>(v[j] - delta) > mask);
      }
      counts[f] = c;
    }
  });
  std::vector<int64_t> esc_off(F + 1, 0);
  for (int64_t f = 0; f < F; ++f) esc_off[f + 1] = esc_off[f] + counts[f];
  const int64_t total = esc_off[F];
  if (total > max_overflow) return -1;
  parallel_for(F, 1, [&](int64_t flo, int64_t fhi) {
    for (int64_t f = flo; f < fhi; ++f) {
      const int w = widths[f];
      const bool narrowed = w < plain_widths[f];
      const uint32_t mask = low_mask(w);
      const int32_t delta = deltas[f];
      uint32_t* ep = opos + esc_off[f];
      int32_t* ev = oval + esc_off[f];
      RtPacker pk;
      pk.init(out + out_offsets[f], w);
      for (int64_t p = 0; p < P; ++p) {
        const int32_t* v = slot3 + (p * F + f) * Bf;
        const uint32_t pos0 = static_cast<uint32_t>(p * L + f * Bf);
        for (int64_t j = 0; j < Bf; ++j) {
          uint32_t local = static_cast<uint32_t>(v[j] - delta);
          if (narrowed && local > mask) {
            *ep++ = pos0 + static_cast<uint32_t>(j);
            *ev++ = v[j];  // raw id
            local &= mask;
          }
          pk.push(local);
        }
      }
      if (pk.has_pending) {  // odd total: only legal for byte-aligned widths
        for (int j = 0; j < w / 8; ++j) pk.dst[j] = (pk.pending >> (8 * j)) & 0xFF;
      }
    }
  });
  return total;
}

// Rank-tier state: per feature an entry type (0 plain, 1 tier), its four
// widths (a plain entry uses widths[f*4]), delta, plain width and dictionary
// size. Dictionary features (tier entries with dict_k > 0) get a rank array
// of max_val entries.
void* rt_state_create(int64_t F, int64_t max_val, const int32_t* ent_type,
                      const int32_t* widths, const int32_t* deltas,
                      const int32_t* plain_w, const int32_t* dict_ks) {
  auto* st = new RtState();
  st->F = F;
  st->max_val = max_val;
  st->ent_type.assign(ent_type, ent_type + F);
  st->deltas.assign(deltas, deltas + F);
  st->plain_w.assign(plain_w, plain_w + F);
  st->dict_ks.assign(dict_ks, dict_ks + F);
  st->widths.assign(widths, widths + F * 4);
  st->rank.resize(F);
  st->dictv.resize(F);
  st->uniq.resize(F);
  for (int64_t f = 0; f < F; ++f) {
    if (st->ent_type[f] == 1 && st->dict_ks[f] > 0) {
      st->rank[f].assign(static_cast<size_t>(max_val), -1);
      st->dictv[f].assign(static_cast<size_t>(st->dict_ks[f]), 0);
    }
  }
  return st;
}

void rt_state_free(void* h) { delete static_cast<RtState*>(h); }

// Encode one (P, F, Bf) window against caps (F, 4). Per feature, at
// out_offsets[f]:
//   plain entry: n = P*Bf ids at its width (after -delta); where narrowed,
//     ids that do not fit are masked and recorded as (u32 flat position,
//     i32 raw id) escapes, ordered (f, p, j);
//   tier entry: [n/4 selector bytes, 4 2-bit tiers each, little-endian]
//     [dict_k i32 rank -> value dictionary, when dict_k > 0]
//     [4 substreams: tier k zero-padded to caps[k] ids at widths[k] bits].
// rebuild re-ranks every dictionary feature from this window's counts.
// Returns the escape count (>= 0); -1 on a tier-cap overflow (overflow_info
// = [f, cnt0..3, cap0..3]); -2 when the escapes exceed max_overflow; -3
// when a dictionary feature holds an id outside [0, max_val).
int64_t rt_encode_window(void* h, const int32_t* slot3, int64_t P, int64_t Bf,
                         int32_t rebuild, const int32_t* caps, const int64_t* out_offsets,
                         uint8_t* out, uint32_t* opos, int32_t* oval,
                         int64_t max_overflow, int32_t* overflow_info) {
  RtState& st = *static_cast<RtState*>(h);
  const int64_t F = st.F;
  const int64_t L = F * Bf;
  const int64_t n = P * Bf;
  const uint32_t maxv = static_cast<uint32_t>(st.max_val);
  std::vector<int64_t> esc_cnt(F, 0);
  std::atomic<bool> bad_id{false};
  parallel_for(F, 1, [&](int64_t flo, int64_t fhi) {
    for (int64_t f = flo; f < fhi; ++f) {
      const bool dict = st.ent_type[f] == 1 && st.dict_ks[f] > 0;
      const bool narrowed = st.ent_type[f] == 0 && st.widths[f * 4] < st.plain_w[f];
      if (!dict && !narrowed) continue;
      const uint32_t mask = low_mask(st.widths[f * 4]);
      const int32_t delta = st.deltas[f];
      int64_t c = 0;
      bool bad = false;
      for (int64_t p = 0; p < P; ++p) {
        const int32_t* v = slot3 + (p * F + f) * Bf;
        for (int64_t j = 0; j < Bf; ++j) {
          if (dict) bad |= static_cast<uint32_t>(v[j]) >= maxv;
          else c += (static_cast<uint32_t>(v[j] - delta) > mask);
        }
      }
      esc_cnt[f] = c;
      if (bad) bad_id.store(true);
    }
  });
  if (bad_id.load()) return -3;
  std::vector<int64_t> esc_off(F + 1, 0);
  for (int64_t f = 0; f < F; ++f) esc_off[f + 1] = esc_off[f] + esc_cnt[f];
  if (esc_off[F] > max_overflow) return -2;

  std::atomic<int64_t> failed{-1};
  parallel_for(F, 1, [&](int64_t flo, int64_t fhi) {
    std::vector<int32_t> counts;  // per-worker rebuild scratch
    for (int64_t f = flo; f < fhi; ++f) {
      if (failed.load(std::memory_order_relaxed) >= 0) return;
      uint8_t* dst = out + out_offsets[f];
      const int32_t delta = st.deltas[f];
      if (st.ent_type[f] == 0) {
        const int w = st.widths[f * 4];
        const bool narrowed = w < st.plain_w[f];
        const uint32_t mask = low_mask(w);
        uint32_t* ep = opos + esc_off[f];
        int32_t* ev = oval + esc_off[f];
        RtPacker pk;
        pk.init(dst, w);
        for (int64_t p = 0; p < P; ++p) {
          const int32_t* v = slot3 + (p * F + f) * Bf;
          const uint32_t pos0 = static_cast<uint32_t>(p * L + f * Bf);
          for (int64_t j = 0; j < Bf; ++j) {
            uint32_t local = static_cast<uint32_t>(v[j] - delta);
            if (narrowed && local > mask) {
              *ep++ = pos0 + static_cast<uint32_t>(j);
              *ev++ = v[j];
              local &= mask;
            }
            pk.push(local);
          }
        }
        pk.finish(n);
        continue;
      }
      const int32_t* W = &st.widths[f * 4];
      const int32_t* C = caps + f * 4;
      const int64_t dict_k = st.dict_ks[f];
      int32_t* rank = dict_k > 0 ? st.rank[f].data() : nullptr;
      if (dict_k > 0 && rebuild) {
        if (static_cast<int64_t>(counts.size()) < st.max_val)
          counts.assign(static_cast<size_t>(st.max_val), 0);
        std::vector<int32_t>& uq = st.uniq[f];
        for (int32_t v : uq) rank[v] = -1;
        uq.clear();
        for (int64_t p = 0; p < P; ++p) {
          const int32_t* v = slot3 + (p * F + f) * Bf;
          for (int64_t j = 0; j < Bf; ++j) {
            if (j + 16 < Bf) __builtin_prefetch(&counts[v[j + 16]], 1, 0);
            if (counts[v[j]]++ == 0) uq.push_back(v[j]);  // checked above
          }
        }
        const int64_t U = static_cast<int64_t>(uq.size());
        const int64_t k = std::min<int64_t>(dict_k - 1, U);
        if (U > k) {
          std::nth_element(uq.begin(), uq.begin() + k, uq.end(),
                           [&](int32_t a, int32_t b) { return counts[a] > counts[b]; });
        }
        std::sort(uq.begin(), uq.begin() + k,
                  [&](int32_t a, int32_t b) { return counts[a] > counts[b]; });
        std::vector<int32_t>& dv = st.dictv[f];
        std::fill(dv.begin(), dv.end(), 0);
        for (int64_t r = 0; r < k; ++r) {
          dv[r] = uq[r];
          rank[uq[r]] = static_cast<int32_t>(r);
        }
        for (int32_t v : uq) counts[v] = 0;
      }
      uint8_t* sel_dst = dst;
      uint8_t* sdst = dst + n / 4;
      if (dict_k > 0) {
        std::memcpy(sdst, st.dictv[f].data(), static_cast<size_t>(dict_k) * 4);
        sdst += dict_k * 4;
      }
      RtPacker pk[4];
      for (int t = 0; t < 4; ++t) {
        pk[t].init(sdst, W[t]);
        sdst += (static_cast<int64_t>(C[t]) * W[t]) / 8;
      }
      const uint64_t lim0 = 1ull << W[0], lim1 = 1ull << W[1], lim2 = 1ull << W[2];
      bool over = false;
      int64_t i = 0;
      uint8_t selbyte = 0;
      for (int64_t p = 0; p < P && !over; ++p) {
        const int32_t* v = slot3 + (p * F + f) * Bf;
        for (int64_t j = 0; j < Bf; ++j, ++i) {
          uint32_t t, sym;
          if (dict_k > 0) {
            if (j + 16 < Bf) __builtin_prefetch(&rank[static_cast<uint32_t>(v[j + 16])], 0, 0);
            const int32_t r = rank[static_cast<uint32_t>(v[j])];
            if (r < 0) {
              t = 3;
              sym = static_cast<uint32_t>(v[j] - delta);
            } else {
              const uint64_t ur = static_cast<uint32_t>(r);
              t = ur < lim0 ? 0 : (ur < lim1 ? 1 : 2);
              sym = static_cast<uint32_t>(r);
            }
          } else {
            sym = static_cast<uint32_t>(v[j] - delta);
            const uint64_t s = sym;
            t = s < lim0 ? 0 : (s < lim1 ? 1 : (s < lim2 ? 2 : 3));
          }
          selbyte |= static_cast<uint8_t>(t) << (2 * (i & 3));
          if ((i & 3) == 3) {
            sel_dst[i >> 2] = selbyte;
            selbyte = 0;
          }
          RtPacker& q = pk[t];
          if (q.count >= C[t]) {  // cap overflow: the distribution drifted
            over = true;
            break;
          }
          q.push(sym);
        }
      }
      if (over) {
        int64_t expect = -1;
        if (failed.compare_exchange_strong(expect, f)) {
          overflow_info[0] = static_cast<int32_t>(f);
          for (int t = 0; t < 4; ++t) {
            overflow_info[1 + t] = static_cast<int32_t>(pk[t].count);
            overflow_info[5 + t] = C[t];
          }
        }
        return;
      }
      for (int t = 0; t < 4; ++t) pk[t].finish(C[t]);
    }
  });
  if (failed.load() >= 0) return -1;
  return esc_off[F];
}

}  // extern "C"
