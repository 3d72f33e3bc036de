// Host-authoritative cache directory (the port's own copy of
// cachedembedding_tpu/_native/directory.cpp; the two must plan identically,
// which tests/test_torch_native.py checks).
//
// The directory work — unique over the id stream, hit/miss split,
// LFU/dataset-frequency victim selection, id->slot remap — is pointer-chasing
// over hundreds of MB of maps, which a many-core host with big DRAM does well.
// Keeping it on the host means the plan for window k+1 is computed on the host
// while the GPU executes window k, and nothing is ever read back from the
// device to make cache decisions.
//
// Memory: num_rows * 12 bytes (row_to_slot int32 + packed epoch|count uint64)
// + capacity * ~17 bytes.
//
// Built at first use by cachedembedding_tpu_torch/_native/hostops.py
// (g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread) together with
// hostops.cpp into one libhostops.so.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename Fn>
void parallel_for_dir(int64_t n, int64_t min_per_thread, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t want = n / min_per_thread;
  unsigned workers = static_cast<unsigned>(want < 1 ? 1 : (want < hw ? want : hw));
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

struct Directory {
  int64_t num_rows;
  int64_t capacity;
  int strategy;  // 0 = LFU (runtime counters), 1 = DATASET (static frequency)

  std::vector<int32_t> row_to_slot;  // (N) -1 = not resident
  // (N) packed per-row window mark: (epoch << 24) | occurrence count (sat).
  // One array (not two) so pass 1 costs a single cache miss per new row.
  std::vector<uint64_t> row_mark;
  std::vector<int64_t> slot_to_row;  // (C) -1 = empty
  std::vector<int64_t> slot_freq;    // (C) eviction priority (lower = colder)
  std::vector<uint32_t> slot_stamp;  // (C) == epoch → protected this window
  std::vector<int32_t> free_slots;   // stack of never-used slots
  std::vector<int64_t> dataset_freq; // (N) only when strategy == DATASET

  uint64_t epoch = 0;

  // scratch reused across plans (avoids per-call allocation)
  std::vector<int64_t> uniq;
  std::vector<int64_t> miss;
  std::vector<std::pair<int32_t, int64_t>> hits;  // (slot, occurrence count)
  std::vector<std::pair<int64_t, int32_t>> cand;  // (freq, slot) eviction candidates

  Directory(int64_t n, int64_t c, int strat)
      : num_rows(n), capacity(c), strategy(strat) {
    row_to_slot.assign(n, -1);
    row_mark.assign(n, 0);
    slot_to_row.assign(c, -1);
    slot_freq.assign(c, 0);
    slot_stamp.assign(c, ~0u);
    free_slots.reserve(c);
    for (int64_t s = c - 1; s >= 0; --s) free_slots.push_back(static_cast<int32_t>(s));
  }
};

constexpr uint64_t kEpochShift = 24;
constexpr uint64_t kCountMask = (1ULL << kEpochShift) - 1;

}  // namespace

extern "C" {

void* dir_create(int64_t num_rows, int64_t capacity, int strategy) {
  return new Directory(num_rows, capacity, strategy);
}

void dir_free(void* h) { delete static_cast<Directory*>(h); }

void dir_set_dataset_freq(void* h, const int64_t* freq) {
  Directory& d = *static_cast<Directory*>(h);
  d.dataset_freq.assign(freq, freq + d.num_rows);
}

// Preload rows[0..k) into slots 0..k (the reference's warmup/reorder step).
// freqs seeds the eviction priority so warm rows are not immediately evicted.
void dir_warmup(void* h, const int64_t* rows, const int64_t* freqs, int64_t k) {
  Directory& d = *static_cast<Directory*>(h);
  d.free_slots.clear();
  for (int64_t s = d.capacity - 1; s >= k; --s)
    d.free_slots.push_back(static_cast<int32_t>(s));
  for (int64_t i = 0; i < k; ++i) {
    d.slot_to_row[i] = rows[i];
    d.row_to_slot[rows[i]] = static_cast<int32_t>(i);
    d.slot_freq[i] = freqs[i];
  }
}

// One cache-maintenance window: make every id in ids[0..L) resident.
//
// Outputs (caller allocates; admit_*/evict_rows sized >= capacity):
//   slot_ids  (L)  — ids remapped to cache-slot space (the prepare_ids result)
//   admit_rows(n)  — global rows to copy host->HBM
//   admit_slots(n) — destination slots
//   evict_rows(n)  — previous occupant of each slot (-1 if it was empty);
//                    caller writes those back HBM->host BEFORE re-using them
//   stats[6]       — n_miss, n_unique, n_hit_unique, n_hit_weighted, n_evict,
//                    error (1 = working set exceeds capacity; state unmodified)
// Returns n_miss (or -1 on error).
int64_t dir_plan(void* h, const int32_t* ids, int64_t L, int32_t* slot_ids,
                 int64_t* admit_rows, int32_t* admit_slots, int64_t* evict_rows,
                 int64_t* stats) {
  Directory& d = *static_cast<Directory*>(h);
  d.epoch++;
  const uint64_t em = d.epoch << kEpochShift;

  // -- pass 1: unique + per-window occurrence counts ------------------------
  // Sequential (stamp updates are order-dependent) but software-prefetched:
  // the row_mark line for ids[i + kAhead] is in flight while we process ids[i].
  d.uniq.clear();
  constexpr int64_t kAhead = 24;
  uint64_t* mark = d.row_mark.data();
  for (int64_t i = 0; i < L; ++i) {
    if (i + kAhead < L) __builtin_prefetch(&mark[ids[i + kAhead]], 1, 1);
    const int64_t r = ids[i];
    if (static_cast<uint64_t>(r) >= static_cast<uint64_t>(d.num_rows)) {
      // out-of-range id (negative or >= N): report instead of corrupting
      stats[0] = 0; stats[1] = i; stats[2] = r; stats[3] = 0; stats[4] = 0;
      stats[5] = 2;
      return -1;
    }
    const uint64_t m = mark[r];
    if ((m & ~kCountMask) != em) {
      mark[r] = em | 1;
      d.uniq.push_back(r);
    } else if ((m & kCountMask) != kCountMask) {
      mark[r] = m + 1;
    }
  }
  const int64_t n_unique = static_cast<int64_t>(d.uniq.size());

  // -- pass 2: hit/miss split (no state mutation beyond protection stamps) ---
  d.miss.clear();
  d.hits.clear();
  int64_t n_hit_unique = 0, n_hit_weighted = 0;
  {
    const int64_t n = n_unique;
    const int64_t* u = d.uniq.data();
    for (int64_t i = 0; i < n; ++i) {
      if (i + kAhead < n) __builtin_prefetch(&d.row_to_slot[u[i + kAhead]], 0, 1);
      const int32_t s = d.row_to_slot[u[i]];
      if (s >= 0) {
        d.slot_stamp[s] = static_cast<uint32_t>(d.epoch);  // protected
        const int64_t cnt = static_cast<int64_t>(mark[u[i]] & kCountMask);
        ++n_hit_unique;
        n_hit_weighted += cnt;
        d.hits.emplace_back(s, cnt);
      } else {
        d.miss.push_back(u[i]);
      }
    }
  }
  const int64_t n_miss = static_cast<int64_t>(d.miss.size());

  // -- pass 3: victim selection (capacity check BEFORE mutating) -------------
  const int64_t from_free =
      n_miss < static_cast<int64_t>(d.free_slots.size())
          ? n_miss
          : static_cast<int64_t>(d.free_slots.size());
  const int64_t need = n_miss - from_free;
  if (need > 0) {
    d.cand.clear();
    for (int64_t s = 0; s < d.capacity; ++s) {
      if (d.slot_stamp[s] != static_cast<uint32_t>(d.epoch) && d.slot_to_row[s] >= 0)
        d.cand.emplace_back(d.slot_freq[s], static_cast<int32_t>(s));
    }
    if (static_cast<int64_t>(d.cand.size()) < need) {
      stats[0] = n_miss; stats[1] = n_unique; stats[2] = n_hit_unique;
      stats[3] = n_hit_weighted; stats[4] = 0; stats[5] = 1;
      return -1;
    }
    // coldest `need` candidates; O(C) selection, no full sort
    std::nth_element(d.cand.begin(), d.cand.begin() + need - 1, d.cand.end());
  }

  // -- pass 4: assign slots, emit plan, apply state updates ------------------
  int64_t n_evict = 0;
  for (int64_t k = 0; k < n_miss; ++k) {
    const int64_t r = d.miss[k];
    int32_t s;
    if (k < from_free) {
      s = d.free_slots.back();
      d.free_slots.pop_back();
      evict_rows[k] = -1;
    } else {
      s = d.cand[k - from_free].second;
      const int64_t old = d.slot_to_row[s];
      d.row_to_slot[old] = -1;
      evict_rows[k] = old;
      ++n_evict;
    }
    d.slot_to_row[s] = r;
    d.row_to_slot[r] = s;
    d.slot_stamp[s] = static_cast<uint32_t>(d.epoch);
    const int64_t cnt = static_cast<int64_t>(mark[r] & kCountMask);
    d.slot_freq[s] = d.strategy == 0
                         ? cnt
                         : (d.dataset_freq.empty() ? 0 : d.dataset_freq[r]);
    admit_rows[k] = r;
    admit_slots[k] = s;
  }
  // LFU: hits earn their occurrence count (matches the device planner's
  // freq.at[hit_slots].add(counts); admitted rows were seeded above).
  if (d.strategy == 0) {
    for (const auto& [s, cnt] : d.hits) d.slot_freq[s] += cnt;
  }

  // -- pass 5: remap ids -> slots (multithreaded, prefetched) ---------------
  const int32_t* r2s = d.row_to_slot.data();
  parallel_for_dir(L, 1 << 16, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kAhead < hi) __builtin_prefetch(&r2s[ids[i + kAhead]], 0, 1);
      slot_ids[i] = r2s[ids[i]];
    }
  });

  stats[0] = n_miss; stats[1] = n_unique; stats[2] = n_hit_unique;
  stats[3] = n_hit_weighted; stats[4] = n_evict; stats[5] = 0;
  return n_miss;
}

// Resident rows snapshot (for flush/checkpoint): fills slots/rows, returns count.
int64_t dir_resident(void* h, int32_t* slots, int64_t* rows) {
  Directory& d = *static_cast<Directory*>(h);
  int64_t j = 0;
  for (int64_t s = 0; s < d.capacity; ++s) {
    if (d.slot_to_row[s] >= 0) {
      slots[j] = static_cast<int32_t>(s);
      rows[j] = d.slot_to_row[s];
      ++j;
    }
  }
  return j;
}

int64_t dir_num_free(void* h) {
  return static_cast<int64_t>(static_cast<Directory*>(h)->free_slots.size());
}

}  // extern "C"
