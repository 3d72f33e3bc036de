"""The device planner's admit loop as it was before the staging pass, kept
as the reference of ``tests/test_torch_admit_stage.py`` and the card test in
``tests/test_torch_id_stage.py``: each chunk's rows gathered into a fresh f32
array, cast to the rows' transfer dtype by torch on the CPU and copied by
``to_device``; the accumulators gathered into a fresh array."""

import time

import numpy as np
import torch

from cachedembedding_tpu_torch.cache.state import scatter_admits


def parent_finish_prepare(self, pw) -> None:
    """``CachedEmbeddingBag.finish_prepare`` with the parent's admit loop
    (bind it to a bag with ``types.MethodType``)."""
    if pw.events:
        pw.events[2].synchronize()
    scal = pw.host_scalars.numpy()
    n_miss = int(scal[0])
    self.stats.prepare_calls += 1
    self.stats.num_hits_history.append(int(scal[3]))
    self.stats.num_miss_history.append(n_miss)
    if n_miss == 0:
        self.stats.num_write_back_history.append(0)
        self._ensure_clean(None, block=False)
        return
    idx = pw.host_indices.numpy()
    admit_rows = idx[0, :n_miss].astype(np.int64)
    admit_slots, evict_rows = idx[1, :n_miss], idx[2, :n_miss]
    self._ensure_clean(admit_rows, block=False)
    wb_dtype = torch.bfloat16 if self.transfer_mode == "bfloat16" else None
    chunk = self.buffer_size if self.buffer_size > 0 else n_miss
    n_wb = 0
    for s in range(0, n_miss, chunk):
        e = min(s + chunk, n_miss)
        mask = evict_rows[s:e] >= 0
        if mask.any():
            self._enqueue_gather(evict_rows[s:e][mask], admit_slots[s:e][mask], wb_dtype)
            n_wb += int(mask.sum())
        t0 = time.perf_counter()
        with self._host_lock:
            vals = self.host_table.gather(admit_rows[s:e])
        slots = pw.plan.indices[1, s:e].long()
        scatter_admits(self.cache_weight, slots, self.to_device(torch.from_numpy(vals).to(self._row_dtype)))
        if self.cache_accum is not None:
            with self._host_lock:
                acc = self.host_accum.gather(admit_rows[s:e])
            self.cache_accum.index_copy_(0, slots, self.to_device(acc))
        self.stats.swap_in_bytes += (e - s) * self.embedding_dim * 4
        self.stats.swap_in_time += time.perf_counter() - t0
    self.stats.num_write_back_history.append(n_wb)
    self._submit_writebacks()
