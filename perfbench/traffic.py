"""The benchmark's traffic generator: one general long-tail stream, driven by
the parameters of a mix file (``perfbench/traffic/<mix>.json``).

A mix file gives:

* ``batch_size``: examples a batch;
* ``ids``: ``{"law": "inverse_cdf_power", "skew": s}``: per table of E rows,
  ``u ~ U[(1/E)^s, 1]`` and ``id = floor(u^(-1/s)) - 1``, clipped to
  ``[0, E)``, so that ``P(id >= k) ~ (k + 1)^(-s)``: a heavy head and a long
  tail (the law of the port's ``data/synthetic.py``, frozen here);
* ``labels``: ``"random"`` (each label 0 or 1 with even odds);
* ``dense``: ``"uniform01"`` (each dense feature ``U[0, 1)``);
* ``freq_map_batches``: the stream length whose expected id counts make the
  frequency map that the cache's eviction and warm-up read;
* ``chunk_batches``: batches made a generator call.

Batch ``i`` of seed ``s`` depends on ``(s, i)``, the mix and the table sizes
alone: chunk ``c`` draws from a ``torch.Generator`` on the device seeded with
a 64-bit mix of ``(s, c)``, so a run that makes more batches makes the same
first ones. Batches are made on the device in few large calls and copied to
the host, where the trainer plans them; ids are global (table offsets added)
and feature-major, as the port's ``Batch`` holds them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures

_M64 = (1 << 64) - 1


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for chunk ``chunk`` of stream ``seed``
    (splitmix64's finalizer over ``seed * golden + chunk``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(chunk) + 1) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


class Stream:
    """The batches of one mix, one seed and one configuration's tables."""

    def __init__(self, mix: dict, table_sizes: Sequence[int], dense_in: int, seed: int,
                 device: torch.device):
        if mix["ids"]["law"] != "inverse_cdf_power" or mix["labels"] != "random" or mix["dense"] != "uniform01":
            raise ValueError(f"mix {mix.get('name')!r}: unknown id law, label rule or dense law")
        self.mix = mix
        self.skew = float(mix["ids"]["skew"])
        self.batch_size = int(mix["batch_size"])
        self.chunk = int(mix["chunk_batches"])
        self.table_sizes = [int(n) for n in table_sizes]
        self.dense_in = int(dense_in)
        self.seed = int(seed)
        self.device = device
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(np.int64)
        E = torch.tensor(self.table_sizes, dtype=torch.float64, device=device)
        self._min_u = (1.0 / E) ** self.skew  # (F,)
        self._hi = (E - 1).to(torch.int64)
        self._off = torch.as_tensor(self.offsets[:-1], device=device)

    def _chunk(self, c: int):
        """Chunk ``c`` on the device: ids (C, F, B) int32, dense (C, B,
        Din) f32, labels (C, B) int32."""
        g = torch.Generator(device=self.device)
        g.manual_seed(chunk_seed(self.seed, c))
        C, F, B = self.chunk, len(self.table_sizes), self.batch_size
        u = torch.rand((C, F, B), dtype=torch.float64, generator=g, device=self.device)
        u = u * (1.0 - self._min_u)[None, :, None] + self._min_u[None, :, None]
        ids = torch.floor(u ** (-1.0 / self.skew)).to(torch.int64) - 1
        del u
        ids = torch.minimum(ids.clamp_(min=0), self._hi[None, :, None]) + self._off[None, :, None]
        dense = torch.rand((C, B, self.dense_in), dtype=torch.float32, generator=g, device=self.device)
        labels = torch.randint(0, 2, (C, B), generator=g, device=self.device, dtype=torch.int32)
        return ids.to(torch.int32), dense, labels

    def batches(self, start: int, n: int, unique: bool = False):
        """Batches ``start .. start + n - 1`` as the port's host ``Batch``es;
        with ``unique``, also each batch's count of distinct ids."""
        out: List[Batch] = []
        uniq: List[int] = []
        F, B = len(self.table_sizes), self.batch_size
        c0, c1 = start // self.chunk, (start + n - 1) // self.chunk
        for c in range(c0, c1 + 1):
            ids, dense, labels = self._chunk(c)
            lo = max(start, c * self.chunk) - c * self.chunk
            hi = min(start + n, (c + 1) * self.chunk) - c * self.chunk
            if unique:
                uniq += [int(torch.unique(ids[i]).numel()) for i in range(lo, hi)]
            ids, dense, labels = ids[lo:hi].cpu(), dense[lo:hi].cpu(), labels[lo:hi].cpu()
            for i in range(hi - lo):
                out.append(Batch(
                    dense_features=dense[i],
                    sparse_features=RaggedFeatures(values=ids[i].reshape(-1), offsets=None, num_features=F,
                                                   batch_size=B, pooling=1),
                    labels=labels[i],
                ))
        return (out, uniq) if unique else out

    def freq_map(self) -> np.ndarray:
        """Expected count of each global id over ``freq_map_batches``
        batches (int64, one entry a row): the stream's law integrated over
        each id's interval of ``u``, truncated to whole counts (the frozen
        ``SyntheticLongTailDataset.id_freq_map``)."""
        draws = self.batch_size * int(self.mix["freq_map_batches"])
        s = self.skew
        parts = []
        for E in self.table_sizes:
            k = torch.arange(1, E + 1, dtype=torch.float64, device=self.device)
            p = k ** (-s) - (k + 1) ** (-s)
            p[-1] += (E + 1.0) ** (-s) - (1.0 / E) ** s
            p = p.clamp_(min=0)
            p /= p.sum()
            parts.append((p * draws).to(torch.int64))
        return torch.cat(parts).cpu().numpy()
