"""Column-wise model-parallel cached embedding (counterpart of
``cachedembedding_tpu/parallel/column.py``): ``ParallelCachedEmbeddingBag``.

One logical bag whose embedding dim is split evenly across the mesh's ranks:
rank r stores columns ``[r * D/w, (r + 1) * D/w)`` of every row, on its device
(``cache_weight``, (C, D/w)) and in its host table. Every rank consumes the
global batch's ids and produces (B_global, F, D/w); the reshard to
(B_local, F, D) is in the train step (``train/mesh_window.py``).

The cache's directory is replicated: each rank plans the same windows from
the same ids, with no cross-rank coordination. Each rank then fetches or
synthesizes its own columns of the admitted rows, and writes its own columns
of the evicted ones back, so no row crosses ranks. The JAX package keeps the
full-width f32 master on every process instead; the values are the same
either way, and here one host does not hold w copies of a table. int8/int4
admit payloads are quantized with each row's largest |x| over all its
columns (one ``all_reduce(MAX)`` a window), so the dequantized columns equal
the JAX package's full-row quantization sliced.
"""

from __future__ import annotations

import numpy as np

from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.parallel.mesh import Mesh
from cachedembedding_tpu_torch.parallel.multiproc import global_max


class ParallelCachedEmbeddingBag(CachedEmbeddingBag):
    """``CachedEmbeddingBag`` over ``mesh``: ``embedding_dim`` is the full
    row's width, ``dim_per_rank`` this rank's columns."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *, mesh: Mesh, **kw):
        w = mesh.size
        if embedding_dim % w != 0:
            raise ValueError(f"embedding_dim {embedding_dim} must divide evenly over {w} devices")
        self.mesh = mesh
        dpr = embedding_dim // w
        kw.setdefault("device", mesh.device)
        super().__init__(num_embeddings, embedding_dim, columns=(mesh.rank * dpr, (mesh.rank + 1) * dpr), **kw)

    @property
    def dim_per_rank(self) -> int:
        return self.embedding_dim // self.mesh.size

    def _row_absmax(self, vals: np.ndarray) -> np.ndarray:
        """The fetched rows' largest |x| over every rank's columns."""
        local = np.abs(np.asarray(vals, np.float32)).max(axis=1, initial=0.0)
        # every rank fetches the same rows, so all of them skip an empty call
        return global_max(local, self.mesh) if local.size else local
