"""Background-thread batch prefetcher (counterpart of
``cachedembedding_tpu/data/prefetch.py``, the reference's stream-dataloader
analog). ``PrefetchIterator`` runs the upstream iterator on a worker thread
with a bounded queue, so batch k + depth is built on the host while the
trainer consumes batch k; an upstream failure is raised in the consumer. The
trainer's window pipeline does the host-to-device copies."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from cachedembedding_tpu_torch.jagged import Batch


class PrefetchIterator:
    _SENTINEL = object()

    def __init__(self, source: Iterable[Batch], depth: int = 2):
        self.source = source
        self.depth = max(1, depth)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []

        def worker():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as e:  # re-raised in the consumer below
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


class FiniteDataIter:
    """The reference's FiniteDataIter: a bounded prefetching iterator over a
    finite dataset."""

    def __init__(self, source: Iterable[Batch], depth: int = 2):
        self._it = iter(PrefetchIterator(source, depth=depth))

    def __iter__(self):
        return self._it

    def __next__(self) -> Batch:
        return next(self._it)
