"""Device-synchronized timing (counterpart of
``cachedembedding_tpu/utils/timer.py``, the reference's CUDA-synced Timer and
``get_time_elapsed``). On a CUDA device ``start`` and ``stop`` first wait
for its queued work (``torch.cuda.synchronize``); on the CPU there is
nothing to wait for."""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch

from cachedembedding_tpu_torch import resolve_device


class Timer:
    """Host seconds between ``start`` and ``stop``, with the device's queued
    work finished at both (``sync``); kept in ``history``. ``device``: the
    current CUDA device by default (this raises without one), or
    ``device="cpu"``."""

    def __init__(self, sync: bool = True, device=None):
        self._sync = sync
        self.device = resolve_device(device)
        self._history: List[float] = []
        self._start: Optional[float] = None

    def _wait(self) -> None:
        if self._sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._wait()
        self._start = time.perf_counter()

    def stop(self, keep_in_history: bool = True) -> float:
        if self._start is None:
            raise RuntimeError("Timer.stop without start")
        self._wait()
        el = time.perf_counter() - self._start
        if keep_in_history:
            self._history.append(el)
        self._start = None
        return el

    @property
    def history(self) -> List[float]:
        return self._history

    def mean(self, skip: int = 0) -> float:
        h = self._history[skip:]
        return sum(h) / len(h) if h else 0.0

    def reset(self) -> None:
        self._history.clear()
        self._start = None


@contextlib.contextmanager
def get_time_elapsed(logger, message: str, device=None):
    """Log ``message`` with the seconds the block took (synchronized)."""
    t = Timer(device=device)
    t.start()
    yield
    logger.info(f"{message}, time elapsed: {t.stop():.4f}s")
