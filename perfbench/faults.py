"""Faults planted under the timed path, and the control, to show that the
comparison rejects them. Used by the tests and by ``calibrate.py``; the
benchmark's own runs plant nothing."""

from __future__ import annotations

import contextlib
import copy

import cachedembedding_tpu_torch.train.trainer as trainer_mod
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag


@contextlib.contextmanager
def state_unchanged():
    """Every step leaves the state as it found it: both learning rates 0."""
    orig = trainer_mod.CachedDLRMTrainer._lrs
    trainer_mod.CachedDLRMTrainer._lrs = lambda self, progress: (0.0, 0.0)
    try:
        yield
    finally:
        trainer_mod.CachedDLRMTrainer._lrs = orig


@contextlib.contextmanager
def half_batch():
    """Each step's loss is the mean over the first half of its batch; the
    other half is left out."""
    orig = trainer_mod._model_loss

    def loss(model, out, labels):
        h = out.shape[0] // 2
        return orig(model, out[:h], labels[:h])

    trainer_mod._model_loss = loss
    try:
        yield
    finally:
        trainer_mod._model_loss = orig


@contextlib.contextmanager
def rows_unchanged():
    """The embedding update writes nothing: Kernel 2's and Kernel 5's
    entries return at once (the dense parameters still train)."""
    orig = trainer_mod.binned_sgd_update, trainer_mod.ordered_scatter_add_
    trainer_mod.binned_sgd_update = lambda *a, **k: None
    trainer_mod.ordered_scatter_add_ = lambda *a, **k: None
    try:
        yield
    finally:
        trainer_mod.binned_sgd_update, trainer_mod.ordered_scatter_add_ = orig


@contextlib.contextmanager
def writeback_lost():
    """Evicted rows never land in the host table: the writebacks' drain
    waits for their copies and writes nothing."""
    orig = CachedEmbeddingBag._do_drain

    def drain(self, items):
        for _rows, _host, _acc, event in items:
            if event is not None:
                event.synchronize()

    CachedEmbeddingBag._do_drain = drain
    try:
        yield
    finally:
        CachedEmbeddingBag._do_drain = orig


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "rows_unchanged": rows_unchanged,
          "writeback_lost": writeback_lost}


def faults_of(config: dict) -> list:
    """The faults that a configuration can have: a writeback only where a
    cache evicts."""
    return [f for f in FAULTS if f != "writeback_lost" or config["embedding"] == "cached"]


def control_config(config: dict) -> dict:
    """The control: the configuration with its rows stored one precision
    below what it states, in the program's own fp8 path (float8_e4m3fn
    rows, stochastic rounding of each update)."""
    c = copy.deepcopy(config)
    c["cache"]["cache_dtype"] = "float8_e4m3fn"
    return c
