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


_UPDATES = ("binned_sgd_update", "binned_adagrad_update", "ordered_scatter_add_", "ordered_grad_update_")


@contextlib.contextmanager
def _replaced(entries: dict):
    """The trainer's ``entries`` (name -> function) replaced while inside."""
    orig = {n: getattr(trainer_mod, n) for n in entries}
    for n, f in entries.items():
        setattr(trainer_mod, n, f)
    try:
        yield
    finally:
        for n, f in orig.items():
            setattr(trainer_mod, n, f)


def rows_unchanged():
    """The embedding update writes nothing: Kernel 2's (SGD and Adagrad)
    and Kernel 5's (scatter and dense ragged) entries return at once (the
    dense parameters still train)."""
    return _replaced({n: (lambda *a, **k: None) for n in _UPDATES})


def accum_frozen():
    """Row-wise Adagrad's accumulators never change: Kernel 2's and Kernel
    5's Adagrad entries update the rows from a copy of them, which is
    dropped."""

    def frozen(name):
        f = getattr(trainer_mod, name)

        def update(cw, acc, *a, **k):
            return f(cw, None if acc is None else acc.clone(), *a, **k)

        return update

    return _replaced({n: frozen(n) for n in ("binned_adagrad_update", "ordered_grad_update_")})


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
          "writeback_lost": writeback_lost, "accum_frozen": accum_frozen}


def faults_of(config: dict) -> list:
    """The faults that a configuration can have: a writeback only where a
    cache evicts, frozen accumulators only under row-wise Adagrad."""
    cached = config["embedding"] == "cached"
    adagrad = config["dlrm"].get("embedding_optimizer") == "rowwise_adagrad"
    return [f for f in FAULTS if (f != "writeback_lost" or cached) and (f != "accum_frozen" or adagrad)]


def control_config(config: dict) -> dict:
    """The control: the configuration with its rows stored one precision
    below what it states, in the program's own fp8 path (float8_e4m3fn
    rows, stochastic rounding of each update)."""
    c = copy.deepcopy(config)
    c["cache"]["cache_dtype"] = "float8_e4m3fn"
    return c
