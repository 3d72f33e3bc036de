"""Multi-device layouts (counterpart of ``cachedembedding_tpu/parallel/``):
the sharding planner, the process-group mesh, the collectives every layout
shares, the id exchanges, the column-wise, table-wise and row-sharded cached
embeddings, the row-wise lookup and the per-batch hybrid step. Ranks are
processes joined by ``torch.distributed`` (NCCL on the card, gloo on the
CPU), on one host or several (a process a host spawns a rank a card; the
ranks meet over TCP).

``make_mesh``, ``hybrid_train_step`` and ``dryrun_hybrid_train_step`` are
exported as the JAX package exports them, on first use: ``parallel/hybrid.py``
imports ``train/mesh_window.py``, which imports ``parallel/mesh.py``."""

_EXPORTS = {"make_mesh": "mesh", "hybrid_train_step": "hybrid", "dryrun_hybrid_train_step": "hybrid"}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
