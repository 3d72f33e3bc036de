"""Kernel 5 (``ops/ordered_scatter.py::ordered_scatter_add_``,
``csrc/ordered_scatter_add.cu``): a call a step, its classify, sort, heavy
and light launches timed together; bytes from ``roofline.update_bytes`` at
the run's mean count of distinct ids a step; in % of the card's memory
rate."""

from perfbench import roofline, trace


def read(run):
    if run.trace is None or not run.unique_per_step:
        return None
    steps, s = trace.steps_and_time(run.trace, "ordered_scatter")
    if not steps:
        return None
    cfg = run.cfg
    L = run.batch_size * cfg.num_sparse_features
    grad_bytes = 4 if run.row_bytes == 1 else run.row_bytes  # 1-byte rows take f32 grads
    b = roofline.update_bytes(L, run.unique_per_step, cfg.embedding_dim, run.row_bytes, grad_bytes)
    return roofline.memory_share(b, steps, s)
