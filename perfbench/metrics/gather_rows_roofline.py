"""Kernel 1 (``ops/gather_rows.py``, ``csrc/gather_rows.cu``): the traced
steps' bytes (``roofline.gather_rows_bytes``, one launch a step, at the
run's mean count of distinct ids a step) over the kernel's device time, in
% of the card's memory rate."""

from perfbench import roofline, trace


def read(run):
    if run.trace is None or not run.unique_per_step:
        return None
    steps, s = trace.steps_and_time(run.trace, "gather_rows")
    if not steps:
        return None
    cfg = run.cfg
    L = run.batch_size * cfg.num_sparse_features
    return roofline.memory_share(roofline.gather_rows_bytes(L, run.unique_per_step, cfg.embedding_dim,
                                                            run.row_bytes), steps, s)
