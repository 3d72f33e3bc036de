"""Dense towers and interaction (``models/dlrm.py``): device time of the
matrix-product kernels (cuBLAS, CUTLASS) a traced step, in ms."""

from perfbench import trace


def read(run):
    if run.trace is None:
        return None
    steps, s = trace.steps_and_time(run.trace, "gemm")
    return s / steps * 1e3 if steps else None
