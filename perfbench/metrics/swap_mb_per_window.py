"""Cache staging (``cache/manager.py``): bytes fetched from and written back
to the host table (``CacheStats.swap_in_bytes + swap_out_bytes``, counted
at 4 bytes an element), in MB a window of the run."""


def read(run):
    st = run.stats
    if not run.cached or not st.num_hits_history:
        return None
    return (st.swap_in_bytes + st.swap_out_bytes) / 1e6 / run.windows
