"""Cache (``cache/manager.py``, ``cache/host_directory.py``): hits over hits
plus misses of each window's distinct ids, over the run's windows
(``CacheStats``, reset before the window)."""


def read(run):
    st = run.stats
    if not run.cached or not st.num_hits_history:
        return None
    return st.hit_rate()
