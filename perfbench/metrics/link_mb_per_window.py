"""Host link (``cache/manager.py``): bytes copied to the card and back as the
program issues the copies (``CacheStats.h2d_bytes + d2h_bytes``: the window's
ids, dense features and labels, admits, the plan's readback, writebacks),
in MB a window of the timed window."""


def read(run):
    st = run.stats
    if not run.cached or not hasattr(st, "h2d_bytes") or not st.num_hits_history:
        return None
    return (st.h2d_bytes + st.d2h_bytes) / 1e6 / run.windows
