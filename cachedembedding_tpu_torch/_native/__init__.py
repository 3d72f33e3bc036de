"""Native host library of the port (built at first use; see hostops.py)."""
