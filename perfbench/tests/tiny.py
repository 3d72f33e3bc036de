"""A configuration cut to a size a CPU test holds: four small tables, a
batch of 256, windows of two. Widths and the model's layout stay the
configuration's. ``CASES``: the benchmark's cell, and the fully resident
configuration that the harness and the reference also carry (a later cell's,
with the sparse update branch), judged by the cell's limits."""

import copy

from perfbench import check, spec

TABLES = [100, 2000, 30000, 7]
CELL = "kaggle-cached-s050"
CASES = {"cached": "dlrm-criteo-kaggle-cached", "resident": "dlrm-avazu-resident"}


def tiny(case: str):
    """(config, mix, limits) of ``case`` at the tiny size. The cached case
    keeps the dense update branch (device rows under four times a step's
    ids) and a cache small enough that the check's stretch evicts rows and
    writes them back, as at its own size."""
    c = copy.deepcopy(spec.config(CASES[case]))
    m = copy.deepcopy(spec.mix(spec.workload(spec.load_benchmark(), CELL)["traffic"]))
    c["dlrm"]["num_embeddings_per_feature"] = list(TABLES)
    c["dlrm"]["dense_in_features"] = 5
    c["cache"]["prefetch_num"] = 2
    if c["embedding"] == "cached":
        c["cache"]["cache_ratio"] = 0.02
    m["batch_size"] = 256
    m["freq_map_batches"] = 50
    m["chunk_batches"] = 4
    lim = spec.limits(CELL)
    return c, m, {k: lim[k] for k in check.numbers_of(c)}
