"""The port's fixed-size unique (``ops/unique.py``) against the JAX
package's on seeded streams, bit for bit (values and int32 dtypes):
duplicate-heavy streams, all-distinct streams, a single id, and overflow
(``size`` below the distinct count, where both report the true count and
keep the first ``size`` uniques)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.ops import unique as jax_unique
from cachedembedding_tpu_torch.ops import unique as port_unique

# (L, size, N, stream): "heavy" draws L ids from a Zipf law over few rows
CASES = {
    "heavy": (4000, 300, 5000, "heavy"),
    "heavy_overflow": (4000, 7, 5000, "heavy"),
    "uniform": (1000, 1000, 1200, "uniform"),
    "uniform_overflow": (1000, 100, 1200, "uniform"),
    "all_distinct": (512, 512, 512, "perm"),
    "all_distinct_overflow": (512, 1, 512, "perm"),
    "one_id": (1, 4, 9, "uniform"),
    "one_row_repeated": (300, 16, 40, "same"),
}


def stream(L, N, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "heavy":
        return (rng.zipf(1.3, L) % N).astype(np.int32)
    if kind == "perm":
        return rng.permutation(N)[:L].astype(np.int32)
    if kind == "same":
        return np.full((L,), 17, np.int32)
    return rng.integers(0, N, L).astype(np.int32)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("fn", ["unique_fixed", "unique_mask"])
def test_unique_matches_jax(fn, name):
    L, size, N, kind = CASES[name]
    ids = stream(L, N, kind)
    args = (size,) if fn == "unique_fixed" else (size, N)
    want = [np.asarray(x) for x in getattr(jax_unique, fn)(jnp.asarray(ids), *args)]
    got = [x.numpy() for x in getattr(port_unique, fn)(torch.from_numpy(ids), *args)]
    for g, w, what in zip(got, want, ("uids", "counts", "n_unique")):
        assert g.dtype == w.dtype == np.int32, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    n = len(np.unique(ids))
    assert int(got[2]) == n and int(got[1].sum()) == (L if size >= n else got[1].sum())
    if size < n:  # overflow: the first `size` uniques, no padding
        np.testing.assert_array_equal(got[0], np.unique(ids)[:size])
