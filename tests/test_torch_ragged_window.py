"""Ragged windows (the fbgemm-trace workload) in the port's trainer against
the JAX package's ``CachedDLRMTrainer``, on ``tests/test_ragged_window.py``'s
traces: 3 tables of 500 rows, bags of 0-5 ids, ``rows * u**2`` ids.

JAX stages each ragged step as a flat slot-id stream padded to ``Vp``, pools
it with a segment sum, and updates by one of two branches: the sparse one
(``cw.at[v].add``, Kernel 5's ordered scatter) where ``accum is None and
(use_sparse_embed_grad or device_rows > 4 * Vp)``, else the dense one, which
differentiates with respect to the whole cache in its storage dtype: the row
grads add in that dtype, in stream order, and the f32 update rounds once
(Kernel 5's ``ordered_grad_update_``). Neither reads stochastic rounding.

Tolerances, as ``tests/torch_parity.py``'s tests state them: counts equal;
losses, scores and AUROC within rtol 1e-5 (the dense towers' f32 GEMMs sum in
another order); flushed rows within 1e-5 on f32 rows, and on narrower rows
at most 0.5% of the elements one step of the rows' dtype apart (a GEMM
difference can flip a grad's rounding); Adagrad, which divides by the root
of small accumulators, within rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
import torch_parity as tp
from cachedembedding_tpu.baselines.full_resident import FullyResidentEmbeddingBag as JaxResident
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synth import SynthTraceDataset as JaxTraces
from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synth import SynthTraceDataset
from cachedembedding_tpu_torch.ops import launch_counts
from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np
from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_grad_update_, ordered_grad_update_plain
from cachedembedding_tpu_torch.ops.rounding import astype_storage

ROW_DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
BATCH, STEPS = 64, 6


def _traces(seed=5, n_tables=3, n_bags=4096, max_len=6, rows=500, sizes=None):
    """tests/test_ragged_window.py's trace pools (``sizes``: one table each)."""
    rng = np.random.default_rng(seed)
    sizes = sizes or [rows] * n_tables
    traces = []
    for n in sizes:
        lengths = rng.integers(0, max_len, n_bags)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        u = rng.random(offsets[-1])
        traces.append((np.minimum((n * u ** 2.0).astype(np.int64), n - 1), offsets))
    return traces, list(sizes)


def _cfg(port: bool, sizes, cache_ratio=0.9, cache_kw=None, **kw):
    cache_cls, cfg_cls = (CacheConfig, DLRMConfig) if port else (JaxCacheConfig, JaxDLRMConfig)
    return cfg_cls(
        num_embeddings_per_feature=list(sizes), embedding_dim=16, dense_in_features=4,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1), batch_size=BATCH,
        learning_rate=kw.pop("learning_rate", 0.5),
        cache=cache_cls(cache_ratio=cache_ratio, warmup_ratio=0.0, buffer_size=0, prefetch_num=2,
                        use_lfu_eviction=True, use_freq=False, planner="host", **(cache_kw or {})),
        **kw,
    )


def _run(port: bool, monkeypatch, traces=None, resident=False, **kw):
    """Train STEPS ragged steps, evaluate 2 batches of another seed, flush.
    Returns the losses, the evaluation, its scores, the cache counts, the
    flushed rows of every id the training stream touched and their
    accumulators (None under SGD)."""
    mod = port_trainer_mod if port else jax_trainer_mod
    traces, sizes = traces or _traces()
    cfg = _cfg(port, sizes, **kw)
    scores = []

    class Recording(mod.StreamingMetrics):
        def update(self, s, labels):
            scores.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)
    ds = SynthTraceDataset if port else JaxTraces
    train = ds(traces, sizes, batch_size=BATCH, num_batches=STEPS, dense_in_features=4)
    test = ds(traces, sizes, batch_size=BATCH, num_batches=2, dense_in_features=4, seed=99)
    extra = {"device": "cpu"} if port else {}
    if resident:
        res = (FullyResidentEmbeddingBag(sum(sizes), 16, table_sizes=sizes, seed=cfg.seed, device="cpu")
               if port else JaxResident(sum(sizes), 16, table_sizes=sizes, seed=cfg.seed))
        tr = mod.CachedDLRMTrainer(cfg, embed_override=res)
    else:
        tr = mod.CachedDLRMTrainer(cfg, **extra)
    rep = tr.train(train, num_iters=STEPS)
    ev = tr.evaluate(test)
    ids = np.unique(np.concatenate([np.asarray(b.sparse_features.values) for b in train])).astype(np.int64)
    if resident:
        rows = np.asarray(tr.embed.cache_weight, np.float32)[ids] if not port else tr.embed.dense_weight(ids)
        stats, acc = None, None
    else:
        tr.embed.flush()
        rows = np.asarray(tr.embed.host_table.gather(ids), np.float32)
        stats = {k: getattr(tr.embed.stats, k) for k in tp.STATS}
        host_acc = getattr(tr.embed, "host_accum", None)
        acc = None if host_acc is None else np.asarray(host_acc.gather(ids), np.float32)
    if port:
        tr.close()
    return dict(losses=np.asarray(rep.losses), ev=ev, scores=np.concatenate(scores), stats=stats, rows=rows,
                accum=acc)


def _compare(got, ref, rows_dtype="bfloat16", rtol=1e-5, changed_share=5e-3):
    assert got["stats"] == ref["stats"]
    assert got["losses"].shape == (STEPS,) and np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=rtol, atol=1e-6)
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= rtol
    if rows_dtype == "float32":
        np.testing.assert_allclose(got["rows"], ref["rows"], rtol=rtol, atol=1e-5)
    else:
        steps = tp.storage_steps(got["rows"], ref["rows"], getattr(torch, rows_dtype))
        assert (steps > 0).mean() <= changed_share and steps.max() <= 1, (steps > 0).mean()


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_dense_branch_matches_jax(rows, monkeypatch):
    """1,350 device rows < 4 Vp = 8,192: the dense branch, the grads summed
    in the rows' dtype (Kernel 5's ordered_grad_update_, one a step)."""
    before = launch_counts()
    kw = dict(cache_kw=dict(cache_dtype=rows))
    ref = _run(False, monkeypatch, **kw)
    got = _run(True, monkeypatch, **kw)
    _compare(got, ref, rows)
    assert launch_counts() == before  # CPU tensors: the plain versions, no launch


def test_sparse_branch_matches_jax(monkeypatch):
    """use_sparse_embed_grad on bf16 rows: the ordered scatter."""
    kw = dict(use_sparse_embed_grad=True)
    _compare(_run(True, monkeypatch, **kw), _run(False, monkeypatch, **kw))


def test_adagrad_matches_jax(monkeypatch):
    """Row-wise Adagrad (never the sparse branch) on f32 rows at learning
    rate 0.1: the accumulators grow by the mean square of each row's f32
    sum, and tier with the cache."""
    kw = dict(embedding_optimizer="rowwise_adagrad", learning_rate=0.1, cache_kw=dict(cache_dtype="float32"))
    ref = _run(False, monkeypatch, **kw)
    got = _run(True, monkeypatch, **kw)
    _compare(got, ref, "float32", rtol=1e-4)
    np.testing.assert_allclose(got["accum"], ref["accum"], rtol=1e-4, atol=1e-9)
    assert (got["accum"] > 0).sum() > 100


def test_mean_mode_matches_jax(monkeypatch):
    kw = dict(reduction_mode="mean")
    _compare(_run(True, monkeypatch, **kw), _run(False, monkeypatch, **kw))


def test_resident_split_matches_jax(monkeypatch):
    """Tables 1 and 2 resident under threshold 100 (tests/test_ragged_window.py's
    sizes): their ids translate to the resident region, in the same flat
    stream."""
    traces = _traces(seed=9, max_len=5, n_bags=2048, sizes=[800, 60, 30])
    kw = dict(traces=traces, cache_kw=dict(resident_threshold=100))
    ref = _run(False, monkeypatch, **kw)
    got = _run(True, monkeypatch, **kw)
    _compare(got, ref)


def test_evictions_match_jax(monkeypatch):
    """A cache of half the rows: evictions write trained rows back and
    admit them again."""
    kw = dict(cache_ratio=0.5)
    ref = _run(False, monkeypatch, **kw)
    got = _run(True, monkeypatch, **kw)
    assert sum(got["stats"]["num_write_back_history"]) > 0
    _compare(got, ref)


@pytest.mark.parametrize("rows", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_rows_with_rounding_on_take_jax_plain_cast(rows, monkeypatch):
    """Stochastic rounding is on for fp8 rows, but JAX's ragged window passes
    no seed: its update casts plainly (round to nearest), with the grads
    summed in fp8. The port launches no rounding kernel and matches."""
    kw = dict(cache_kw=dict(cache_dtype=rows, stochastic_rounding="on"))
    ref = _run(False, monkeypatch, **kw)
    got = _run(True, monkeypatch, **kw)
    _compare(got, ref, rows)


def test_resident_table_matches_jax(monkeypatch):
    """A fully resident f32 table: JAX trains ragged batches by its
    per-step function, always dense, on the f32 dense features."""
    ref = _run(False, monkeypatch, resident=True)
    got = _run(True, monkeypatch, resident=True)
    _compare(got, ref, "float32")


def test_resident_table_refuses_adagrad_on_ragged_batches():
    """JAX's per-step function ignores the accumulators (it trains SGD);
    the port refuses rather than train another optimizer than asked."""
    traces, sizes = _traces()
    cfg = _cfg(True, sizes, embedding_optimizer="rowwise_adagrad")
    res = FullyResidentEmbeddingBag(sum(sizes), 16, table_sizes=sizes, device="cpu", optimizer="rowwise_adagrad")
    tr = port_trainer_mod.CachedDLRMTrainer(cfg, embed_override=res)
    data = SynthTraceDataset(traces, sizes, batch_size=BATCH, num_batches=2, dense_in_features=4)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tr.train(data, num_iters=2)
    assert np.isfinite(tr.evaluate(data)["auroc"])


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("rows,ratio", [(500, 0.9), (5000, 0.9)], ids=["rows_below_4Vp", "rows_above_4Vp"])
@pytest.mark.parametrize("kw", [dict(), dict(use_sparse_embed_grad=True),
                                dict(embedding_optimizer="rowwise_adagrad"),
                                dict(cache_kw=dict(stochastic_rounding="on", ship_sort_perm=True))],
                         ids=["sgd", "use_sparse_embed_grad", "adagrad", "rounding_and_plans_on"])
def test_branch_choice_matches_jax(rows, ratio, kw, monkeypatch):
    """The branch the port picks for a ragged window is JAX's, for device
    rows on each side of 4 Vp (Vp = 2,048 here: 1,350 and 13,500 rows)."""
    traces = _traces(rows=rows)
    seen = []

    def ragged(*a, sparse_grad, **k):
        seen.append("sparse" if sparse_grad else "dense")
        raise _Chosen

    monkeypatch.setattr(jax_trainer_mod, "_train_window_ragged", ragged)
    data = JaxTraces(*traces, batch_size=BATCH, num_batches=2, dense_in_features=4)
    jt = jax_trainer_mod.CachedDLRMTrainer(_cfg(False, traces[1], cache_ratio=ratio, **kw))
    with pytest.raises(_Chosen):
        jt.train(data, num_iters=2)
    tr = port_trainer_mod.CachedDLRMTrainer(_cfg(True, traces[1], cache_ratio=ratio, **kw), device="cpu")
    win = tr._begin_window(list(SynthTraceDataset(*traces, batch_size=BATCH, num_batches=2, dense_in_features=4)))
    tr.close()
    assert win.vp == 2048
    assert tr.branch_of(win) == seen[0]


def _jax_dense_update(cw0, cot, v, slr, eps, acc0, name):
    """JAX's dense ragged update on rows of ``name``: the cotangent of
    ``take(cw, v).astype(f32)`` w.r.t. cw (the grads cast to the rows' dtype
    and added in it), then the f32 SGD or Adagrad update, one rounding."""
    dt = jnp.dtype(name)
    cw = jnp.asarray(cw0).astype(dt)
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(v), axis=0, mode="wrap").astype(jnp.float32), cw)
    (g,) = vjp(jnp.asarray(cot))
    g32 = g.astype(jnp.float32)
    acc = None
    if acc0 is not None:
        acc = jnp.asarray(acc0) + jnp.mean(g32 * g32, axis=1)
        g32 = g32 / (jnp.sqrt(acc) + eps)[:, None]
    out = (cw.astype(jnp.float32) - slr * g32).astype(dt)
    return np.asarray(out.astype(jnp.float32)), None if acc is None else np.asarray(acc)


@pytest.mark.parametrize("opt", ["sgd", "rowwise_adagrad"])
@pytest.mark.parametrize("name", ROW_DTYPES)
def test_ordered_grad_update_is_bit_equal_to_jax(name, opt):
    """Skewed ids (rows with hundreds of grads, so the adds in the rows'
    dtype round and absorb), grads past fp8's range on a few rows, a row no
    id touches: the plain version equals XLA's transpose of the gather and
    JAX's update bit for bit, accumulators included (XLA's CPU scatter adds
    in stream order)."""
    rng = np.random.default_rng(3)
    C, D, L, slr, eps = 64, 8, 4000, 0.37, 1e-10
    cw0 = rng.standard_normal((C, D)).astype(np.float32)
    cot = (rng.standard_normal((L, D)) * 0.3).astype(np.float32)
    cot[:3] *= 1e5
    v = (rng.zipf(1.5, L) % C).astype(np.int32)
    v[v == 9] = 10  # row 9 untouched
    acc0 = rng.random(C).astype(np.float32) if opt == "rowwise_adagrad" else None
    want, want_acc = _jax_dense_update(cw0, cot, v, slr, eps, acc0, name)
    dt = getattr(torch, name)
    cw = astype_storage(torch.from_numpy(cw0), dt)
    acc = None if acc0 is None else torch.from_numpy(acc0.copy())
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(v, C))
    got = ordered_grad_update_(cw, acc, astype_storage(torch.from_numpy(cot), dt), perm, grouped, slr, eps)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy()[9], astype_storage(torch.from_numpy(cw0[9]), dt).float().numpy())
    if acc is not None:
        np.testing.assert_array_equal(acc.numpy(), want_acc)


def test_grad_update_sums_in_the_rows_dtype():
    """1,000 grads of -1 into one bf16 row: the sum stops at -256 (past 256 a
    bf16 step is 2, and 256 + 1 rounds back), so SGD at slr 1 moves the row
    by 256, not 1,000; the plain version loops rank by rank as the stream
    would, one rounded add at a time."""
    g = astype_storage(torch.full((1000, 1), -1.0), torch.bfloat16)
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(np.zeros(1000, np.int32), 2))
    cw = torch.zeros((2, 1), dtype=torch.bfloat16)
    ordered_grad_update_plain(cw, None, g, perm, grouped, 1.0)
    assert cw[0, 0].item() == 256.0 and cw[1, 0].item() == 0.0


def test_grad_update_wrapper_checks_its_arguments():
    cw = torch.zeros((4, 2), dtype=torch.bfloat16)
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(np.array([1, 2], np.int32), 4))
    with pytest.raises(ValueError, match="rows' dtype"):
        ordered_grad_update_(cw, None, torch.zeros((2, 2)), perm, grouped, 1.0)
    with pytest.raises(ValueError, match="accum"):
        ordered_grad_update_(cw, torch.zeros(3), torch.zeros((2, 2), dtype=torch.bfloat16), perm, grouped, 1.0)
