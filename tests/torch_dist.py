"""Spawned ranks for the port's multi-rank tests: gloo on the CPU, a file
rendezvous under the test's own directory, one thread a rank, and a
timeout, so that a hung collective fails its test instead of the suite.

This module imports neither jax nor a test module: with ``spawn`` every rank
imports the module of the function it runs, and that must not load JAX.
Each rank function takes (mesh, payload) and returns something picklable;
``spawn`` returns the ranks' results in rank order.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

SPAWN_TIMEOUT_S = 240


def _entry(rank: int, world: int, root: str, fn_name: str, payload) -> None:
    import torch

    torch.set_num_threads(1)
    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh

    out = Path(root) / f"rank{rank}.pkl"
    try:
        mesh = make_mesh(world, device="cpu", init_method=f"file://{root}/rendezvous", rank=rank)
        result = globals()[fn_name](mesh, payload)
        destroy_mesh(mesh)
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def spawn(fn_name: str, world: int, root, payload=None, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``fn_name(mesh, payload)`` of this module on ``world`` spawned
    ranks (gloo, rendezvous in ``root``). Returns their results; raises with
    a rank's traceback if one fails, or after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, str(root), fn_name, payload), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn_name} on {world} ranks did not finish in {timeout} s")
    except Exception as err:
        for r in range(world):
            f = root / f"rank{r}.pkl"
            if f.exists():
                status, res = pickle.loads(f.read_bytes())
                if status == "error":
                    raise RuntimeError(f"rank {r} of {fn_name} failed:\n{res}") from err
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        status, res = pickle.loads((root / f"rank{r}.pkl").read_bytes())
        if status != "ok":
            raise RuntimeError(f"rank {r} of {fn_name} failed:\n{res}")
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# the ranks' work


TABLES = [700, 300]


def mesh_config(batch_size: int, tables=TABLES, cache_kw=None, **kw):
    """``tests/test_mesh_window.py``'s configuration in the port."""
    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig

    ckw = dict(cache_ratio=0.9, warmup_ratio=0.7, buffer_size=0, prefetch_num=2, use_lfu_eviction=True,
               use_freq=False, planner="host")
    ckw.update(cache_kw or {})
    return DLRMConfig(num_embeddings_per_feature=list(tables), embedding_dim=16, dense_in_features=4,
                      dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1), batch_size=batch_size,
                      learning_rate=0.5, cache=CacheConfig(**ckw), **kw)


def mesh_data(tables, cfg, n: int, seed: int = 21):
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

    return SyntheticLongTailDataset(list(tables), cfg.batch_size, num_batches=n, dense_in_features=4, seed=seed)


def train_case(mesh, case: dict) -> dict:
    """Train ``case["n"]`` steps and evaluate ``case["eval_n"]`` batches on
    ``mesh`` (one card where it is None); returns the losses, the
    evaluation, the training stream's rows flushed (this rank's columns),
    the cache counts and, with ``uniforms``, stochastic rounding drawn from
    them (a dict of step seed -> uniforms)."""
    import torch

    from cachedembedding_tpu_torch.ops import rounding
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    uniforms = case.get("uniforms")
    old = rounding.philox_uniform
    if uniforms is not None:
        rounding.philox_uniform = lambda seed, shape, device=None: torch.from_numpy(uniforms[int(seed)]).to(device)
    try:
        tables = case.get("tables", TABLES)
        cfg = mesh_config(case["batch"], tables, case.get("cache_kw"), **case.get("kw", {}))
        data = mesh_data(tables, cfg, case["n"])
        tr = CachedDLRMTrainer(cfg, device="cpu" if mesh is None else None, mesh=mesh)
        digests = _record_plans(tr.embed)
        rep = tr.train(data, num_iters=case["n"])
        ev = tr.evaluate(mesh_data(tables, cfg, case.get("eval_n", 2), seed=99)) if case.get("eval_n", 2) else None
        rows = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in data])).astype(np.int64)
        flushed = tr.embed.dense_weight(rows)
        if case.get("checkpoint"):
            from cachedembedding_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(case["checkpoint"], tr)
        out = dict(losses=np.asarray(rep.losses), ev=ev, rows=np.asarray(flushed), sr=tr._sr,
                   device_rows=tr.embed.device_rows, plan_digests=digests,
                   fetched_rows=tr.embed.stats.swap_in_bytes // (4 * cfg.embedding_dim),
                   stats=(tr.embed.stats.prepare_calls, list(tr.embed.stats.num_hits_history),
                          list(tr.embed.stats.num_miss_history), list(tr.embed.stats.num_write_back_history)))
        if case.get("load"):
            from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint

            load_checkpoint(case["load"], tr)
            out["loaded_table"] = np.array(tr.embed.host_table.array)
            out["loaded_ev"] = tr.evaluate(mesh_data(tables, cfg, 2, seed=99))
        tr.close()
        return out
    finally:
        rounding.philox_uniform = old


def _record_plans(embed) -> list:
    """Record a digest of every window plan the bag makes (its host plan's
    slots, admits and evictions, or the device planner's read-back plan):
    every rank must plan alike."""
    import hashlib

    digests = []

    def digest(*arrays):
        h = hashlib.sha1()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        digests.append(h.hexdigest())

    stage, finish = embed.begin_window_staging, embed.finish_prepare

    def begin_window_staging(*a, **k):
        ws = stage(*a, **k)
        digest(ws.slot_ids, ws.admit_slots, ws.evict_rows, ws.synth_rows, ws.fetch_rows)
        return ws

    def finish_prepare(pw):
        finish(pw)
        digest(pw.host_scalars.numpy(), pw.host_indices.numpy(), pw.slot_ids.numpy())

    embed.begin_window_staging, embed.finish_prepare = begin_window_staging, finish_prepare
    return digests


def train_cases(mesh, cases: dict) -> dict:
    """``train_case`` for each named case, in one group of ranks."""
    return {name: train_case(mesh, case) for name, case in cases.items()}


def join_columns(results: list, key: str = "rows") -> np.ndarray:
    """The ranks' column blocks of ``key`` side by side: the full rows."""
    return np.concatenate([r[key] for r in results], axis=1)


def rank_payloads(mesh, rows: np.ndarray) -> dict:
    """This rank's int8 and int4 fetched-admit payloads of the full ``rows``
    (its columns, quantized as a column-sharded bag quantizes them),
    dequantized as the cache lands them."""
    import torch

    from cachedembedding_tpu_torch.cache.state import dequant_q8, dequant_rows_q4
    from cachedembedding_tpu_torch.parallel.column import ParallelCachedEmbeddingBag

    out = {}
    for mode in ("int8", "int4"):
        bag = ParallelCachedEmbeddingBag(100, rows.shape[1], mesh=mesh, cache_ratio=0.5, transfer_dtype=mode,
                                         buffer_size=0)
        cols = slice(bag.col_start, bag.col_start + bag.dim_stored)
        payload, scales = bag._payload(np.ascontiguousarray(rows[:, cols]))
        s = torch.from_numpy(scales)
        out[mode] = (dequant_q8(payload, s) if mode == "int8"
                     else dequant_rows_q4(payload, s, bag.dim_stored)).numpy()
        bag.close()
    return out


def mesh_window_cases(mesh, cases: dict) -> dict:
    """``train_cases``, where the case "payloads" is ``rank_payloads``."""
    return {name: rank_payloads(mesh, case["payload_rows"]) if name == "payloads" else train_case(mesh, case)
            for name, case in cases.items()}


# ---------------------------------------------------------------------------
# the table-wise layout and the hybrid step


def make_tablewise(mesh, table_sizes, ranks, D, W_global, cache_full=True):
    """``tests/test_tablewise.py``'s ``_make_tablewise`` in the port: zero
    host tables, no warmup, LFU, then this rank's host table holds its
    tables' rows of ``W_global`` and a zero pad row."""
    from cachedembedding_tpu_torch.cache.host_table import DenseHostTable
    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.parallel.tablewise import (
        ParallelCachedEmbeddingBagTablewise,
        TablewiseEmbeddingBagConfig,
    )

    cfgs = [TablewiseEmbeddingBagConfig(num_embeddings=n, cuda_row_num=n if cache_full else max(2, n // 4),
                                        assigned_rank=r) for n, r in zip(table_sizes, ranks)]
    tw = ParallelCachedEmbeddingBagTablewise(cfgs, D, mesh, warmup_ratio=0.0, weight_init="zeros",
                                             evict_strategy=EvictionStrategy.LFU)
    offs = np.concatenate([[0], np.cumsum(table_sizes)])
    rows = [W_global[offs[t]: offs[t + 1]] for t in tw.tables_of_rank[mesh.rank]]
    rows.append(np.zeros((1, D), np.float32))
    tw.host_tables[mesh.rank] = DenseHostTable(np.ascontiguousarray(np.concatenate(rows)))
    return tw


def _dlrm_from(params, D, F, Din, dense_arch, over_arch):
    """The port's DLRM holding JAX's ``params`` (numpy, JAX layout)."""
    from cachedembedding_tpu_torch.models.dlrm import DLRM, params_from_jax

    model = DLRM(D, F, Din, dense_arch, over_arch, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _local(mesh, x):
    import torch

    b = x.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(x[mesh.rank * b: (mesh.rank + 1) * b]))


def tablewise_step_cases(mesh, c: dict) -> dict:
    """``tests/test_tablewise.py``'s step cases on this rank: one
    ``tablewise_train_step`` (then a flush), the same batches per batch and
    as one ``tablewise_window_step``, and ``tablewise_eval_step`` on the
    window's trained weights. Returns this rank's losses, host table rows,
    dense weights (JAX layout) and probabilities."""
    import torch

    from cachedembedding_tpu_torch.models.dlrm import params_to_jax
    from cachedembedding_tpu_torch.parallel.tablewise import (
        tablewise_eval_step,
        tablewise_train_step,
        tablewise_window_step,
    )

    sizes, ranks, W, D, B = c["table_sizes"], c["ranks"], c["W_global"], c["D"], c["B"]
    arch = (c["Din"], c["dense_arch"], c["over_arch"])
    lr = c["lr"]
    out = {}

    def build(kind):
        tw = make_tablewise(mesh, sizes, ranks, D, W)
        return tw, _dlrm_from(c["params"], D, len(sizes), *arch), kind(
            mesh, feature_perm=tw.feature_select_perm(), f_max=tw.F_max, global_batch=B)

    # one step, then the flushed host table
    tw, model, step = build(tablewise_train_step)
    ids_bf, dense, labels = c["batches"][0]
    slot_ids, plans = tw.begin_prepare(ids_bf)
    tw.finish_prepare(plans)
    loss = step(model, tw.cache_weight, _local(mesh, dense), slot_ids, _local(mesh, labels), lr, lr)
    tw.flush()
    out["step"] = dict(loss=float(loss), table=tw.host_tables[mesh.rank].array.copy(), params=params_to_jax(model),
                       stats=(list(tw.stats.num_hits_history), list(tw.stats.num_miss_history)))
    # per batch
    tw, model, step = build(tablewise_train_step)
    losses = []
    for ids_bf, dense, labels in c["batches"]:
        slot_ids, plans = tw.begin_prepare(ids_bf)
        tw.finish_prepare(plans)
        losses.append(float(step(model, tw.cache_weight, _local(mesh, dense), slot_ids, _local(mesh, labels),
                                 lr, lr)))
    out["per_batch"] = dict(losses=losses, params=params_to_jax(model))
    # the window, then its scoring
    tw, model, step = build(tablewise_window_step)
    slot_ids, plans = tw.begin_prepare_window([b[0] for b in c["batches"]])
    tw.finish_prepare(plans)
    P_ = len(c["batches"])
    dense_P = np.stack([b[1] for b in c["batches"]])
    labels_P = np.stack([b[2] for b in c["batches"]])
    b = B // mesh.size
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    losses = step(model, tw.cache_weight, slot_ids, torch.from_numpy(dense_P[:, sl].copy()),
                  torch.from_numpy(labels_P[:, sl].copy()), [lr] * P_, [lr] * P_)
    ev = tablewise_eval_step(mesh, feature_perm=tw.feature_select_perm(), f_max=tw.F_max, global_batch=B)
    probs = ev(model, tw.cache_weight, slot_ids, torch.from_numpy(dense_P[:, sl].copy()))
    out["window"] = dict(losses=losses.numpy(), params=params_to_jax(model), probs=probs.numpy())
    return out


def tablewise_pressure_case(mesh, c: dict) -> dict:
    """``tests/test_tablewise.py::test_cache_pressure_roundtrip`` on this
    rank: windows of lookups through a cache of a quarter of each table;
    the cache rows the slot ids name must be the table's. Returns this
    rank's largest difference, the cache statistics and the flushed host
    table."""
    sizes, ranks, W, D, B = c["table_sizes"], c["ranks"], c["W_global"], c["D"], c["B"]
    tw = make_tablewise(mesh, sizes, ranks, D, W, cache_full=False)
    offs = np.cumsum([0] + list(sizes))
    err = 0.0
    for ids_bf in c["ids"]:
        slot_ids, plans = tw.begin_prepare(ids_bf)
        tw.finish_prepare(plans)
        sl, cw = slot_ids.numpy(), tw.cache_weight.numpy()
        for t in tw.tables_of_rank[mesh.rank]:
            j = tw.feat_pos[t][1]
            got = cw[sl[j * B: (j + 1) * B]]
            err = max(err, float(np.abs(got - W[offs[t] + ids_bf[:, t]]).max()))
    tw.flush()
    s = tw.stats
    return dict(err=err, stats=(s.prepare_calls, list(s.num_hits_history), list(s.num_miss_history),
                                s.swap_in_bytes, s.swap_out_bytes),
                table=tw.host_tables[mesh.rank].array.copy())


def hybrid_cases(mesh, c: dict) -> dict:
    """This rank's part of ``tests/test_torch_hybrid.py``'s cases: the
    hybrid step with each fused op (its loss, its column shard and dense
    weights after one step), the id exchanges, ``HybridParallelDLRM`` in
    both layouts (losses, hit rate, ``model_stats``) and the dry run."""
    import torch

    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.models.dlrm import params_to_jax
    from cachedembedding_tpu_torch.models.hybrid import HybridParallelDLRM
    from cachedembedding_tpu_torch.parallel import all_to_all as a2a
    from cachedembedding_tpu_torch.parallel.hybrid import dryrun_hybrid_train_step, hybrid_train_step

    out = {}
    s = c["step"]
    dpr = s["cache"].shape[1] // mesh.size
    cols = slice(mesh.rank * dpr, (mesh.rank + 1) * dpr)
    for op in ("all_to_all", "gather_scatter"):
        model = _dlrm_from(s["params"], s["cache"].shape[1], s["F"], s["dense"].shape[1], (8, s["cache"].shape[1]),
                           (8, 4, 1))
        step = hybrid_train_step(mesh, num_features=s["F"], global_batch=s["dense"].shape[0], fused_op=op)
        cw = torch.from_numpy(np.ascontiguousarray(s["cache"][:, cols]))
        loss = step(model, cw, _local(mesh, s["dense"]), torch.from_numpy(s["slot_ids"]),
                    _local(mesh, s["labels"]), s["lr"], s["lr"])
        out[op] = dict(loss=float(loss), cache=cw.numpy(), params=params_to_jax(model))

    e = c["exchange"]
    ids, owners = torch.from_numpy(e["ids"][mesh.rank]), torch.from_numpy(e["owners"][mesh.rank])
    bucketed, counts = a2a.bucket_by_owner(ids, owners, mesh.size, e["V"])
    recv, recv_counts = a2a.exchange_to_owners(bucketed, counts, mesh)
    vals = torch.from_numpy(e["fbp"][mesh.rank].reshape(-1))
    ragged = torch.from_numpy(e["ragged"][mesh.rank])
    lengths = torch.from_numpy(e["lengths"][mesh.rank])
    vg, lg = a2a.exchange_ragged(ragged, lengths, ragged.shape[0], mesh)
    out["exchange"] = dict(recv=recv.numpy(), counts=recv_counts.numpy(),
                           uniform=a2a.gather_global_uniform(vals, e["F"], e["P"], mesh).numpy(),
                           ragged=[x.numpy() for x in a2a.compact_ragged_global(vg, lg, mesh.size, ragged.shape[0],
                                                                                e["out_size"])])

    h = c["hybrid"]
    for layout, tables, n, seed in (("column", h["column_tables"], 6, 2), ("tablewise", h["tablewise_tables"], 5, 3)):
        cfg = DLRMConfig(num_embeddings_per_feature=tables, embedding_dim=32, dense_in_features=4,
                         dense_arch_layer_sizes=(16, 32), over_arch_layer_sizes=(16, 8, 1), batch_size=64,
                         learning_rate=0.2, use_tablewise=layout == "tablewise",
                         cache=CacheConfig(cache_ratio=0.5, warmup_ratio=0.5, buffer_size=0))
        data = SyntheticLongTailDataset(tables, cfg.batch_size, n, dense_in_features=4, seed=seed,
                                        global_ids=layout == "column")
        model = HybridParallelDLRM(cfg, mesh, id_freq_map=data.id_freq_map(),
                                   dataset="synthetic" if layout == "tablewise" else None)
        losses = []
        for b in data:
            if layout == "column":
                slots = model.embed.prepare_ids(b.sparse_features.values.numpy())
            else:
                slots, plans = model.embed.begin_prepare(b.sparse_features.to_fbp()[:, :, 0].T.numpy())
                model.embed.finish_prepare(plans)
            losses.append(float(model.train_step(b.dense_features, slots, b.labels, 0.2, 0.2)))
        out[layout] = dict(losses=losses, hit_rate=model.embed.stats.hit_rate(), stats=model.model_stats("hybrid"))
        if layout == "column":
            model.embed.close()
    out["dryrun"] = dryrun_hybrid_train_step(mesh.size, "cpu")
    return out


# ---------------------------------------------------------------------------
# the row-wise and row-sharded cached layouts


def rowwise_lookup_cases(mesh, cases: dict) -> dict:
    """``parallel/row.make_rowwise_embedding_fn`` on this rank for each case
    (N, w the full (N, D) table, ids): the looked-up rows, and this rank's
    shard grad of their sum."""
    import torch

    from cachedembedding_tpu_torch.parallel.row import make_rowwise_embedding_fn

    out = {}
    for name, c in cases.items():
        lookup, shard_weight = make_rowwise_embedding_fn(mesh, c["N"])
        w_local = shard_weight(c["w"]).requires_grad_(True)
        rows = lookup(w_local, torch.from_numpy(c["ids"]))
        rows.sum().backward()
        out[name] = dict(rows=rows.detach().numpy(), grad=w_local.grad.numpy())
    return out


def _row_cached_case(mesh, c: dict) -> dict:
    """One of ``tests/test_row_cached.py``'s cases on this rank through
    ``parallel/row_cached``: ``c["kind"]`` "step" (per batch), "window" (P
    steps a window) or "eval" (one batch scored), on the global (W, L) ids
    of each batch or window (``c["ids"]``) and this rank's dense features
    and labels. Returns every enc, the losses or probabilities, the
    aggregated stats and the flushed master."""
    import torch

    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.parallel.row_cached import (
        RowShardedCachedEmbeddingBag,
        build_rowwise_cached_step,
        build_rowwise_cached_window,
    )

    D, F, B, din = c["D"], c["F"], c["B"], c["Din"]
    r = mesh.rank
    bag = RowShardedCachedEmbeddingBag(c["N"], D, mesh=mesh, cuda_row_num=c["cap"], initial_weight=c.get("w0"),
                                       evict_strategy=EvictionStrategy.LFU, buffer_size=0)
    net = _dlrm_from(c["params"], D, F, din, (16, D), (16, 8, 1))
    kw = dict(num_features=F, global_batch=B, pooling=1, capacity=c["cap"])
    out = dict(enc=[], losses=[])
    lr = c["lr"]
    if c["kind"] == "window":
        step = build_rowwise_cached_window(mesh, **kw)
        for ids, dense, labels in c["batches"]:  # ids (W, P * L), dense (P, W, B_local, Din), labels (P, W, B_local)
            P_ = dense.shape[0]
            enc = bag.prepare_ids_per_rank(ids)
            out["enc"].append(enc)
            losses = step(net, bag.global_cache(), torch.from_numpy(enc[r].reshape(P_, -1)),
                          torch.from_numpy(dense[:, r].copy()), torch.from_numpy(labels[:, r].copy()),
                          [lr] * P_, [lr] * P_)
            out["losses"] += losses.tolist()
    elif c["kind"] == "step":
        step = build_rowwise_cached_step(mesh, **kw)
        for ids, dense, labels in c["batches"]:  # ids (W, L), dense (W, B_local, Din), labels (W, B_local)
            enc = bag.prepare_ids_per_rank(ids)
            out["enc"].append(enc)
            out["losses"].append(float(step(net, bag.global_cache(), torch.from_numpy(enc[r]),
                                            torch.from_numpy(dense[r]), torch.from_numpy(labels[r]), lr, lr)))
    else:
        score = build_rowwise_cached_step(mesh, train=False, **kw)
        ids, dense, _ = c["batches"][0]
        enc = bag.prepare_ids_per_rank(ids)
        out["enc"].append(enc)
        out["probs"] = score(net, bag.global_cache(), torch.from_numpy(enc[r]), torch.from_numpy(dense[r])).numpy()
    out["master"] = bag.dense_weight()
    st = bag.aggregate_stats()  # after the flush: every writeback has landed (the drain thread counts them)
    out["stats"] = (st.prepare_calls, st.num_hits_history, st.num_miss_history, st.num_write_back_history,
                    st.swap_in_bytes, st.swap_out_bytes)
    bag.close()
    return out


def row_cached_cases(mesh, cases: dict) -> dict:
    """``_row_cached_case`` for each named case, and "init": this rank's
    host table rows of a shard built without ``initial_weight``."""
    from cachedembedding_tpu_torch.parallel.row_cached import RowShardedCachedEmbeddingBag

    out = {name: _row_cached_case(mesh, c) for name, c in cases.items() if name != "init"}
    if "init" in cases:
        c = cases["init"]
        bag = RowShardedCachedEmbeddingBag(c["N"], c["D"], mesh=mesh, cuda_row_num=8, warmup_ratio=0.0)
        out["init"] = bag.shard.host_table.gather(np.arange(bag.per, dtype=np.int64))
        bag.close()
    return out


def rowwise_flush_case(mesh, payload=None):
    """``tests/helpers/mp_rowwise_flush.py`` in the port: a row-sharded
    cached bag (LFU, a 0.3 cache ratio, seed 3, a seeded initial table)
    through 6 training steps of churn, then ``dense_weight``. Returns the
    master's sha256 and the master."""
    import hashlib

    import torch

    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.models.dlrm import DLRM
    from cachedembedding_tpu_torch.parallel.row_cached import RowShardedCachedEmbeddingBag, build_rowwise_cached_step

    W, r = mesh.size, mesh.rank
    N, D, B, F = 1024, 16, 32, 4
    rng = np.random.default_rng(0)
    init = rng.standard_normal((N, D)).astype(np.float32)
    bag = RowShardedCachedEmbeddingBag(N, D, mesh=mesh, cache_ratio=0.3, evict_strategy=EvictionStrategy.LFU,
                                       initial_weight=init, seed=3)
    step = build_rowwise_cached_step(mesh, num_features=F, global_batch=B, pooling=1, capacity=bag.capacity)
    net = DLRM(D, F, 4, (8, D), (8, 1), seed=0, device="cpu")
    for _ in range(6):
        enc = bag.prepare_ids_per_rank(rng.integers(0, N, size=(W, F * (B // W))).astype(np.int64))
        dense = rng.standard_normal((W, B // W, 4)).astype(np.float32)
        labels = rng.integers(0, 2, size=(W, B // W)).astype(np.float32)
        step(net, bag.global_cache(), torch.from_numpy(enc[r]), torch.from_numpy(dense[r]),
             torch.from_numpy(labels[r]), 0.5, 0.5)
    full = bag.dense_weight()
    bag.close()
    return hashlib.sha256(np.ascontiguousarray(full, np.float32).tobytes()).hexdigest(), full


def tcp_rank(fn_name: str, address: str, world: int, rank: int, out: str) -> None:
    """Run ``fn_name(mesh, None)`` of this module as global ``rank`` of a
    ``world``-rank gloo group that meets at ``tcp://address`` (a process of
    its own, as one host of a multi-host run), and pickle its result to
    ``out``."""
    import torch

    torch.set_num_threads(1)
    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh

    mesh = make_mesh(world, device="cpu", init_method=f"tcp://{address}", rank=rank)
    result = globals()[fn_name](mesh, None)
    destroy_mesh(mesh)
    with open(out, "wb") as f:
        pickle.dump(result, f)
