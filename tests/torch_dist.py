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
