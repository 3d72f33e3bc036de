"""Checkpoint and resume (counterpart of
``cachedembedding_tpu/utils/checkpoint.py``), in the JAX package's layout, so
either package reads the other's checkpoints:

  meta.json          the step counter, format version, table kind and shape
  dense_params.npz   the DLRM/DeepFM tower weights, under the JAX pytree
                     paths (".dense_arch/[0]/['w']", ...), each ``w`` (in, out)
  host_table.npy     the flushed f32 master table (a dense host table, or
                     the fully resident table read off the device), or
  overlay.npz        for a virtual host table, only its written rows
                     (``rows``, ``vals``)
  accum.npy          row-wise Adagrad: the (N,) f32 accumulators (a dense
                     host table, or the fully resident table's, read off the
                     device), or
  accum.npz          for a virtual host table, the written rows' (``rows``,
                     ``vals``)

Saving flushes the cache first. On a column-wise mesh
(``parallel/column.py``) every rank flushes its columns; rank 0 creates the
full-width ``host_table.npy`` and, after a barrier, each rank writes its own
columns into it (a virtual table's written rows are gathered to rank 0), and
only rank 0 writes the rest. So a checkpoint of w ranks loads into one card
and the other way round: each rank reads its columns. Loading restores the dense weights, the table
and the accumulators; the cache is derived state and warms again from the
id-frequency map as at a cold start (``CachedEmbeddingBag.reset_cache``),
its warm rows carrying their restored accumulators. As in the JAX package, a
checkpoint's accumulators are read only by an Adagrad trainer, and an
Adagrad trainer that loads a checkpoint without them starts them at
``adagrad_initial``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.cache.host_table import DenseAccumStore, DenseHostTable, VirtualHostTable
from cachedembedding_tpu_torch.models import deepfm, dlrm
from cachedembedding_tpu_torch.ops.rounding import astype_storage
from cachedembedding_tpu_torch.parallel.multiproc import replicate_fn

FORMAT_VERSION = 1
_ROWS_PER_COPY = 1 << 20  # rows moved between the device table and the file at a time


def _model_module(trainer):
    return deepfm if trainer.cfg.model == "deepfm" else dlrm


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{JAX pytree path: leaf}. The top level is the params NamedTuple (its
    fields print as ".name"); lists print "[i]" and dicts "['key']"."""
    if isinstance(tree, np.ndarray):
        return {prefix: tree}
    if isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        items = [(f".{k}" if not prefix else f"['{k}']", v) for k, v in tree.items()]
    out = {}
    for key, v in items:
        out.update(_flatten(v, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten_like(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(template, np.ndarray):
        arr = np.asarray(flat[prefix], np.float32)
        if arr.shape != template.shape:
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape}, model {template.shape}")
        return arr
    if isinstance(template, (list, tuple)):
        return [_unflatten_like(v, flat, f"{prefix}/[{i}]") for i, v in enumerate(template)]
    return {k: _unflatten_like(v, flat, (f"{prefix}/['{k}']" if prefix else f".{k}")) for k, v in template.items()}


def _save_columns(path: str, embed) -> str:
    """A column-wise mesh's host table (every rank calls this): the dense
    full-width ``host_table.npy`` with each rank's columns written by that
    rank, or a virtual table's written rows, gathered to rank 0. Returns the
    table kind."""
    import torch.distributed as dist

    mesh = embed.mesh
    c0, c1 = embed.col_start, embed.col_start + embed.dim_stored
    ht = embed.host_table
    file = os.path.join(path, "host_table.npy")
    if isinstance(ht, DenseHostTable):
        if mesh.rank == 0:
            np.lib.format.open_memmap(file, mode="w+", dtype=np.float32,
                                      shape=(embed.num_embeddings, embed.embedding_dim)).flush()
        dist.barrier(group=mesh.host_group)
        out = np.load(file, mmap_mode="r+")
        for s in range(0, out.shape[0], _ROWS_PER_COPY):
            out[s : s + _ROWS_PER_COPY, c0:c1] = ht.array[s : s + _ROWS_PER_COPY]
        out.flush()
        del out
        dist.barrier(group=mesh.host_group)
        return "dense"
    if not isinstance(ht, VirtualHostTable):
        raise TypeError(f"unknown host table {type(ht)}")
    rows = np.sort(ht.written_rows())  # the same rows on every rank: each writes back the same evictions
    local = torch.from_numpy(ht.gather(rows) if rows.size else np.zeros((0, ht.dim), np.float32))
    vals = replicate_fn(mesh, axis=1)(local)
    if mesh.rank == 0:
        np.savez(os.path.join(path, "overlay.npz"), rows=rows, vals=vals.numpy())
    return "virtual"


def _save_table(path: str, embed) -> str:
    """One process's host table (or the resident table, read off the
    device) into ``path``. Returns the table kind."""
    if isinstance(embed, FullyResidentEmbeddingBag):
        out = np.lib.format.open_memmap(os.path.join(path, "host_table.npy"), mode="w+", dtype=np.float32,
                                        shape=tuple(embed.cache_weight.shape))
        for s in range(0, out.shape[0], _ROWS_PER_COPY):
            out[s : s + _ROWS_PER_COPY] = embed.cache_weight[s : s + _ROWS_PER_COPY].float().cpu().numpy()
        out.flush()
        del out
        table_kind = "dense"
        if embed.cache_accum is not None:
            np.save(os.path.join(path, "accum.npy"), embed.cache_accum.cpu().numpy())
    elif isinstance(embed.host_table, DenseHostTable):
        np.save(os.path.join(path, "host_table.npy"), embed.host_table.array)
        table_kind = "dense"
    elif isinstance(embed.host_table, VirtualHostTable):
        rows = embed.host_table.written_rows()
        vals = embed.host_table.gather(rows) if rows.size else np.zeros((0, embed.host_table.dim), np.float32)
        np.savez(os.path.join(path, "overlay.npz"), rows=rows, vals=vals)
        table_kind = "virtual"
    else:
        raise TypeError(f"unknown host table {type(embed.host_table)}")
    return table_kind


def save_checkpoint(path: str, trainer, extra: Optional[Dict[str, Any]] = None) -> None:
    """Flush ``trainer``'s embedding and write its checkpoint to ``path``
    (on a mesh every rank calls it)."""
    os.makedirs(path, exist_ok=True)
    embed = trainer.embed
    embed.flush()
    mesh = getattr(embed, "mesh", None)
    if mesh is None:
        table_kind = _save_table(path, embed)
    else:
        table_kind = _save_columns(path, embed)
        if mesh.rank != 0:  # the dense weights, accumulators and meta are replicated
            return
    params = _model_module(trainer).params_to_jax(trainer.model)
    np.savez(os.path.join(path, "dense_params.npz"), **_flatten(params))
    if getattr(embed, "host_accum", None) is not None:
        st = embed.host_accum.save_state()
        if st["kind"] == "dense":
            np.save(os.path.join(path, "accum.npy"), st["arr"])
        else:
            np.savez(os.path.join(path, "accum.npz"), rows=st["rows"], vals=st["vals"])
    meta = {
        "format_version": FORMAT_VERSION,
        "step": trainer._step_idx,
        "optimizer": embed.optimizer,
        "table_kind": table_kind,
        "num_embeddings": embed.num_embeddings,
        "embedding_dim": embed.embedding_dim,
    }
    meta.update(extra or {})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str, trainer) -> int:
    """Restore a checkpoint (this package's or the JAX package's) into an
    already-built ``trainer`` of the same shapes. Returns the step counter."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    embed = trainer.embed
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['format_version']}, expected {FORMAT_VERSION}")
    if (meta["num_embeddings"], meta["embedding_dim"]) != (embed.num_embeddings, embed.embedding_dim):
        raise ValueError(f"checkpoint table {meta['num_embeddings']} x {meta['embedding_dim']}, trainer "
                         f"{embed.num_embeddings} x {embed.embedding_dim}")

    module = _model_module(trainer)
    flat = dict(np.load(os.path.join(path, "dense_params.npz")))
    params = _unflatten_like(module.params_to_jax(trainer.model), flat)
    with torch.no_grad():
        trainer.model.load_state_dict(module.params_from_jax(params))

    kind = meta["table_kind"]
    if isinstance(embed, FullyResidentEmbeddingBag):
        if kind != "dense":
            raise ValueError(f"a {kind!r} checkpoint table into the resident table")
        arr = np.load(os.path.join(path, "host_table.npy"), mmap_mode="r")
        for s in range(0, arr.shape[0], _ROWS_PER_COPY):
            rows = embed.to_device(np.array(arr[s : s + _ROWS_PER_COPY]))  # a writable copy
            embed.cache_weight[s : s + rows.shape[0]] = astype_storage(rows, embed.dtype)
        _load_accum(path, embed)
    else:
        ht = embed.host_table
        cols = slice(embed.col_start, embed.col_start + embed.dim_stored)  # a mesh rank's columns
        if kind == "dense":
            if not isinstance(ht, DenseHostTable):
                raise ValueError("a dense checkpoint table into a virtual host table")
            np.copyto(ht.array, np.load(os.path.join(path, "host_table.npy"), mmap_mode="r")[:, cols])
            ht.mark_all_written()  # restored values are arbitrary: no row holds its init
        else:
            if not isinstance(ht, VirtualHostTable):
                raise ValueError("a virtual checkpoint table into a dense host table")
            ov = np.load(os.path.join(path, "overlay.npz"))
            if ov["rows"].size:
                ht.scatter(ov["rows"], np.ascontiguousarray(ov["vals"][:, cols]))
        _load_accum(path, embed)  # before the cache warms, so that warm rows carry theirs
        embed.reset_cache()
    trainer._step_idx = meta["step"]
    return meta["step"]


def _load_accum(path: str, embed) -> None:
    """Row-wise Adagrad accumulators from ``accum.npy`` or ``accum.npz`` into
    an Adagrad embedding (its host store, or the resident table's device
    array); nothing for an SGD embedding."""
    if embed.cache_accum is None:
        return
    npy, npz = os.path.join(path, "accum.npy"), os.path.join(path, "accum.npz")
    if os.path.exists(npy):
        arr = np.load(npy, mmap_mode="r")
        if arr.shape != (embed.num_embeddings,):
            raise ValueError(f"checkpoint accumulators of shape {arr.shape}, table of {embed.num_embeddings} rows")
        if isinstance(embed, FullyResidentEmbeddingBag):
            embed.cache_accum.copy_(torch.from_numpy(np.array(arr)))
        elif isinstance(embed.host_accum, DenseAccumStore):
            np.copyto(embed.host_accum.arr, arr)
        else:
            raise ValueError("dense accumulators (accum.npy) into a virtual table's store")
    elif os.path.exists(npz):
        z = np.load(npz)
        if z["rows"].size:
            if isinstance(embed, FullyResidentEmbeddingBag):
                embed.cache_accum[torch.from_numpy(z["rows"]).to(embed.device)] = torch.from_numpy(
                    np.asarray(z["vals"], np.float32).reshape(-1)).to(embed.device)
            else:
                embed.host_accum.scatter(z["rows"], z["vals"])
