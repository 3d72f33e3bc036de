"""The system under test, as the benchmark builds, drives and reads it.

Everything here goes through ``cachedembedding_tpu_torch`` (the port): the
trainer, its cached or fully resident embedding, and the state that the
correctness check reads back (dense parameters and embedding rows) to judge
what the timed path produced. Nothing here computes a result of its own.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.cache.manager import CACHE_DTYPES
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

_READ_BLOCK = 1 << 16  # rows read back a call: bounds the device transient


def dlrm_config(config: dict, mix: dict, seed: int) -> DLRMConfig:
    """The port's ``DLRMConfig`` of a configuration file, with the mix's
    batch size and the table seed derived from ``seed`` (the port hashes
    its rows from the low 32 bits)."""
    return DLRMConfig(**config["dlrm"], batch_size=int(mix["batch_size"]), seed=int(seed) & 0xFFFFFFFF,
                      cache=CacheConfig(**config["cache"]))


def build_trainer(config: dict, cfg: DLRMConfig, freq: np.ndarray, device: torch.device) -> CachedDLRMTrainer:
    """The trainer of a configuration: a fully resident table
    (``FullyResidentEmbeddingBag``) or the cache with the stream's
    frequency map."""
    if config["embedding"] == "resident":
        embed = FullyResidentEmbeddingBag(
            cfg.total_num_embeddings, cfg.embedding_dim, table_sizes=cfg.num_embeddings_per_feature,
            seed=cfg.seed, dtype=CACHE_DTYPES[cfg.cache.cache_dtype], weight_init=cfg.cache.weight_init,
            device=device)
        return CachedDLRMTrainer(cfg, device=device, embed_override=embed)
    if config["embedding"] != "cached":
        raise ValueError(f"unknown embedding {config['embedding']!r}")
    return CachedDLRMTrainer(cfg, id_freq_map=freq, device=device)


def make_dense_params(shapes: Dict[str, tuple], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The dense model's initial weights, made on the device from ``seed``
    in one draw, in the order of ``shapes`` (the reference's
    ``dense_shapes``: name -> (shape, fan-in)): ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))`` for every weight and bias (``nn.Linear``'s default
    law)."""
    sizes = [math.prod(s) for s, _ in shapes.values()]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x2545F4914F6CDD1D + 0x5851F42D) & ((1 << 63) - 1))
    flat = torch.rand(sum(sizes), dtype=torch.float32, generator=g, device=device)
    out, at = {}, 0
    for (name, (shape, fan)), n in zip(shapes.items(), sizes):
        b = 1.0 / math.sqrt(fan)
        out[name] = (flat[at:at + n] * (2 * b) - b).reshape(shape)
        at += n
    return out


def load_dense(trainer: CachedDLRMTrainer, params: Dict[str, torch.Tensor]) -> None:
    """Put the benchmark's initial dense weights into the program's model."""
    sd = trainer.model.state_dict()
    if set(sd) != set(params):
        raise ValueError(f"the model's dense parameters {sorted(sd)} are not the benchmark's {sorted(params)}")
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(params[name])


def dense_state(trainer: CachedDLRMTrainer) -> Dict[str, torch.Tensor]:
    """The program's dense parameters, f32, on the host."""
    return {k: v.detach().float().cpu().clone() for k, v in trainer.model.state_dict().items()}


def storage_dtype(trainer: CachedDLRMTrainer) -> torch.dtype:
    return trainer.embed.cache_weight.dtype


def _rows_at(weight: torch.Tensor, addrs: np.ndarray) -> torch.Tensor:
    """``weight[addrs]`` widened to f32 on the host (1-byte rows through a
    uint8 view), in blocks."""
    out = []
    for s in range(0, addrs.shape[0], _READ_BLOCK):
        idx = torch.as_tensor(addrs[s:s + _READ_BLOCK], dtype=torch.int64, device=weight.device)
        if weight.element_size() == 1:
            blk = weight.view(torch.uint8).index_select(0, idx).view(weight.dtype)
        else:
            blk = weight.index_select(0, idx)
        out.append(blk.float().cpu())
    return torch.cat(out) if out else torch.zeros((0, weight.shape[1]))


def _homes(embed, ids: np.ndarray):
    """Where each global row of ``ids`` lives: its device address (resident
    region or cache slot; -1 where none) and the mask of the rows that only
    the host table holds. In-flight writebacks land first."""
    if isinstance(embed, FullyResidentEmbeddingBag):
        return ids.copy(), np.zeros(ids.shape[0], bool)
    embed._drain_writebacks()
    addr = np.full(ids.shape[0], -1, np.int64)
    table = np.searchsorted(embed._goff, ids, side="right") - 1
    res = embed._is_res_table[table]
    addr[res] = ids[res] + embed._res_delta[table[res]]
    slots, rows = embed.resident()
    order = np.argsort(rows, kind="stable")
    rows_sorted, slots_sorted = rows[order], slots[order]
    pos = np.minimum(np.searchsorted(rows_sorted, ids), max(rows_sorted.shape[0] - 1, 0))
    cached = ~res & (rows_sorted.shape[0] > 0) & (rows_sorted[pos] == ids) if rows_sorted.size else np.zeros_like(res)
    addr[cached] = slots_sorted[pos[cached]]
    return addr, addr < 0


def read_rows(trainer: CachedDLRMTrainer, ids: np.ndarray):
    """The program's current value of each global row in ``ids`` (f32, on
    the host), wherever it lives: the resident region, a cache slot, or
    the host table, and the mask of the rows read from the host table.
    In-flight writebacks land first. Reads change nothing."""
    embed = trainer.embed
    ids = np.asarray(ids, np.int64)
    addr, host = _homes(embed, ids)
    out = torch.empty((ids.shape[0], embed.cache_weight.shape[1]), dtype=torch.float32)
    dev = ~host
    if dev.any():
        out[torch.from_numpy(np.flatnonzero(dev))] = _rows_at(embed.cache_weight, addr[dev])
    if host.any():
        with embed._host_lock:
            vals = embed.host_table.gather(ids[host])
        out[torch.from_numpy(np.flatnonzero(host))] = torch.from_numpy(np.asarray(vals, np.float32))
    return out, host


def read_accum(trainer: CachedDLRMTrainer, ids: np.ndarray) -> Optional[torch.Tensor]:
    """Row-wise Adagrad's accumulator of each global row in ``ids`` (f32, on
    the host), wherever it lives: ``cache_accum`` at the row's device
    address, else the host accumulator store; None under SGD."""
    embed = trainer.embed
    if embed.cache_accum is None:
        return None
    ids = np.asarray(ids, np.int64)
    addr, host = _homes(embed, ids)
    out = torch.empty(ids.shape[0], dtype=torch.float32)
    dev = ~host
    if dev.any():
        idx = torch.as_tensor(addr[dev], device=embed.cache_accum.device)
        out[torch.from_numpy(np.flatnonzero(dev))] = embed.cache_accum.index_select(0, idx).cpu()
    if host.any():
        with embed._host_lock:
            vals = embed.host_accum.gather(ids[host])
        out[torch.from_numpy(np.flatnonzero(host))] = torch.from_numpy(np.asarray(vals, np.float32))
    return out


@contextlib.contextmanager
def update_grads(trainer: CachedDLRMTrainer, steps: int):
    """Record the grad rows that the trainer's embedding update is fed on
    the first ``steps`` steps, as f32 on the host; yields the list they go
    to. Uniform windows feed ``_update`` (or, under stochastic rounding,
    ``_sr_update``) a step's (N * F, D) grads of its gathered rows,
    example-major; ragged windows feed ``_ragged_update`` the flat (L, D)
    grads in the rows' dtype, in stream order (it may pass them on to
    ``_update``, which records nothing more)."""
    got: List[torch.Tensor] = []
    inside = [False]

    def wrap(name):
        f = getattr(trainer, name)

        def recorded(cw, g_rows, *a, **k):
            if inside[0]:
                return f(cw, g_rows, *a, **k)
            if len(got) < steps:
                got.append(g_rows.detach().float().cpu())
            inside[0] = True
            try:
                return f(cw, g_rows, *a, **k)
            finally:
                inside[0] = False

        return recorded

    names = ("_update", "_sr_update", "_ragged_update")
    for n in names:
        setattr(trainer, n, wrap(n))
    try:
        yield got
    finally:
        for n in names:
            delattr(trainer, n)
