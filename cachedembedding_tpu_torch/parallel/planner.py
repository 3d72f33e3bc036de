"""Automatic embedding sharding planner (counterpart of
``cachedembedding_tpu/parallel/planner.py``, numpy only): the analog of
torchrec's ``EmbeddingShardingPlanner`` and ``Topology`` cost model that the
baseline command line prints and executes (``baselines/dlrm_main.py``).

  * sharding types: REPLICATED (small tables on every device), TABLE_WISE
    (greedy bin-packing of whole tables), COLUMN_WISE (the embedding dim
    split across the devices), ROW_WISE (row ranges split across them), and
    the hierarchical TABLE_ROW_WISE / TABLE_COLUMN_WISE (one host group's
    devices only);
  * kernels: HBM_FULL (the whole table resident in device memory) and
    CACHED (the host-DRAM master with a hot-row device cache);
  * the cost model scores device bytes, per-step lookup traffic, expected
    cache misses (from the id frequency map when given) and collective
    bytes, assigns each table a sharding and, when the devices' memory
    budget is exceeded, demotes the largest tables to CACHED with a cache
    ratio sized to fit.

The planner is pure (no device state); ``Plan.pretty()`` prints the
torchrec-style placement table. The JAX package's copy describes a TPU v5e;
``Topology``'s defaults here describe an H100 80GB.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

import numpy as np


class ShardingType(enum.Enum):
    REPLICATED = "replicated"
    TABLE_WISE = "table_wise"
    COLUMN_WISE = "column_wise"
    ROW_WISE = "row_wise"
    # hierarchical (torchrec table_row_wise / table_column_wise): the whole
    # table is assigned to ONE host group and sharded row/column-wise across
    # only that group's devices, so its collectives stay on the group's local
    # links instead of crossing hosts.
    TABLE_ROW_WISE = "table_row_wise"
    TABLE_COLUMN_WISE = "table_column_wise"


class Kernel(enum.Enum):
    HBM_FULL = "hbm_full"
    CACHED = "cached"


@dataclasses.dataclass
class Topology:
    """Fleet description (torchrec's ``Topology(hbm_cap, ddr_cap)`` analog)."""

    num_devices: int = 1
    hbm_bytes_per_device: int = 80 << 30        # H100 80GB
    host_dram_bytes: int = 256 << 30            # host DRAM a card: a DGX H100's 2 TiB over 8 cards
    hbm_budget_fraction: float = 0.6            # leave room for dense + activations
    ici_bytes_per_s: float = 450e9              # NVLink 4, one direction a card (nameplate figure);
    # read only with more than one device
    host_link_bytes_per_s: float = 53.69e9      # a pinned 256 MB host-to-device copy on an H100
    # 80GB HBM3 at 700 W (chip_smoke.py's measure_host_link)
    devices_per_host: int = 0                   # 0 = all devices on one host;
    # >0 enables the hierarchical table_row/table_column placements (shards
    # confined to one host group so their collectives stay on its links)

    @property
    def hbm_budget(self) -> int:
        return int(self.hbm_bytes_per_device * self.hbm_budget_fraction)

    @property
    def group_size(self) -> int:
        return self.devices_per_host or self.num_devices


@dataclasses.dataclass
class TableSpec:
    name: str
    num_embeddings: int
    embedding_dim: int
    pooling_factor: float = 1.0        # avg ids per sample
    weight_dtype_bytes: int = 2        # bf16 storage (framework default)
    hot_fraction: Optional[float] = None  # fraction of ids covering 95% of
    # lookups (from the id freq map); informs cache sizing

    @property
    def bytes(self) -> int:
        return self.num_embeddings * self.embedding_dim * self.weight_dtype_bytes


@dataclasses.dataclass
class TablePlan:
    spec: TableSpec
    sharding: ShardingType
    kernel: Kernel
    devices: List[int]                  # owning device(s)
    cache_ratio: float = 1.0            # CACHED only
    hbm_bytes_per_device: int = 0
    host_bytes: int = 0
    comm_bytes_per_sample: int = 0      # collective bytes this table adds per sample


@dataclasses.dataclass
class Plan:
    tables: List[TablePlan]
    topology: Topology
    batch_size: int

    def hbm_per_device(self) -> np.ndarray:
        out = np.zeros(self.topology.num_devices, np.int64)
        for tp in self.tables:
            for d in tp.devices:
                out[d] += tp.hbm_bytes_per_device
        return out

    def host_bytes_total(self) -> int:
        return sum(tp.host_bytes for tp in self.tables)

    def by_kernel(self, kernel: Kernel) -> List[TablePlan]:
        return [tp for tp in self.tables if tp.kernel is kernel]

    def pretty(self) -> str:
        gib = 1 << 30
        lines = [
            f"EmbeddingShardingPlan  devices={self.topology.num_devices} "
            f"hbm_budget={self.topology.hbm_budget / gib:.1f}GiB/dev "
            f"batch={self.batch_size}",
            f"{'table':<14}{'rows':>12}{'dim':>6}{'sharding':>19}{'kernel':>10}"
            f"{'devices':>12}{'cache%':>8}{'HBM/dev':>10}{'host':>10}",
        ]
        for tp in self.tables:
            devs = (
                "all" if len(tp.devices) == self.topology.num_devices
                else ",".join(map(str, tp.devices[:4]))
                + ("…" if len(tp.devices) > 4 else "")
            )
            lines.append(
                f"{tp.spec.name:<14}{tp.spec.num_embeddings:>12}"
                f"{tp.spec.embedding_dim:>6}{tp.sharding.value:>19}"
                f"{tp.kernel.value:>10}{devs:>12}"
                f"{tp.cache_ratio * 100:>7.1f}%"
                f"{tp.hbm_bytes_per_device / gib:>9.2f}G"
                f"{tp.host_bytes / gib:>9.2f}G"
            )
        per_dev = self.hbm_per_device()
        lines.append(
            f"HBM/device: min={per_dev.min() / gib:.2f}G max={per_dev.max() / gib:.2f}G; "
            f"host DRAM: {self.host_bytes_total() / gib:.2f}G"
        )
        return "\n".join(lines)


REPLICATE_THRESHOLD_BYTES = 4 << 20   # tables smaller than this live everywhere


class EmbeddingShardingPlanner:
    """Greedy size-then-balance planner (torchrec's planner is a cost-model
    partitioner over the same axes; this keeps its observable contract —
    per-table placements that fit memory and balance load — with a direct
    algorithm instead of a solver)."""

    def __init__(self, topology: Topology):
        self.topology = topology

    def plan(
        self,
        tables: Sequence[TableSpec],
        batch_size: int,
        *,
        force_kernel: Optional[Kernel] = None,
        force_sharding: Optional[ShardingType] = None,
        default_cache_ratio: float = 0.01,
    ) -> Plan:
        topo = self.topology
        ndev = topo.num_devices
        if topo.devices_per_host and (
            topo.devices_per_host > ndev or ndev % topo.devices_per_host
        ):
            raise ValueError(
                f"devices_per_host={topo.devices_per_host} must divide "
                f"num_devices={ndev} (host groups are contiguous equal slices)"
            )
        load = np.zeros(ndev, np.int64)  # HBM bytes per device
        plans: Dict[str, TablePlan] = {}

        def place_replicated(spec: TableSpec) -> TablePlan:
            load[:] += spec.bytes
            return TablePlan(
                spec=spec, sharding=ShardingType.REPLICATED, kernel=Kernel.HBM_FULL,
                devices=list(range(ndev)), hbm_bytes_per_device=spec.bytes,
            )

        def place_table_wise(spec: TableSpec, kernel: Kernel, cache_ratio: float) -> TablePlan:
            d = int(np.argmin(load))
            if kernel is Kernel.HBM_FULL:
                hbm = spec.bytes
                host = 0
            else:
                hbm = int(spec.bytes * cache_ratio)
                host = spec.num_embeddings * spec.embedding_dim * 4  # f32 master
            load[d] += hbm
            # owner consumes the global batch's ids for this table and returns
            # pooled embeddings to every peer: B * D * dtype bytes over the links
            comm = spec.embedding_dim * spec.weight_dtype_bytes if ndev > 1 else 0
            return TablePlan(
                spec=spec, sharding=ShardingType.TABLE_WISE, kernel=kernel,
                devices=[d], cache_ratio=cache_ratio if kernel is Kernel.CACHED else 1.0,
                hbm_bytes_per_device=hbm, host_bytes=host, comm_bytes_per_sample=comm,
            )

        def place_sharded(
            spec: TableSpec, sharding: ShardingType, kernel: Kernel, cache_ratio: float
        ) -> TablePlan:
            if kernel is Kernel.HBM_FULL:
                hbm = (spec.bytes + ndev - 1) // ndev
                host = 0
            else:
                hbm = int(spec.bytes * cache_ratio) // ndev
                host = spec.num_embeddings * spec.embedding_dim * 4
            load[:] += hbm
            # column-wise: all-to-all reshard of pooled (B, D/w) shards;
            # row-wise: psum of (B, D) partials — ndev x the column volume
            comm = spec.embedding_dim * spec.weight_dtype_bytes
            if sharding is ShardingType.ROW_WISE:
                comm *= 2
            return TablePlan(
                spec=spec, sharding=sharding, kernel=kernel,
                devices=list(range(ndev)),
                cache_ratio=cache_ratio if kernel is Kernel.CACHED else 1.0,
                hbm_bytes_per_device=hbm, host_bytes=host,
                comm_bytes_per_sample=comm if ndev > 1 else 0,
            )

        def place_host_group(
            spec: TableSpec, sharding: ShardingType, kernel: Kernel, cache_ratio: float
        ) -> TablePlan:
            """table_row_wise / table_column_wise: shard across the devices of
            the least-loaded HOST GROUP only — the collective (psum of row
            partials / all-to-all of column shards) stays on that group's
            local links; distribution to peers costs the same as table-wise."""
            gs = topo.group_size
            groups = ndev // gs
            gloads = load.reshape(groups, gs).sum(axis=1)
            g = int(np.argmin(gloads))
            devs = list(range(g * gs, (g + 1) * gs))
            if kernel is Kernel.HBM_FULL:
                hbm = (spec.bytes + gs - 1) // gs
                host = 0
            else:
                hbm = int(spec.bytes * cache_ratio) // gs
                host = spec.num_embeddings * spec.embedding_dim * 4
            for d in devs:
                load[d] += hbm
            comm = spec.embedding_dim * spec.weight_dtype_bytes
            if sharding is ShardingType.TABLE_ROW_WISE:
                comm *= 2
            return TablePlan(
                spec=spec, sharding=sharding, kernel=kernel, devices=devs,
                cache_ratio=cache_ratio if kernel is Kernel.CACHED else 1.0,
                hbm_bytes_per_device=hbm, host_bytes=host,
                comm_bytes_per_sample=comm if ndev > 1 else 0,
            )

        hier = 0 < topo.devices_per_host < ndev  # multi-host topology
        gs = topo.group_size

        # ---- pass 1: place, biggest first --------------------------------
        order = sorted(tables, key=lambda s: -s.bytes)
        for spec in order:
            kernel = force_kernel or Kernel.HBM_FULL
            if force_sharding is not None:
                sharding = force_sharding
            elif spec.bytes <= REPLICATE_THRESHOLD_BYTES and kernel is Kernel.HBM_FULL:
                sharding = ShardingType.REPLICATED
            elif spec.bytes <= topo.hbm_budget // 4:
                sharding = ShardingType.TABLE_WISE
            elif hier and spec.bytes <= (topo.hbm_budget // 4) * gs:
                # fits one host group: keep its collective off the inter-host links
                sharding = (
                    ShardingType.TABLE_COLUMN_WISE
                    if spec.embedding_dim % gs == 0
                    else ShardingType.TABLE_ROW_WISE
                )
            elif spec.embedding_dim % ndev == 0 and ndev > 1:
                sharding = ShardingType.COLUMN_WISE
            else:
                sharding = ShardingType.ROW_WISE if ndev > 1 else ShardingType.TABLE_WISE
            if sharding is ShardingType.REPLICATED:
                plans[spec.name] = place_replicated(spec)
            elif sharding is ShardingType.TABLE_WISE:
                plans[spec.name] = place_table_wise(spec, kernel, default_cache_ratio)
            elif sharding in (
                ShardingType.TABLE_ROW_WISE, ShardingType.TABLE_COLUMN_WISE
            ):
                plans[spec.name] = place_host_group(
                    spec, sharding, kernel, default_cache_ratio
                )
            else:
                plans[spec.name] = place_sharded(spec, sharding, kernel, default_cache_ratio)

        # ---- pass 2: demote to CACHED until the HBM budget fits -----------
        # (this is the planner outcome that defines the framework: tables that
        # do not fit become host-resident with an HBM hot-row cache)
        if force_kernel is None:
            for spec in order:  # biggest (least HBM-worthy per byte) first
                if load.max() <= topo.hbm_budget:
                    break
                tp = plans[spec.name]
                if tp.kernel is Kernel.CACHED or tp.sharding is ShardingType.REPLICATED:
                    continue
                for d in tp.devices:
                    load[d] -= tp.hbm_bytes_per_device
                ratio = default_cache_ratio
                if spec.hot_fraction is not None:
                    ratio = float(np.clip(spec.hot_fraction, default_cache_ratio, 0.5))
                if tp.sharding is ShardingType.TABLE_WISE:
                    plans[spec.name] = place_table_wise(spec, Kernel.CACHED, ratio)
                elif tp.sharding in (
                    ShardingType.TABLE_ROW_WISE, ShardingType.TABLE_COLUMN_WISE
                ):
                    plans[spec.name] = place_host_group(
                        spec, tp.sharding, Kernel.CACHED, ratio
                    )
                else:
                    plans[spec.name] = place_sharded(spec, tp.sharding, Kernel.CACHED, ratio)

        if load.max() > topo.hbm_budget:
            raise ValueError(
                f"plan does not fit: {load.max() / (1 << 30):.1f} GiB on the fullest "
                f"device exceeds the {topo.hbm_budget / (1 << 30):.1f} GiB budget "
                f"even with caching — lower cache ratios or add devices"
            )
        host_total = sum(tp.host_bytes for tp in plans.values())
        if host_total > topo.host_dram_bytes:
            raise ValueError(
                f"host tables need {host_total / (1 << 30):.1f} GiB > "
                f"{topo.host_dram_bytes / (1 << 30):.1f} GiB host DRAM"
            )
        # keep input order
        return Plan(
            tables=[plans[s.name] for s in tables],
            topology=topo,
            batch_size=batch_size,
        )


def specs_from_sizes(
    table_sizes: Sequence[int],
    embedding_dim: int,
    id_freq_map: Optional[np.ndarray] = None,
    weight_dtype_bytes: int = 2,
) -> List[TableSpec]:
    """Build TableSpecs from the fused-id-space layout the datasets use,
    deriving per-table hot fractions from the dataset id-frequency map."""
    specs = []
    off = 0
    for i, n in enumerate(table_sizes):
        hot = None
        if id_freq_map is not None:
            freq = np.sort(id_freq_map[off : off + n])[::-1]
            total = freq.sum()
            if total > 0:
                cum = np.cumsum(freq)
                hot = float(np.searchsorted(cum, 0.95 * total) + 1) / n
        specs.append(
            TableSpec(
                name=f"t{i}", num_embeddings=int(n), embedding_dim=embedding_dim,
                hot_fraction=hot, weight_dtype_bytes=weight_dtype_bytes,
            )
        )
        off += n
    return specs
