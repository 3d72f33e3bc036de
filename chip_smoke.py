#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cachedembedding_tpu_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel5-against SOURCE.cu
    python3 chip_smoke.py --kernel23-against DIR [DIR ...]
    python3 chip_smoke.py --fp8-windows
    python3 chip_smoke.py --bench [kaggle fp8 sparse terabyte avazu]
    python3 chip_smoke.py --tablewise-worlds 1,4     (four cards)
    python3 chip_smoke.py --rowwise-worlds 1,4       (four cards)

Needs one CUDA GPU (an H100 is the target) and the checkout around this file;
it imports torch, numpy and the port, nothing of JAX. Phases:

  1. Build: the host C++ library (g++) and each CUDA kernel (nvcc, sm_90a),
     all started together, from the sources in the checkout into
     ``cachedembedding_tpu_torch/build/``.
  2. Reference: nineteen small slices (REFERENCE_SLICES), each trained 24
     steps and evaluated on the card and on the CPU (the kernels' plain
     versions) from the same seed, through a cache that evicts trained rows
     and admits them again (which holds the writeback ordering to account),
     f32 compute; the card's run must launch its update kernels once a step
     and no other. The uniform ones (a-f, and l) take 4 tables of 50-20,000
     rows, batch 256, a 480-slot cache; the ragged ones (g-k) the
     fbgemm-trace replayer on tests/test_ragged_window.py's shape (3 tables
     of 500 rows, bags of 0-5 ids, batch 64, a 750-slot cache):
       a. f32 rows (Kernels 1, 2): cache counts equal; losses, AUROC and
          dense weights within f32 order; the flushed rows of every id the
          training stream touched within 1e-5;
       b. float8_e4m3fn rows with stochastic rounding (Kernels 1, 3, 4;
          kernel and plain version draw the same Philox bits): counts equal;
          losses within rtol 1e-3; at least 99.9% of the flushed elements
          equal and every one within 2 e4m3 steps (the f32 GEMMs sum in
          another order on the card, which can flip a rounding);
       c. row-wise Adagrad on f32 rows (Kernel 2's Adagrad epilogue), at
          learning rate 0.1: the gates of (a), and the flushed accumulators
          within rtol 1e-4;
       d. the sparse-gradient branch on bf16 rows (use_sparse_embed_grad,
          no sort plans shipped; the ordered scatter): the gates of (b) in
          bf16 steps (both devices add the same addends in the same order;
          an f32 GEMM difference can flip a grad's bf16 rounding);
       e. float8_e4m3fn rows with rounding off (Kernel 2 on fp8 grads) and
       f. float8_e5m2 rows with rounding on (Kernels 3, 4): the gates of (b)
          in steps of the rows' dtype;
       g. ragged, bf16 rows (the dense ragged branch: Kernel 5's
          ordered_grad_update), h. ragged, row-wise Adagrad on f32 rows
          (its Adagrad epilogue; the gates of (c)), i. ragged, the sparse
          branch on bf16 rows (the ordered scatter), j. ragged,
          float8_e4m3fn rows with rounding on (which ragged windows ignore:
          ordered_grad_update and no rounding kernel), k. ragged, mean mode:
          the gates of (b) in steps of the rows' dtype;
       l. bf16 rows with DLRM's gather interaction (Kernel 2): the gates
          of (b) in bf16 steps;
       m.-s. the window wire (train/wire.py) on bf16 rows unless named:
          int8 and int4 dense inputs, int8 admit payloads on f32 rows
          (the gates of (a)), int4 payloads, and the plain, escape and
          rank-tier id wires with their learning shortened (2 windows;
          1 skipped and 3 learned), whose last window must ship the frozen
          format: the gates of (b) in bf16 steps.
  3. The bf16 slice: bench.py's headline configuration (Criteo-Kaggle
     tables, D=128, batch 16,384, 1% cache, prefetch 8, bf16 rows and
     compute, resident tables <= 500k rows) with ship_sort_perm and the
     gather lookup on: build the trainer, train 3 windows (24 steps),
     evaluate 1 window, flush, and check flushed rows against the cache rows
     they came from. Kernel launch counts are zeroed just before and read
     just after. Then one more training window under torch.profiler: the
     device's busy time, the idle share of its span and its heaviest
     kernels.
  4. Kernels 1 and 2 against their plain versions on the bf16 slice's first
     training step (its device addresses and row-sorted plan, 26 x 16,384
     ids into 901,228 x 128 bf16 rows): the row gather must equal
     index_select bit for bit; the fused binned SGD update must leave
     untouched rows bit-equal, keep touched rows within one bf16 ulp of the
     plain version, and give identical bits on two launches, with the gate
     shown to reject a planted fault (the heaviest row's sum without one
     chunk of ROW_CHUNK addends).
  5. The fp8 slice: the same configuration with float8_e4m3fn rows
     (stochastic rounding on), 24 steps, 1 evaluation window and a flush
     checked as in phase 3; its own launch counts; the device memory peak
     also read just before and after the first step's update (its inputs,
     which phase 6 reads, are kept in pinned host memory).
  6. Kernels 1, 2, 3 and 4 on the fp8 slice's first training step (its ids,
     plan and row grads, and the cache rows before its update): the gather
     of 128-byte fp8 rows equal to index_select bit for bit (uint8 view);
     the binned scatter-add, and its plain version, each within 1e-5 of the
     sum of |g| of every element's addends from a float64 index_add_,
     untouched rows exactly 0, identical bits on two launches, and the gate
     shown to reject four planted faults (all zeros, every second addend
     dropped, the heaviest bin skipped, the heaviest row without one chunk);
     the same gates on the step's f32 grads; Kernels 2 and 3 on the same
     plan through their one-element-a-lane path (D = 18, and D = 128 with the
     grads one element off 16-byte alignment), under the same gates;
     Kernel 4 bit-equal to its plain version for float8_e4m3fn, bf16 and
     float8_e5m2: on that step's cw - slr * g, on every one of the 2^32 f32
     bit patterns (2^28 a launch, a seed each), and, with a second seed, on
     n % 16 != 0 with every special value and inputs 4 bytes off 16-byte
     alignment; its fused entry (stochastic_sgd_round_, which the fp8
     slice's update calls) bit-equal to the unfused chain (cw.float(),
     torch.sub, the plain rounding) on the step's rows and grad as e4m3fn
     and bf16 rows, at the step's slr and at 0.37, and on the ragged,
     misaligned case; the gate shown to reject two planted faults (u <= p in
     place of u < p, the Philox stream shifted by one word) on an input that
     puts p on u for one element in 16; Kernel 2 on float8_e4m3fn and
     float8_e5m2 rows, with f32 grads and with grads in the rows' dtype
     (``check_kernel2_fp8_rows``); Kernel 2 as a narrowing test
     (``check_fp8_narrowing``): rows of +0, one contributor each, slr = -1,
     so every one of the 2^32 f32 bit patterns is written as
     round(x), equal to ops/rounding.astype_storage for float8_e4m3fn and
     float8_e5m2 (NaN payloads apart; -0 becomes +0), with a planted fault
     (the saturating cast alone) rejected. Then one training window each of
     float8_e4m3fn rows with rounding off and float8_e5m2 rows with
     rounding on, at the slice's width, with their own launch counts, and
     uncounted a second window of each and a first window of a new e5m2
     trainer (``phase_fp8_windows``: start-up against the steady window).
  6b. The window wire at full width (``wire``, ``phase_wire``): the bf16
     slice's configuration on one trainer with bench.py's wires: int8 dense
     features and the escape id wire for 16 windows (it freezes after 12),
     the rank-tier wire for 28 (it freezes after 24), then 2 windows each of
     int4 dense features and the plain wire; Kernels 1 and 2 once a step;
     the frozen windows in the frozen format; the last window of each run
     decoded on the card bit-equal to the host's ids, dense features and
     labels, with a flipped id byte rejected; the flush. It prints per run
     the bytes a window by block (beside raw int32 ids and bf16 features),
     the encoder's host ms, the buffer copy's device ms, host and device s
     a window and examples/s over the frozen windows. Then int8 and int4
     admit payloads on the card at phase 2's width
     (``check_quantized_admits``): one window's fetched rows equal the
     dequantized host quantization cast to the rows' dtype, bit for bit,
     and rows written back hold bf16 values in the f32 host table.
  6c. The device planner at full width (``device_planner``,
     ``phase_device_planner``): the bf16 slice's model with
     ``planner="device"`` and every Kaggle table cached, data through
     ``data/dispatch.get_dataloader("custom", ..., prefetch_depth=2)``, the
     training timed by ``utils/timer.Timer``; the cache ratio the smallest
     of 1%, 2% and 5% that holds each window's distinct ids, counted on the
     host. Two runs of 3 windows and an evaluation window (planned batch by
     batch, as JAX does): DATASET eviction on the dense branch (Kernel 2 fed
     by the update plans made on the card) and LFU with
     use_sparse_embed_grad on the sparse branch (Kernel 5). Gates: each
     window's ``plan_ids`` on the card bit-equal to the same function on CPU
     copies of the state and ids (the new state's three arrays, the plan's
     indices and scalars), each step's update plan bit-equal to
     ``sort_plan_np`` of its ids read back, the update entry once a step and
     no other, finite losses, a hit rate in (0, 1], the flush; then
     ``plan_ids`` under eviction with tied frequencies, card against CPU
     (``check_plan_ties``: the runs' 1% cache evicts nothing in 3 windows),
     and on a small bag an out-of-range id (ValueError) and an overfull
     window (a RuntimeError naming the capacity). It prints per run host
     and device s a window, ``plan_ids`` device ms a window, the plan's
     readback bytes, device ms and host wait, the update plan's device ms a
     step, examples/s and peak memory, beside the bf16 slice's host-planner
     numbers from the same call.
  7. The bare module on the card: a CachedEmbeddingBag with fp8 rows,
     prepare_ids then lookup over seeded ids that together exceed its
     capacity, equal to the host rows through the storage cast, pooled.
  8. Kernels 2 and 3 and both of Kernel 5's entries refuse a plan grouped by
     bin but not sorted by id (the JAX package's layout): each, in a child
     process started after the build, must stop with a device-side assert.
     Meanwhile Kernel 5 runs its run-shape cases (``check_ordered_run_cases``:
     runs on the edges of its heavy-run ring, every row dtype and entry, four
     and one elements a lane), bit-equal to its plain version.
  9. The sparse-gradient branch at Criteo-1TB width (``1tb sparse``,
     ``phase_terabyte``): terabyte.sh's configuration (26 tables,
     177,944,275 rows, a 1% cache of 1,779,442 bf16 rows, more than 4x a
     step's 425,984 ids) on a virtual host table, 24 steps, one evaluation
     window and a flush; the ordered scatter launched once a step and no
     other update kernel; then the ordered scatter on the first step
     (``check_ordered_scatter``).
  10. The ragged path at full width (``ragged``, ``phase_ragged``): DLRM at
     the bf16 slice's widths and tables on the fbgemm-trace replayer over
     generated pools of 262,144 bags a table (bag lengths uniform in
     [0, 8), ids rows * u**2), about 1.49M ids a step, so Vp = 2,097,152;
     a cache of 10% (3,319,328 slots: 5% would be fewer than a window's
     2.09M distinct cached ids) plus the 569,296 resident rows, under 4 Vp:
     the dense ragged branch. 24 steps, one evaluation window and a flush;
     Kernel 1 and ordered_grad_update launched once a step and no other
     update entry; then Kernel 1 on the first step (bit-equal to
     index_select) and ordered_grad_update (``check_ordered_grad_update``:
     bit-equal to its plain version and across launches, untouched rows
     unchanged, four planted faults rejected on the heaviest run into a zero
     row: an addend dropped, two swapped, a stage of the ring skipped, two
     stages swapped).
  11. The command line (``cli``): a Criteo-Kaggle-format dataset written
     under ``cachedembedding_tpu_torch/build/`` (24 training and 4 val/test
     batches of 16,384 rows; long-tail raw values that ``% hash`` spreads
     over the Kaggle tables; learnable labels), then the users' command,
     ``python -m cachedembedding_tpu_torch.train.dlrm_main``, each run its
     own process, at full Criteo-Kaggle width (26 tables, 33,762,577 rows,
     D=128) with ``scripts/kaggle.sh``'s flags, 24 steps and 2 + 2
     evaluation batches: ``cli cached`` (bf16 cache rows), ``cli
     resident`` (no --use_cache: the 17.29 GB f32 table on the card) and
     ``cli deepfm`` (at --learning_rate 0.1), ``cli adagrad`` and ``cli
     adagrad resident`` (``--embedding_optimizer rowwise_adagrad
     --learning_rate 0.1``, cached bf16 rows and the resident table with
     its 135 MB of accumulators), ``cli int8`` and ``cli int4``
     (``--transfer_dtype``: quantized admit payloads, bf16 writebacks) and
     ``cli device`` (``--planner device``: plans on the card). Each must give finite losses, val/test
     AUROC above 0.5 over 32,768 examples, a hit rate in (0, 1] where it
     caches, Kernel 1 launches and one Kernel 2 launch a step (its Adagrad
     epilogue under Adagrad) and no other; the Adagrad runs accumulators
     above 0 on the card and, cached, written back to the host store on
     eviction, with a hit rate below 1; the first computes id_freq_map.npy
     and the others read it. Then Kernel 1, Kernel 2 and its Adagrad
     epilogue on the resident table's first training step, in this process
     (gates in ``check_resident_kernels`` and ``check_resident_adagrad``),
     and on ``cli adagrad``'s cached step (bf16 rows, ``check_cached_adagrad``),
     and checkpoint round trips on small tables, SGD and Adagrad
     (``check_checkpoint_round_trip``). Then the baseline command line,
     ``python -m cachedembedding_tpu_torch.baselines.dlrm_main``, on the
     same dataset (``phase_baseline``, BASELINE_RUNS): ``--plan_only`` (the
     plan printed, nothing trained), ``--kernel hbm`` (the 17.29 GB f32
     table) and ``--kernel auto --hbm_gb 8`` (24 tables resident in one
     mixed bag, the two largest cached): finite losses, val AUROC above 0.5,
     Kernels 1 and 2 launched (the sparse branch of f32 rows), and the mixed
     bag's resident tables the plan's HBM_FULL tables.
  12. The column-wise mesh (``mesh``, ``phase_mesh``: ``chip_smoke.py
     --mesh`` in its own process, ``mesh_child``): a mesh of one rank over
     NCCL trains the bf16 slice's configuration (without shipped plans, as
     JAX ships none to a mesh) beside the one-card trainer on the same
     data: 3 windows on the dense branch (Kernels 1, 2), 1 with
     use_sparse_embed_grad (Kernel 5), 1 of float8_e4m3fn rows with
     stochastic rounding (Kernels 3, 4), each with one evaluation window and
     a flush. Losses, flushed rows and AUROC bit-equal to the one-card run,
     each update kernel launched once a step and no other, a hit rate in
     (0, 1]; then ``--world_size 2`` on one visible card raises. Last, a
     pinned 256 MB host-to-device copy (``measure_host_link``), the sharding
     planner's ``Topology.host_link_bytes_per_s``.
  13. The table-wise layout (``tablewise``, ``phase_tablewise``: ``chip_smoke.py
     --tablewise DATA_DIR`` in its own process, ``tablewise_child``, run by
     the CLI phase on its dataset): a mesh of one rank over NCCL. The users'
     command with ``--use_tablewise`` (``CLI_FLAGS``: Kaggle's 26 tables,
     368,774 f32 cache rows from ``min(int(0.01 n) + 2000, n)`` a table plus
     the pad slot, a 17.29 GB host table) in this process: 24 steps (3
     windows of 8) and 2 + 2 evaluation batches; finite losses, a hit rate in
     (0, 1], val and test AUROC above 0.5, Kernel 1 launched once a training
     and once an evaluation step and Kernel 2 once a training step, no other
     update kernel; then the flush: 65,536 sampled cached rows read from the
     cache equal in the host table after it, some of them trained. Its losses
     beside ``cli resident``'s, with no gate: at these flags the JAX
     package's two runs differ too (the resident trainer ships dense inputs
     in bf16, the table-wise step takes them in f32), and with f32 dense
     inputs they are equal (``tests/test_torch_cli.py::
     test_tablewise_against_the_resident_run``). Then a small table-wise case
     (TABLEWISE_SLICE) and three ``hybrid_train_step`` steps with each fused
     op on the card against the same on the CPU (the gates in
     ``tablewise_child``'s docstring), and ``dryrun_hybrid_train_step(1)``.
  14. The row-sharded cached layout (``rowwise``, ``phase_rowwise``:
     ``chip_smoke.py --rowwise DATA_DIR`` in its own process,
     ``rowwise_child``, run by the CLI phase on its dataset after the
     table-wise phase): the users' command with ``--use_rowwise`` in this
     process, a mesh of one rank over NCCL (``CLI_FLAGS``: Kaggle's 26
     tables, one shard of 33,762,577 rows, 337,625 f32 cache rows from
     ``int(0.01 per)``, the 17.29 GB f32 host table): 24 steps (3 windows of
     8) and 2 + 2 evaluation batches; finite losses, a hit rate in (0, 1],
     val and test AUROC above 0.5, Kernel 1 once a training and an
     evaluation step and Kernel 2 once a training step, no other update
     kernel; the flush gate of phase 13. Then Kernels 1 and 2 against their
     plain versions on a row-wise step's 425,984 owner lanes
     (``check_rowwise_kernels``). Then the same run as the one rank of
     ``--multihost --coordinator_address 127.0.0.1:PORT --num_processes 1
     --process_id 0`` (``dlrm_main._rank_main``, what the command starts for
     its rank; it joins over TCP): the same losses, AUROC and flushed
     sample, bit for bit. Then a small row-wise case (ROWWISE_SLICE, the
     JAX tests' shapes) through ``parallel/row_cached``'s bag, its steps
     and windows and ``parallel/row``'s lookup, on the card against the CPU
     (the gates in ``rowwise_child``'s docstring).
  15. The headline bench (``bench``, ``phase_bench``): ``python3 -m
     cachedembedding_tpu_torch.bench`` at its kaggle defaults in its own
     process (Criteo-Kaggle tables, batch 16,384, a 1% cache of bf16 rows,
     tables of at most 500k rows resident, prefetch 8; 416 warmup
     iterations, then 12 timed segments of 48). Gates: one stdout line with
     the metric ``dlrm_kaggle_cached_train_throughput`` and a positive,
     finite value; the chosen segment wrote evicted rows back; its hit rate
     in (0, 1]; the peak device memory under 4 GiB; Kernels 1 and 2
     launched once a timed step and no other update kernel. Its stderr from the segments on is logged,
     and its ``bench summary`` goes into the second JSON line.

Phases 4 and 6 time each kernel beside its bound, its plain version and a
PyTorch yardstick: ``ms`` is the median of calls each timed alone by CUDA
events and synchronized, so a call faster than its wrapper's host work reads
as that host time; ``device_ms`` is the median of calls enqueued back to back
behind a device-side sleep, device time only. The binned kernels are also
timed on the light part of their step alone (the ids of bins of at most 1,024
ids), split by CUDA launch (``torch.profiler``), with the step's heaviest
row, its runs that cross chunks, and the host time of its plan
(``sort_plan_np``). Kernel 4's entry holds its fused entry's times beside
their own bound and the device time of the unfused chain it replaced.
Phase 5 counts both of Kernel 4's entries: the fused one 24 times on the
fp8 slice, neither on the bf16 slice; the kernels line gives their sum, and
each kernel's launches on every path (the two slices, the two fp8 windows,
the wire and device-planner runs, the 1TB run, the ragged path and the CLI
runs, whose processes report their counts in their ``run stats`` line,
the baseline runs, the mesh's three runs summed, the table-wise run, the
row-wise run and the bench's timed segments).
Phase 11 adds Kernels 1 and 2's times on the resident table
(``on_resident_table``, ``adagrad_epilogue_on_resident_table``) and the
Adagrad epilogue's on ``cli adagrad``'s step
(``adagrad_epilogue_on_cli_adagrad_step``), phase 14
their times on a row-wise step (``on_rowwise_step``), phase 6
Kernel 2's on fp8 rows (``on_fp8_rows``) and its narrowing gate
(``fp8_narrowing``), phase 10 Kernel 1's on the ragged
step (``on_ragged_step``) and Kernel 5's dense ragged entry with its
heaviest run alone (the kernel's own numbers), and phase 9 Kernel 5's
scatter entry (``ordered_scatter_add_entry``). Each of Kernel 5's entries
also gives its ring's numbers on its step (``kernel5_design_numbers``): the
heavy runs the launch found (non-zero), the chain's ns an add by row dtype
in registers (``chain_latency_ns``) and the heaviest run's chain bound from
it, the entry's share of that bound beside its share of the bytes bound, the
entry's own ns an add with every contributor on one grad row (the ring's
pace), and the light part alone (the step without its heavy runs) beside
its bytes bound; the run-shape cases are under ``run_cases``. Each kernel's ``launches``
are its main path's (MAIN_PATH), summed over its entries where two wrappers
launch it (``launches_by_entry``: Kernel 2's two epilogues, Kernel 4's two
entries, Kernel 5's scatter and dense ragged update).
Prints per-phase results, then a ``{"wire": ..., "quantized_admits": ...,
"device_planner": ..., "fp8_windows": ...}`` line, a ``{"mesh": ..., "baseline": ...,
"host_link": ..., "bf16_slice": ..., "cli": ..., "tablewise": ..., "rowwise":
..., "bench": ...}`` line (the mesh, one-card, CLI, table-wise and row-wise
runs' host and device s a window, examples/s and peak memory beside the bf16
slice's, and the bench's summary), the card's name and
power limit, then a
``{"kernels": [...]}`` line, and as the last line ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that.

``--tablewise-worlds 1,4`` (``--rowwise-worlds 1,4``) runs the build, writes
the CLI phase's dataset and runs the command line with ``--use_tablewise``
(``--use_rowwise``) at each world size in turn (one card a rank: four cards
for 4), printing the card, then one JSON line of each run's losses, AUROC,
host and device s a window, examples/s, peak memory and loss difference
from the first run; no ``ok`` line.

``--kernel23-against DIR ...`` runs the build and Kernels 2 and 3 of this
checkout and of each DIR (its binned_sgd.cu and binned_scatter_add.cu
beside its own row_runs.cuh, with this checkout's C interface: an earlier
tree's ``csrc/``, or a copy with one part altered) on the bf16 and fp8
slices' first step, ``cli adagrad``'s and the resident table's
(``kernel23_against_cases``): whether each build writes this build's bits,
device ms in turns and by CUDA kernel. It prints the card and one JSON
line, and no ``ok`` line.

``--bench [NAME ...]`` runs the build and the bench phase for each named
run of BENCH_RUNS in turn (kaggle alone when none is named: the kaggle
defaults, ``--cache-dtype float8_e4m3fn``, ``--sparse-grad``, ``--scale
terabyte``, ``--scale avazu``; terabyte's segments need not churn, and the
resident avazu run has no churn, hit-rate or memory gate), printing the card, then one JSON line of the runs'
summaries; no ``ok`` line.

``--fp8-windows`` runs the build and phase 6's fp8 windows twice in a new
process, the first pass under torch.profiler (its heaviest host operations
printed), to tell a window's start-up from its steady time; no ``ok`` line.

``--kernel5-against`` runs the build and phases 9 and 10 only, with their
gates, and times each of Kernel 5's entries on its step, as it is and cast
to f32 rows, against the same entry built from SOURCE (an earlier
``ordered_scatter_add.cu`` that exports this checkout's C interface for the
two entries): the same bits, then device ms in turns
(``kernel5_against_turns``). It prints the card and one JSON line of the
turns, and no ``ok`` line.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
ITERS = 10
SLEEP_CYCLES_PER_MS = 2.0e6  # the SM clock is at most 1.98 GHz: this lasts at least 1 ms
FP8 = "float8_e4m3fn"
E5M2 = "float8_e5m2"
# each kernel's main path: its launches in the kernels line are that path's
MAIN_PATH = {"gather_rows": "bf16 slice", "binned_sgd": "bf16 slice", "binned_scatter_add": "fp8 slice",
             "stochastic_round": "fp8 slice", "ordered_scatter_add": "ragged"}
# a kernel whose CUDA kernel two wrappers launch: its launches are both wrappers' counts
KERNEL_ENTRIES = {"stochastic_round": ("stochastic_round", "stochastic_sgd_round"),
                  "binned_sgd": ("binned_sgd", "binned_adagrad"),  # Kernel 2's SGD and Adagrad epilogues
                  "ordered_scatter_add": ("ordered_scatter_add", "ordered_grad_update")}  # Kernel 5's two entries
# the wrappers that update rows: a path must launch the ones it names and no other
UPDATE_ENTRIES = ("binned_sgd", "binned_adagrad", "binned_scatter_add", "stochastic_round",
                  "stochastic_sgd_round", "ordered_scatter_add", "ordered_grad_update")


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """Median time of one call, by CUDA events around each call, each call
    synchronized alone: a call faster than its host work (the wrapper's
    checks, the launch) reads as that host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_median_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call. All
    the calls are enqueued behind a device-side sleep that outlasts their
    host time, so the card runs them back to back and the host's share does
    not show; a call that synchronizes inside still counts its host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * (1.0 + 1.5 * iters * host_ms)))
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def kernel_breakdown(fn, iters: int = 5) -> dict:
    """Device ms per call of each CUDA kernel (``*_kernel``) that ``fn``
    launches, by torch.profiler; empty where it sees no device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        m = re.search(r"(\w+_kernel)\b", e.key)
        if us > 0 and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / iters / 1e3
    return out


def zero_launch_counts() -> None:
    from cachedembedding_tpu_torch.ops import kernel_wrappers

    for w in kernel_wrappers().values():
        w.launches = 0


def check_update_launches(tag: str, launches: dict, steps: int, *entries: str) -> None:
    """The path launched each update wrapper of ``entries`` once a training
    step and no other (UPDATE_ENTRIES)."""
    for e in UPDATE_ENTRIES:
        want = steps if e in entries else 0
        if launches[e] != want:
            raise AssertionError(f"{tag} kernel {e} launched {launches[e]} times, expected {want}: {launches}")


def check_flush(tr, tag: str) -> int:
    """Flush the trainer's cache: sampled host rows (cache slots and the
    resident region) must equal the cache rows they came from, and, under
    row-wise Adagrad, their accumulators too. Returns the rows checked."""
    import numpy as np
    import torch

    emb = tr.embed
    emb.flush()
    slots, rows = emb.resident()
    pick = np.random.default_rng(0).choice(slots.shape[0], min(4096, slots.shape[0]), replace=False)
    res_pick = (np.random.default_rng(1).choice(emb.resident_total, min(4096, emb.resident_total), replace=False)
                if emb.resident_total else np.zeros((0,), np.int64))
    addrs = np.concatenate([slots[pick].astype(np.int64), emb.capacity + res_pick])
    host_rows = np.concatenate([rows[pick], emb._res_rows[res_pick]])
    addrs_dev = torch.from_numpy(addrs).to(emb.device)
    if not np.array_equal(emb.host_table.gather(host_rows), emb.cache_weight[addrs_dev].float().cpu().numpy()):
        raise AssertionError(f"{tag} flushed host rows differ from their cache rows")
    if emb.cache_accum is not None and not np.array_equal(emb.host_accum.gather(host_rows),
                                                          emb.cache_accum[addrs_dev].cpu().numpy()):
        raise AssertionError(f"{tag} flushed accumulators differ from their cache accumulators")
    log(f"{tag} flush: {addrs.shape[0]} sampled rows equal their cache rows")
    return addrs.shape[0]


def phase_build() -> None:
    from cachedembedding_tpu_torch._native import hostops
    from cachedembedding_tpu_torch.ops import _cuda

    jobs = {"libhostops (g++)": hostops.build_lib}
    for name in _cuda.SOURCES:
        jobs[f"{name} (nvcc sm_90a)"] = lambda name=name: _cuda.build_kernel(name)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        for k, fut in futs.items():
            path, secs, out = fut.result()
            log(f"[build] {k}: {secs:.1f} s -> {path.name}")
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    log(f"[build]   {line.strip()}")


def slice_config(cache_dtype: str):
    from cachedembedding_tpu_torch.config import (
        CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
        CacheConfig,
        DLRMConfig,
    )

    return DLRMConfig(
        num_embeddings_per_feature=CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
        embedding_dim=128,
        dense_in_features=13,
        dense_arch_layer_sizes=(512, 256, 128),
        over_arch_layer_sizes=(1024, 1024, 512, 256, 1),
        batch_size=16384,
        learning_rate=1.0,
        compute_dtype="bfloat16",
        dense_input_dtype="bfloat16",
        cache=CacheConfig(
            cache_ratio=0.01, warmup_ratio=0.7, prefetch_num=8, buffer_size=0,
            use_lfu_eviction=False, weight_init="virtual", transfer_dtype="bfloat16",
            cache_dtype=cache_dtype, resident_threshold=500_000,
            ship_sort_perm=True, use_pallas_lookup=True,
        ),
    )


def _ulp_bf16(x):
    import torch

    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


LIGHT_BIN = 1024  # a bin of at most this many ids is light


def light_part(g, ids_nf, bins, num_rows):
    """The light part of a step: its stream without the ids of bins of more
    than LIGHT_BIN ids, in stream order, planned anew. Returns (g, perm,
    v_grouped, bin_starts) of that part and the share of ids it keeps."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import BLOCK_ROWS, sort_plan_np

    ids = ids_nf.cpu().numpy().astype("int32")
    keep = torch.diff(bins).cpu().numpy()[ids // BLOCK_ROWS] <= LIGHT_BIN
    g_l = g[torch.from_numpy(keep).to(g.device)].contiguous()
    plan = (torch.from_numpy(a).to(g.device) for a in sort_plan_np(ids[keep], num_rows))
    return (g_l, *plan), float(keep.mean())


def row_runs(grouped, chunk: int) -> dict:
    """The runs of one row in a step's sorted stream: the heaviest row's
    length, the chunks of ``chunk`` contributors, and the runs that cross a
    chunk boundary (finished by the second launch)."""
    import torch

    _, counts = torch.unique_consecutive(grouped, return_counts=True)
    b = torch.arange(chunk, grouped.numel(), chunk, device=grouped.device)
    crossing = grouped[b][grouped[b - 1] == grouped[b]]
    return {"heaviest_row_ids": int(counts.max()), "chunks": -(-grouped.numel() // chunk),
            "crossing_runs": int(torch.unique(crossing).numel())}


def heaviest_row_chunk(grouped, chunk: int):
    """Stream positions of one whole chunk of ``chunk`` contributors inside
    the heaviest row's run of the sorted stream (a planted fault leaves them
    out)."""
    import torch

    _, counts = torch.unique_consecutive(grouped, return_counts=True)
    r = int(torch.argmax(counts))
    start = int(counts[:r].sum())
    s0 = -(-start // chunk) * chunk
    if s0 + chunk > start + int(counts[r]):
        raise AssertionError(f"the heaviest row ({int(counts[r])} ids) holds no whole chunk of {chunk}")
    return slice(s0, s0 + chunk)


def plan_host_ms(win, F: int, num_rows: int, iters: int = 10) -> float:
    """Median host ms of ``sort_plan_np`` on the window's first step, in the
    trainer's (N, F) stream order."""
    from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np

    ids = win.slot_ids[0].cpu().numpy()
    v = ids.reshape(F, -1).T
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sort_plan_np(v, num_rows)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def phase_kernels(cfg, tr, win) -> list:
    """Hold Kernels 1 and 2 against their plain versions on the first
    training step of the bf16 slice: its device addresses, its grouping plan
    and the trained cache rows (cloned, so the trainer's state is not
    touched)."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        BLOCK_ROWS,
        ROW_CHUNK,
        binned_sgd_update,
        binned_sgd_update_plain,
    )
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

    F, D, B = cfg.num_sparse_features, cfg.embedding_dim, cfg.batch_size
    ids = win.slot_ids[0]
    perm, grouped, bins = (a[0] for a in win.plan)
    L = ids.shape[0]
    cw = tr.embed.cache_weight.clone()
    C = cw.shape[0]
    device = cw.device
    gen = torch.Generator(device=device).manual_seed(0)
    row_bytes = D * cw.element_size()
    results = []

    # ---- Kernel 1: the row gather ----
    out = gather_rows(cw, ids, F)
    ids_nf = ids.reshape(F, B).t().reshape(-1).long()  # the output's row order
    plain = gather_rows_plain(cw, ids, F)
    lib = torch.index_select(cw, 0, ids_nf).reshape(B, F, D)
    torch.cuda.synchronize()
    if not (torch.equal(out, plain) and torch.equal(out, lib)):
        raise AssertionError("gather_rows kernel differs from index_select")
    err = (out.float() - plain.float()).abs().max().item()
    # the least traffic: the ids, each distinct row read once, the output written
    n_distinct = int(torch.unique(ids).numel())
    k1 = dict(
        name="gather_rows", route="cuda",
        source="cachedembedding_tpu_torch/csrc/gather_rows.cu",
        replaces="cachedembedding_tpu/ops/pallas_bag.py:29",
        max_abs_err=err,
        ms=median_ms(lambda: gather_rows(cw, ids, F)),
        device_ms=device_median_ms(lambda: gather_rows(cw, ids, F)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw, ids, F)),
        bound_ms=(L * 4 + (n_distinct + L) * row_bytes) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=median_ms(lambda: torch.index_select(cw, 0, ids_nf)),
        library="torch.index_select", timed_on="bf16 slice, first training step",
        tolerance="bit-exact",
    )
    log(f"[kernel] gather_rows: {n_distinct} distinct rows, equal to index_select; {json.dumps(k1)}")
    results.append(k1)
    del out, plain, lib

    # ---- Kernel 2: the fused binned SGD update ----
    slr = cfg.learning_rate
    g = (1e-3 * torch.randn((L, D), generator=gen, device=device)).to(torch.bfloat16)  # stream order (B, F)
    a = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
    b = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
    ref = binned_sgd_update_plain(cw.clone(), g, perm, grouped, bins, slr)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("binned_sgd kernel is not deterministic across launches")
    touched = torch.zeros(C, dtype=torch.bool, device=device)
    touched[ids.long()] = True
    n_touched = int(touched.sum())
    n_bad = sgd_faults(a, cw, ref, touched)
    if n_bad:
        raise AssertionError(f"binned_sgd kernel: {n_bad} elements off by more than one bf16 ulp")
    diff = (a[touched].float() - ref[touched].float()).abs()
    # the gate must reject a planted fault: the heaviest row's sum without
    # one chunk of ROW_CHUNK addends
    g_drop = g.clone()
    g_drop[perm[heaviest_row_chunk(grouped, ROW_CHUNK)].long()] = 0
    if not sgd_faults(binned_sgd_update_plain(cw.clone(), g_drop, perm, grouped, bins, slr), cw, ref, touched):
        raise AssertionError("binned_sgd gate passed a planted fault (heaviest row missing one chunk)")
    del g_drop
    cw_t = cw.clone()
    light, light_share = light_part(g, ids_nf, bins, C)
    sizes = torch.diff(bins)
    top = torch.topk(sizes, 5)
    heavy = [(int(n), int(b) * BLOCK_ROWS) for n, b in zip(top.values, top.indices)]
    runs = row_runs(grouped, ROW_CHUNK)
    cw_l = cw.clone()
    k2 = dict(
        name="binned_sgd", route="cuda",
        source="cachedembedding_tpu_torch/csrc/binned_sgd.cu",
        replaces="cachedembedding_tpu/ops/binned_scatter.py:199",
        max_abs_err=diff.max().item(),
        ms=median_ms(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
        device_ms=device_median_ms(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
        plain_ms=median_ms(lambda: binned_sgd_update_plain(cw_t, g, perm, grouped, bins, slr)),
        bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), n_touched, cw.element_size()),
        bound_by="bytes",
        # rounds each addend to bf16: a different result, timed as a yardstick
        library_ms=median_ms(lambda: cw_l.index_add_(0, ids_nf, g, alpha=-slr)),
        library="Tensor.index_add_ (bf16 addends: a different rounding)",
        timed_on="bf16 slice, first training step",
        tolerance="untouched bit-equal; touched within one bf16 ulp (+1e-6 abs)",
        light_ms=median_ms(lambda: binned_sgd_update(cw_t, *light, slr)),
        light_share=light_share,
        chunk=ROW_CHUNK, cuda_launches_per_call=2, **runs,
        plan_host_ms=plan_host_ms(win, F, C),
        cuda_kernels_ms=kernel_breakdown(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
    )
    log(f"[kernel] binned_sgd: {n_touched} touched rows; heaviest bins (ids, first row) {heavy}, "
        f"cache slots below row {tr.embed.capacity}; heaviest row {runs['heaviest_row_ids']} ids, "
        f"{runs['crossing_runs']} runs cross chunks of {ROW_CHUNK}; two launches bit-identical; the gate "
        f"rejects the planted fault; {json.dumps(k2)}")
    results.append(k2)
    return results


def sgd_faults(x, cw, ref, touched) -> int:
    """Elements of ``x``, ``cw`` updated by Kernel 2, off the plain version's
    ``ref`` by more than one bf16 ulp of the result, plus f32 rounding of the
    O(0.1) terms where cw - slr*acc cancels towards zero; rows not in
    ``touched`` must stay bit-equal."""
    import torch

    if not torch.equal(x[~touched], cw[~touched]):
        raise AssertionError("binned_sgd changed untouched rows")
    xt, rt = x[touched].float(), ref[touched].float()
    tol = _ulp_bf16(torch.maximum(xt.abs(), rt.abs())) + 1e-6
    return int(((xt - rt).abs() > tol).sum())


SCATTER_RTOL = 1e-5  # of the sum of |g| over an element's addends


def scatter_add_faults(out, ref64, abs64):
    """Elements of a (C, D) f32 scatter-add ``out`` that are off its float64
    sum ``ref64`` by more than SCATTER_RTOL of the sum of |g| ``abs64`` over
    their addends. f32 sum-order error stays far inside that; a row that
    misses an addend does not. Untouched rows must be exactly 0."""
    return int(((out.double() - ref64).abs() > SCATTER_RTOL * abs64).sum())


def phase_kernels_fp8(cfg, tr, win, first_update):
    """Hold Kernels 1, 3 and 4 against their plain versions on the first
    training step of the fp8 slice: its ids, its grouping plan, its row grads
    (as the trainer cast them, to bf16) and the cache rows before its update.
    Returns Kernel 1's numbers on this path and the entries of Kernels 3, 4."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        BLOCK_ROWS,
        ROW_CHUNK,
        binned_scatter_add,
        binned_scatter_add_plain,
    )
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
    from cachedembedding_tpu_torch.ops.rounding import (
        stochastic_astype,
        stochastic_astype_plain,
        stochastic_sgd_round_,
        stochastic_sgd_round_plain,
    )

    F, D, B = cfg.num_sparse_features, cfg.embedding_dim, cfg.batch_size
    cw0, g_rows, slr, seed = first_update
    ids = win.slot_ids[0]
    perm, grouped, bins = (a[0] for a in win.plan)
    L, C = ids.shape[0], cw0.shape[0]
    device = cw0.device
    ids_nf = ids.reshape(F, B).t().reshape(-1).long()  # the grads' row order
    g = g_rows.to(torch.bfloat16)
    results = []

    # ---- Kernel 1 on fp8 rows (128-byte rows); compared through a uint8 view ----
    u8 = torch.uint8
    out = gather_rows(cw0, ids, F)
    plain = gather_rows_plain(cw0.view(u8), ids, F)
    lib = torch.index_select(cw0.view(u8), 0, ids_nf).reshape(B, F, D)
    torch.cuda.synchronize()
    if not (torch.equal(out.view(u8), plain) and torch.equal(out.view(u8), lib)):
        raise AssertionError("gather_rows kernel differs from index_select on fp8 rows")
    n_distinct = int(torch.unique(ids).numel())
    k1 = dict(
        max_abs_err=0.0,
        ms=median_ms(lambda: gather_rows(cw0, ids, F)),
        device_ms=device_median_ms(lambda: gather_rows(cw0, ids, F)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw0.view(u8), ids, F)),
        bound_ms=(L * 4 + (n_distinct + L) * D * cw0.element_size()) / HBM_BYTES_PER_S * 1e3,
        library_ms=median_ms(lambda: torch.index_select(cw0.view(u8), 0, ids_nf)),
        timed_on="fp8 slice, first training step", tolerance="bit-exact (uint8 view)",
    )
    log(f"[kernel] gather_rows on fp8 rows: {n_distinct} distinct rows, equal to index_select; {json.dumps(k1)}")
    del out, plain, lib

    # ---- Kernel 3: the binned scatter-add, against a float64 index_add_ ----
    a = binned_scatter_add(g, perm, grouped, bins, C)
    b = binned_scatter_add(g, perm, grouped, bins, C)
    ref = binned_scatter_add_plain(g, perm, grouped, bins, C)
    ref64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g.double())
    abs64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g.double().abs())
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("binned_scatter_add kernel is not deterministic across launches")
    touched = torch.zeros(C, dtype=torch.bool, device=device)
    touched[ids.long()] = True
    if not bool((a[~touched] == 0).all()):
        raise AssertionError("binned_scatter_add kernel wrote a nonzero untouched row")
    for name, x in (("kernel", a), ("plain version", ref)):
        n_bad = scatter_add_faults(x, ref64, abs64)
        if n_bad:
            raise AssertionError(f"binned_scatter_add {name}: {n_bad} elements off the float64 sum "
                                 f"by more than {SCATTER_RTOL} of their sum of |g|")
    # the gate must reject a planted fault: an all-zero output, a stream with
    # every second addend dropped, the heaviest bin left at zero, and the
    # heaviest row's sum without one chunk of ROW_CHUNK addends
    g_half = g.clone()
    g_half[1::2] = 0
    g_chunk = g.clone()
    g_chunk[perm[heaviest_row_chunk(grouped, ROW_CHUNK)].long()] = 0
    heavy = int(torch.argmax(torch.diff(bins)))
    skipped = a.clone()
    skipped[heavy * BLOCK_ROWS:(heavy + 1) * BLOCK_ROWS] = 0
    planted = {"zeros": lambda: torch.zeros_like(a),
               "half the addends": lambda: binned_scatter_add_plain(g_half, perm, grouped, bins, C),
               "heaviest bin skipped": lambda: skipped,
               "heaviest row missing one chunk": lambda: binned_scatter_add_plain(g_chunk, perm, grouped, bins, C)}
    for name, make in planted.items():
        if not scatter_add_faults(make(), ref64, abs64):
            raise AssertionError(f"binned_scatter_add gate passed a planted fault ({name})")
    del planted, skipped, g_half, g_chunk
    err = (a - ref).abs().max().item()
    rel64 = ((a.double() - ref64).abs() / abs64.clamp_min(1e-300)).max().item()
    ref_max = ref64.abs().max().item()
    del ref64, abs64
    # f32 grads (16-byte loads a lane): the same gates against their own float64 sums
    g32 = g_rows.float().contiguous()
    a32 = binned_scatter_add(g32, perm, grouped, bins, C)
    b32 = binned_scatter_add(g32, perm, grouped, bins, C)
    ref64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g32.double())
    abs64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g32.double().abs())
    if not torch.equal(a32, b32) or not bool((a32[~touched] == 0).all()):
        raise AssertionError("binned_scatter_add kernel on f32 grads: launches differ or untouched rows nonzero")
    n_bad = scatter_add_faults(a32, ref64, abs64)
    if n_bad:
        raise AssertionError(f"binned_scatter_add kernel on f32 grads: {n_bad} elements off the float64 sum")
    on_f32 = dict(
        max_err_over_sum_abs_g=((a32.double() - ref64).abs() / abs64.clamp_min(1e-300)).max().item(),
        ms=median_ms(lambda: binned_scatter_add(g32, perm, grouped, bins, C)),
        device_ms=device_median_ms(lambda: binned_scatter_add(g32, perm, grouped, bins, C)),
        bound_ms=(8 * L + L * D * 4 + bins.numel() * 4 + C * D * 4) / HBM_BYTES_PER_S * 1e3,
        library_ms=median_ms(
            lambda: torch.zeros((C, D), dtype=torch.float32, device=device).index_add_(0, ids_nf, g32)),
    )
    del a32, b32, ref64, abs64, g32
    scalar = check_scalar_path(perm, grouped, bins, ids_nf, touched, slr)
    light, light_share = light_part(g, ids_nf, bins, C)
    runs = row_runs(grouped, ROW_CHUNK)
    bytes3 = 8 * L + L * D * g.element_size() + bins.numel() * 4 + C * D * 4
    k3 = dict(
        name="binned_scatter_add", route="cuda",
        source="cachedembedding_tpu_torch/csrc/binned_scatter_add.cu",
        replaces="cachedembedding_tpu/ops/binned_scatter.py:64",
        max_abs_err=err,
        ms=median_ms(lambda: binned_scatter_add(g, perm, grouped, bins, C)),
        device_ms=device_median_ms(lambda: binned_scatter_add(g, perm, grouped, bins, C)),
        plain_ms=median_ms(lambda: binned_scatter_add_plain(g, perm, grouped, bins, C)),
        bound_ms=bytes3 / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=median_ms(
            lambda: torch.zeros((C, D), dtype=torch.float32, device=device).index_add_(0, ids_nf, g.float())),
        library="torch.zeros(C, D).index_add_ (f32 atomics: another sum order)",
        timed_on="fp8 slice, first training step (bf16 grads)",
        tolerance=f"kernel and plain version each within {SCATTER_RTOL} x sum|g| of a float64 index_add_; "
                  "untouched rows exactly 0; two launches bit-identical",
        max_err_over_sum_abs_g=rel64, max_abs_sum=ref_max,
        light_ms=median_ms(lambda: binned_scatter_add(*light, C)),
        light_share=light_share,
        chunk=ROW_CHUNK, cuda_launches_per_call=3, **runs,
        plan_host_ms=plan_host_ms(win, F, C), on_f32_grads=on_f32, one_element_a_lane=scalar,
        cuda_kernels_ms=kernel_breakdown(lambda: binned_scatter_add(g, perm, grouped, bins, C)),
    )
    log(f"[kernel] binned_scatter_add: {int(touched.sum())} touched rows of {C}; largest |sum| {ref_max:.3e}; "
        f"heaviest row {runs['heaviest_row_ids']} ids, {runs['crossing_runs']} runs cross chunks of "
        f"{ROW_CHUNK}; the gate rejects all four planted faults; on f32 grads and on the one-element-a-lane "
        f"path ({', '.join(scalar)}) the same gates pass; {json.dumps(k3)}")
    results.append(k3)
    del light

    # ---- Kernel 4: stochastic rounding of that step's cw - slr * g ----
    new32 = torch.sub(cw0.float(), a, alpha=slr)
    del b, ref
    for name in ROUND_VIEWS:
        dt = getattr(torch, name)
        rounding_gate(stochastic_astype(new32, dt, seed), stochastic_astype_plain(new32, dt, seed),
                      f"stochastic_round on the step's cw - slr * g ({name})")
    fused = check_fused_entry(cw0, a, slr, seed)
    t0 = time.perf_counter()
    sweep = check_rounding_sweep(device)
    sweep["planted_faults"] = check_planted_rounding_faults(device)
    edges = check_rounding_edges(device)
    checks_s = time.perf_counter() - t0
    fp8 = torch.float8_e4m3fn
    out = torch.empty((C, D), dtype=fp8, device=device)
    cw_t = cw0.clone()
    fused.update(
        ms=median_ms(lambda: stochastic_sgd_round_(cw_t, a, slr, seed)),
        device_ms=device_median_ms(lambda: stochastic_sgd_round_(cw_t, a, slr, seed)),
        plain_ms=median_ms(lambda: stochastic_sgd_round_plain(cw0, a, slr, seed)),
        bound_ms=C * D * (1 + 4 + 1) / HBM_BYTES_PER_S * 1e3,  # rows read and written, f32 grad read
        bound_by="bytes",
        library_ms=None,  # no one PyTorch call rounds stochastically
        # the step before: cw.float(), torch.sub, then the standalone kernel
        chain_device_ms=device_median_ms(
            lambda: stochastic_astype(torch.sub(cw0.float(), a, alpha=slr), fp8, seed, out=out)),
    )
    k4 = dict(
        name="stochastic_round", route="cuda",
        source="cachedembedding_tpu_torch/csrc/stochastic_round.cu",
        replaces="cachedembedding_tpu/ops/rounding.py:37",
        max_abs_err=0.0,
        ms=median_ms(lambda: stochastic_astype(new32, fp8, seed, out=out)),
        device_ms=device_median_ms(lambda: stochastic_astype(new32, fp8, seed, out=out)),
        plain_ms=median_ms(lambda: stochastic_astype_plain(new32, fp8, seed)),
        bound_ms=C * D * (4 + 1) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=median_ms(lambda: new32.to(fp8)),
        library="Tensor.to(float8_e4m3fn): deterministic rounding, a different function",
        timed_on="fp8 slice, first training step",
        tolerance="bit-exact (float8_e4m3fn, bfloat16, float8_e5m2)",
        fused_entry=fused, sweep=sweep, edges=edges, checks_s=checks_s,
    )
    log(f"[kernel] stochastic_round: ({C}, {D}) f32 -> fp8, seed {seed}, bit-equal to its plain "
        f"version for e4m3fn, bf16 and e5m2 on the step, on all 2^32 f32 bit patterns, on tails and "
        f"misaligned inputs; the fused entry bit-equal to the unfused chain; the gate rejects both planted "
        f"faults; {json.dumps(k4)}")
    results.append(k4)
    return k1, results


ROUND_VIEWS = {"float8_e4m3fn": "uint8", "bfloat16": "int16", "float8_e5m2": "uint8"}
SWEEP_CHUNK = 1 << 28  # f32 bit patterns per launch of the sweep


def rounding_gate(got, want, what: str) -> None:
    """Kernel 4's gate: ``got`` bit-equal to the plain version's ``want``."""
    import torch

    view = getattr(torch, ROUND_VIEWS[str(want.dtype).removeprefix("torch.")])
    n_bad = rounding_faults(got, want)
    if n_bad:
        g, w = got.reshape(-1).view(view), want.reshape(-1).view(view)
        idx = torch.nonzero(g != w)[:6, 0].tolist()
        raise AssertionError(f"{what}: {n_bad} elements differ from the plain version; at {idx}: "
                             f"{[int(g[i]) for i in idx]} vs {[int(w[i]) for i in idx]}")


def rounding_faults(got, want) -> int:
    import torch

    view = getattr(torch, ROUND_VIEWS[str(want.dtype).removeprefix("torch.")])
    if got.dtype != want.dtype or got.shape != want.shape:
        return want.numel()
    return int((got.view(view) != want.view(view)).sum())


def check_rounding_sweep(device) -> dict:
    """Kernel 4 against its plain version on every f32 bit pattern, for each
    target dtype, SWEEP_CHUNK patterns a launch, each chunk with its own
    seed. Returns the seconds it took."""
    import torch

    from cachedembedding_tpu_torch.ops.rounding import stochastic_astype, stochastic_astype_plain

    t0 = time.perf_counter()
    for name in ROUND_VIEWS:
        dt = getattr(torch, name)
        for c, lo in enumerate(range(-(1 << 31), 1 << 31, SWEEP_CHUNK)):
            x = torch.arange(lo, lo + SWEEP_CHUNK, dtype=torch.int64, device=device).to(torch.int32)
            x = x.view(torch.float32)
            seed = (0x9E3779B9 * c + 17) & 0xFFFFFFFF
            want = stochastic_astype_plain(x, dt, seed)
            rounding_gate(stochastic_astype(x, dt, seed), want,
                          f"stochastic_round sweep ({name}, bits {lo & 0xFFFFFFFF:#010x}.., seed {seed})")
            del x, want
    return {"patterns": 1 << 32, "dtypes": list(ROUND_VIEWS), "seconds": time.perf_counter() - t0}


def check_planted_rounding_faults(device, n: int = 1 << 24) -> dict:
    """Kernel 4's gate shown to reject two planted faults: ``u <= p`` in
    place of ``u < p``, and the Philox stream shifted by one word. The input
    puts p on u for one element in 16 (x = 1 + u rounded down to 2^-20 of
    the e4m3 step 0.125: p = u wherever u's low 4 bits are 0), so ties,
    which a random input meets once in 2^24 draws, are common; the kernel
    must still equal the plain version there. Returns each fault's count of
    mismatches."""
    import torch

    from cachedembedding_tpu_torch.ops.rounding import (
        philox_uniform,
        sr_from_uniform,
        stochastic_astype,
        stochastic_astype_plain,
    )

    fp8, seed = torch.float8_e4m3fn, 0x5EED
    u = philox_uniform(seed, (n,), device)
    x = 1.0 + torch.floor(u * 2.0**20) * 2.0**-23
    want = stochastic_astype_plain(x, fp8, seed)
    rounding_gate(stochastic_astype(x, fp8, seed), want, "stochastic_round on ties (p = u)")
    faults = {
        "u <= p": sr_from_uniform(x, torch.nextafter(u, torch.full_like(u, -float("inf"))), fp8),
        "Philox shifted one word": sr_from_uniform(x, philox_uniform(seed, (n + 1,), device)[1:], fp8),
    }
    found = {}
    for fault, bad in faults.items():
        found[fault] = rounding_faults(bad, want)
        if not found[fault]:
            raise AssertionError(f"stochastic_round gate passed a planted fault ({fault})")
    return {"n": n, "ties": int((u * 2.0**24 % 16 == 0).sum()), "mismatches": found}


def check_rounding_edges(device) -> dict:
    """Kernel 4 and its fused entry where they take their element-wise path:
    n % 16 != 0 (the ragged end) and inputs 4 bytes off 16-byte alignment
    (rows one element off), on seeded values with every special class, and
    a second seed. Returns the cases checked."""
    import torch

    from cachedembedding_tpu_torch.ops.rounding import (
        stochastic_astype,
        stochastic_astype_plain,
        stochastic_sgd_round_,
        stochastic_sgd_round_plain,
    )

    n, seed = 1_000_003, 0xC0FFEE
    gen = torch.Generator(device=device).manual_seed(3)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), -float("nan"), 448.0, -448.0,
                            464.0, 465.0, 57344.0, 6e4, 1e-30, -1e-30, 2.0**-10, -2.0**-10, 1.5 * 2.0**-9,
                            3.0e38, -3.0e38, 1e-40, -1e-40], device=device)
    vals = 3 * torch.randn(n, generator=gen, device=device)
    vals[: special.numel()] = special
    vals[special.numel():: 7] *= 2.0 ** -12  # target subnormals
    cases = []
    for offset in (0, 1):  # 1: the input one element off 16-byte alignment
        buf = torch.empty(n + offset, device=device)
        x = buf[offset:]
        x.copy_(vals)
        for name in ROUND_VIEWS:
            dt = getattr(torch, name)
            rounding_gate(stochastic_astype(x, dt, seed), stochastic_astype_plain(x, dt, seed),
                          f"stochastic_round, n = {n}, offset {offset} ({name})")
            # the fused entry: rows and grad both `offset` elements in
            rows0 = stochastic_astype_plain(vals.clamp(-400.0, 400.0).nan_to_num(0.0), dt, seed + 1)
            rbuf = torch.empty(n + offset, dtype=dt, device=device)
            rows = rbuf[offset:]
            rows.view(torch.uint8 if dt.itemsize == 1 else torch.int16).copy_(
                rows0.view(torch.uint8 if dt.itemsize == 1 else torch.int16))
            g = buf[offset:]
            rounding_gate(stochastic_sgd_round_(rows, g, 0.37, seed), stochastic_sgd_round_plain(rows0, g, 0.37, seed),
                          f"stochastic_sgd_round_, n = {n}, offset {offset} ({name})")
            cases.append(f"{name}, offset {offset}")
        del buf, x
    return {"n": n, "seed": seed, "cases": cases}


def check_fused_entry(cw0, g32, slr: float, seed: int) -> dict:
    """The fused entry against the unfused chain (cw.float(), torch.sub,
    the plain rounding) on a step's rows and f32 grad, for e4m3fn and bf16
    rows, at the step's slr and at 0.37 (where a multiply-add and two
    roundings differ)."""
    import torch

    from cachedembedding_tpu_torch.ops.rounding import stochastic_sgd_round_, stochastic_sgd_round_plain

    checked = []
    for name in ("float8_e4m3fn", "bfloat16"):
        rows = cw0 if name == "float8_e4m3fn" else cw0.float().to(torch.bfloat16)
        for s in (slr, 0.37):
            rounding_gate(stochastic_sgd_round_(rows.clone(), g32, s, seed), stochastic_sgd_round_plain(rows, g32, s, seed),
                          f"stochastic_sgd_round_ on the step ({name} rows, slr {s})")
            checked.append(f"{name} rows, slr {s}")
    return {"entry": "stochastic_sgd_round_", "bit_equal_to_chain": checked}


def check_scalar_path(perm, grouped, bins, ids_nf, touched, slr) -> dict:
    """Kernels 2 and 3 through their one-element-a-lane path, which they take
    where D is not a multiple of 4 or a row is not 16-byte aligned, on a
    step's plan (``ids_nf`` the stream's ids, ``touched`` its rows): D = 18,
    and D = 128 with the grads one element off 16-byte alignment. Each case
    meets its kernel's gates: Kernel 2 on bf16 rows within one bf16 ulp of
    its plain version, untouched rows bit-equal; Kernel 3 on bf16 and f32
    grads within SCATTER_RTOL of a float64 index_add_, untouched rows 0; two
    launches bit-identical. Returns each case's largest error of Kernel 3
    over the sum of |g|."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        binned_scatter_add,
        binned_sgd_update,
        binned_sgd_update_plain,
    )

    C, L, device = touched.shape[0], ids_nf.shape[0], touched.device
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}
    for case, D, offset in (("D=18", 18, 0), ("D=128, grads one element off 16-byte alignment", 128, 1)):
        for dt in (torch.bfloat16, torch.float32):
            buf = torch.empty(L * D + offset, dtype=dt, device=device)
            g = buf[offset:].view(L, D)  # contiguous; offset 1 breaks 16-byte alignment
            g.copy_(1e-3 * torch.randn((L, D), generator=gen, device=device))
            if dt == torch.bfloat16:
                cw = (0.1 * torch.randn((C, D), generator=gen, device=device)).to(dt)
                a = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
                b = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
                ref = binned_sgd_update_plain(cw.clone(), g, perm, grouped, bins, slr)
                if not torch.equal(a, b):
                    raise AssertionError(f"binned_sgd ({case}) is not deterministic across launches")
                n_bad = sgd_faults(a, cw, ref, touched)
                if n_bad:
                    raise AssertionError(f"binned_sgd ({case}): {n_bad} elements off by more than one bf16 ulp")
                del a, b, ref, cw
            a = binned_scatter_add(g, perm, grouped, bins, C)
            b = binned_scatter_add(g, perm, grouped, bins, C)
            ref64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g.double())
            abs64 = torch.zeros((C, D), dtype=torch.float64, device=device).index_add_(0, ids_nf, g.double().abs())
            if not torch.equal(a, b) or not bool((a[~touched] == 0).all()):
                raise AssertionError(f"binned_scatter_add ({case}, {dt}): launches differ or untouched rows nonzero")
            n_bad = scatter_add_faults(a, ref64, abs64)
            if n_bad:
                raise AssertionError(f"binned_scatter_add ({case}, {dt}): {n_bad} elements off the float64 sum")
            out[f"{case}, {str(dt).removeprefix('torch.')} grads"] = (
                ((a.double() - ref64).abs() / abs64.clamp_min(1e-300)).max().item())
            del a, b, ref64, abs64, buf, g
    return out


def light_row_chunk(grouped, chunk: int):
    """Stream positions of one whole chunk of ``chunk`` contributors inside
    the lightest run of the sorted stream that holds one (at most 2 * chunk
    - 1 contributors, so the chunk is at least half its sum)."""
    import torch

    _, counts = torch.unique_consecutive(grouped, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    s0 = (starts + chunk - 1) // chunk * chunk
    whole = s0 + chunk <= starts + counts
    if not bool(whole.any()):
        raise AssertionError(f"no run of the stream holds a whole chunk of {chunk}")
    r = int(torch.argmin(torch.where(whole, counts, torch.iinfo(counts.dtype).max)))
    return slice(int(s0[r]), int(s0[r]) + chunk)


def fp8_index_add(cw, ids, g, slr: float) -> dict:
    """The library yardstick of Kernel 2 on fp8 rows: Tensor.index_add_ of
    the grads in the rows' dtype (one rounding per addend: another
    function), timed where the card takes it, else the error it gives."""
    import torch

    g8 = g.to(cw.dtype)
    try:
        cw.index_add_(0, ids.long(), g8, alpha=-slr)
    except (RuntimeError, NotImplementedError) as e:  # a measurement of the library, not a path of the port
        return {"library_ms": None, "library": f"Tensor.index_add_ on {cw.dtype}: {str(e).splitlines()[0][:160]}"}
    return {"library_ms": median_ms(lambda: cw.index_add_(0, ids.long(), g8, alpha=-slr)),
            "library": f"Tensor.index_add_ on {cw.dtype} (one rounding per addend: a different function)"}


def check_kernel2_fp8_rows(cw0, win, slr: float) -> dict:
    """Kernel 2 on the fp8 slice's first step (its rows before the update,
    its ids and plan) with float8_e4m3fn and float8_e5m2 rows, each with f32
    grads and with grads in the rows' dtype (1e-2 x |N(0, 1)|, seeded, so
    that the sums do not cancel): untouched rows bit-equal, touched rows
    within one step of the storage dtype of the plain version, two launches
    bit-identical, and the gate shown to reject a planted fault (the lightest
    run holding a whole chunk of ROW_CHUNK addends without it: at least half
    its sum). Returns each case's times beside its bound, the library's
    (``fp8_index_add``), and the device ms of one gather of the case's grad
    rows in the plan's order (index_select: the rows Kernel 2 must read)."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import ROW_CHUNK, binned_sgd_update, binned_sgd_update_plain
    from cachedembedding_tpu_torch.ops.rounding import astype_storage, storage_steps

    ids = win.slot_ids[0]
    perm, grouped, bins = (a[0] for a in win.plan)
    (C, D), L, device = cw0.shape, ids.shape[0], cw0.device
    touched = torch.zeros(C, dtype=torch.bool, device=device)
    touched[ids.long()] = True
    n_touched = int(touched.sum())
    gen = torch.Generator(device=device).manual_seed(2)
    g32 = 1e-2 * torch.randn((L, D), generator=gen, device=device).abs()
    fault = light_row_chunk(grouped, ROW_CHUNK)
    ids_s = torch.empty_like(grouped)
    ids_s[perm.long()] = grouped  # the stream's ids, in g's row order
    perm_l = perm.long()
    out = {}
    for name in (FP8, E5M2):
        dt = getattr(torch, name)
        cw = cw0 if cw0.dtype == dt else astype_storage(cw0.float(), dt)
        u8 = cw.view(torch.uint8)
        for gname, g in (("f32 grads", g32), (f"{name} grads", astype_storage(g32, dt))):
            case = f"{name} rows, {gname}"
            g_rows = g.view(torch.uint8) if g.element_size() == 1 else g
            a = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
            b = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
            ref = binned_sgd_update_plain(cw.clone(), g, perm, grouped, bins, slr)
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"binned_sgd ({case}) is not deterministic across launches")
            if not torch.equal(a.view(torch.uint8)[~touched], u8[~touched]):
                raise AssertionError(f"binned_sgd ({case}) changed untouched rows")

            def steps_off(x):
                return storage_steps(x[touched].float(), ref[touched].float(), dt)

            off = steps_off(a)
            if int(off.max()) > 1:
                raise AssertionError(f"binned_sgd ({case}): {int((off > 1).sum())} elements more than one "
                                     f"{name} step off the plain version")
            g_drop = g.clone()
            g_drop[perm[fault].long()] = 0
            if int(steps_off(binned_sgd_update_plain(cw.clone(), g_drop, perm, grouped, bins, slr)).max()) <= 1:
                raise AssertionError(f"binned_sgd gate ({case}) passed a planted fault (a run without one chunk)")
            cw_t = cw.clone()
            out[case] = dict(
                elements_one_step_off=int((off > 0).sum()), touched_rows=n_touched,
                ms=median_ms(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
                device_ms=device_median_ms(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
                bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), n_touched, cw.element_size()),
                **fp8_index_add(cw_t, ids_s, g, slr),
                # the reads Kernel 2 cannot avoid, g's rows in the plan's order, as one gather
                # (index_select, which also writes them out contiguously)
                grad_rows_gather_device_ms=device_median_ms(lambda: torch.index_select(g_rows, 0, perm_l)),
                grad_rows_gather_bound_ms=2 * L * D * g.element_size() / HBM_BYTES_PER_S * 1e3,
            )
            del a, b, ref, g_drop, cw_t
    log(f"[kernel] binned_sgd on fp8 rows (e4m3fn, e5m2; f32 and storage-dtype grads): untouched rows "
        f"bit-equal, touched within one step of the plain version, two launches bit-identical, the gate "
        f"rejects the planted fault; {json.dumps(out)}")
    return out


NARROW_CHUNK = 1 << 26  # f32 bit patterns per launch of Kernel 2's narrowing gate
FP8_MAX_FINITE = {FP8: 448.0, E5M2: 57344.0}
FP8_MAX_CODE = {FP8: 0x7E, E5M2: 0x7B}


def narrowing_faults(got, x, want, name: str) -> int:
    """Codes of ``got`` (uint8), Kernel 2's narrowing of the f32 ``x`` to
    ``name``, that differ from ``want`` (astype_storage's codes): a NaN
    input must give a NaN (any payload, any sign), -0 gives +0 (the
    update's +0 - (+0)), every other input exactly ``want``."""
    import torch

    nan = torch.isnan(x)
    got_nan = (got & 0x7F) == 0x7F if name == FP8 else ((got & 0x7C) == 0x7C) & ((got & 0x03) != 0)
    want = torch.where(x.view(torch.int32) == torch.iinfo(torch.int32).min, torch.zeros_like(want), want)
    return int((nan & ~got_nan).sum()) + int(((got != want) & ~nan).sum())


def check_fp8_narrowing(device) -> dict:
    """Kernel 2 as a narrowing test on float8_e4m3fn and float8_e5m2 rows:
    rows of +0, one contributor each, f32 grads and slr = -1, so the update
    writes round(0 - (-1 * x)) = round(x) (D = 128, the staged path). Every
    one of the 2^32 f32 bit patterns, NARROW_CHUNK a launch, must give
    ops/rounding.astype_storage's code (``narrowing_faults``: NaN payloads
    apart, and -0, which the update turns into +0). The gate must reject a
    planted fault: the card's saturating conversion without the overflow
    test, which clamps to +-448 or +-57,344 (astype_storage's codes with
    every |x| beyond the largest finite value clamped so). Returns the
    patterns, the seconds and the fault's mismatches."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    D = 128
    L = NARROW_CHUNK // D
    perm, grouped, bins = sort_plan(torch.arange(L, dtype=torch.int32, device=device), L)
    t0 = time.perf_counter()
    planted = {}
    for name in (FP8, E5M2):
        dt = getattr(torch, name)
        for lo in range(-(1 << 31), 1 << 31, NARROW_CHUNK):
            x = torch.arange(lo, lo + NARROW_CHUNK, dtype=torch.int64, device=device).to(torch.int32)
            x = x.view(torch.float32).view(L, D)
            cw = torch.zeros((L, D), dtype=dt, device=device)
            binned_sgd_update(cw, x, perm, grouped, bins, -1.0)
            want = astype_storage(x, dt).view(torch.uint8)
            n_bad = narrowing_faults(cw.view(torch.uint8), x, want, name)
            if n_bad:
                raise AssertionError(f"Kernel 2's narrowing to {name}: {n_bad} of the patterns "
                                     f"{lo & 0xFFFFFFFF:#010x}.. differ from astype_storage")
            over = ~(x.abs() <= FP8_MAX_FINITE[name]) & ~torch.isnan(x)
            if bool(over.any()):
                sat = torch.where(over, (want & 0x80) | FP8_MAX_CODE[name], want)
                planted[name] = planted.get(name, 0) + narrowing_faults(sat, x, want, name)
            del x, cw, want, over
        if not planted.get(name):
            raise AssertionError(f"the narrowing gate passed a planted fault ({name}: saturation past "
                                 f"{FP8_MAX_FINITE[name]})")
    return {"patterns": 1 << 32, "dtypes": [FP8, E5M2], "seconds": time.perf_counter() - t0,
            "saturating_cast_mismatches": planted}


def phase_fp8_windows(device) -> tuple:
    """One training window (prefetch_num steps) at the slices' full width
    with float8_e4m3fn rows and stochastic rounding off (Kernel 2 on fp8
    grads), and with float8_e5m2 rows and rounding on (auto; Kernels 3 and
    4), each with the launch counts zeroed just before; then a flush. Then,
    uncounted, a second window of the same trainer, and for e5m2 one window
    of a second trainer built anew: their device seconds beside the first
    window's tell a process's first use of the path from a trainer's start
    and from the steady window. Returns each path's launch counts and its
    windows' device seconds."""
    import dataclasses

    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    paths, windows = {}, {}
    for path, dtype, sr, entries in (
        ("e4m3fn rounding off", FP8, "off", ("binned_sgd",)),
        ("e5m2 rounding on", E5M2, "auto", ("binned_scatter_add", "stochastic_sgd_round")),
    ):
        cfg = slice_config(dtype)
        cfg.cache = dataclasses.replace(cfg.cache, stochastic_rounding=sr)
        P, tag = cfg.cache.prefetch_num, f"[{path}]"
        train = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, P, skew=0.5, seed=7)
        tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
        zero_launch_counts()
        rep = tr.train(train, num_iters=P)
        torch.cuda.synchronize()
        paths[path] = launches = ops.launch_counts()
        if len(rep.losses) != P or not np.isfinite(rep.losses).all():
            raise AssertionError(f"{tag} losses not finite: {rep.losses}")
        check_update_launches(tag, launches, P, *entries)
        if launches["gather_rows"] != P:
            raise AssertionError(f"{tag} kernel launches {launches}")
        log(f"{tag} one window of {P} steps, losses {[round(x, 5) for x in rep.losses]}; host s "
            f"{rep.window_host_s}, device s {rep.window_device_s}; kernel launches {launches}")
        more = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, P, skew=0.5, seed=9)
        windows[path] = {"first_window_device_s": rep.window_device_s[0], "first_window_host_s": rep.window_host_s[0],
                         "second_window_device_s": tr.train(more, num_iters=P).window_device_s[0]}
        check_flush(tr, tag)
        tr.close()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        if dtype == E5M2:
            tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
            windows[path]["new_trainer_first_window_device_s"] = tr.train(train, num_iters=P).window_device_s[0]
            tr.close()
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        log(f"{tag} windows' device s: {json.dumps(windows[path])}")
    return paths, windows


UNSORTED_PLAN_KERNELS = ("binned_sgd", "binned_scatter_add", "ordered_scatter_add", "ordered_grad_update")


def refuse_unsorted_plan(kernel: str) -> int:
    """Child process of phase 8: hand ``kernel``'s wrapper a plan grouped by
    bin but not sorted by id inside a bin (the JAX package's layout) and
    synchronize. Kernel 5's entries take bf16 rows and grads and a row of
    600 ids, above the heavy threshold: the launch sequence of the ragged
    and 1TB steps. Returns 0 if the kernel stopped with a device-side
    assert, 1 if it took the plan."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import BLOCK_ROWS, binned_scatter_add, binned_sgd_update
    from cachedembedding_tpu_torch.ops.ordered_scatter import (
        heavy_runs,
        ordered_grad_update_,
        ordered_scatter_add_,
    )

    rng = np.random.default_rng(0)
    L, C, D = 4096, 1000, 128
    v = rng.integers(0, C, L).astype(np.int32)
    v[rng.choice(L, 600, replace=False)] = 7  # a heavy run, once sorted
    perm = np.argsort(v // BLOCK_ROWS, kind="stable").astype(np.int32)
    grouped = v[perm]
    bins = np.searchsorted(grouped // BLOCK_ROWS, np.arange(-(-C // BLOCK_ROWS) + 1)).astype(np.int32)
    if bool((np.diff(grouped) >= 0).all()):
        raise AssertionError("the bin-grouped plan happens to be sorted")
    device = torch.device("cuda", 0)
    perm_d, grouped_d, bins_d = (torch.from_numpy(x).to(device) for x in (perm, grouped, bins))
    g = torch.randn((L, D), device=device)
    cw16, g16 = torch.zeros((C, D), dtype=torch.bfloat16, device=device), g.bfloat16()
    if heavy_runs(torch.from_numpy(np.sort(v)), torch.bfloat16) != 1:
        raise AssertionError("the plan, once sorted, has no heavy run")
    try:
        if kernel == "binned_sgd":
            binned_sgd_update(torch.zeros((C, D), device=device), g, perm_d, grouped_d, bins_d, 1.0)
        elif kernel == "binned_scatter_add":
            binned_scatter_add(g, perm_d, grouped_d, bins_d, C)
        elif kernel == "ordered_scatter_add":
            ordered_scatter_add_(cw16, g16, perm_d, grouped_d, 1.0)
        else:
            ordered_grad_update_(cw16, None, g16, perm_d, grouped_d, 1.0)
        torch.cuda.synchronize()
    except RuntimeError as e:
        if "device-side assert" in str(e):
            return 0
        raise
    return 1


def start_unsorted_plan_checks() -> dict:
    """Phase 8's child processes, one per kernel (a device-side assert ends
    its process's CUDA context)."""
    return {k: subprocess.Popen([sys.executable, __file__, "--unsorted-plan", k], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k in UNSORTED_PLAN_KERNELS}


def finish_unsorted_plan_checks(procs: dict) -> None:
    for k, p in procs.items():
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"{k} took a plan not sorted by id (exit {p.returncode}): {err[-3000:]}")
        log(f"[plan check] {k}: a plan grouped by bin but not sorted by id stopped the kernel "
            f"with a device-side assert")


# phase 2's small slices: name -> (cache rows, DLRMConfig fields, CacheConfig
# fields, the update wrappers the card's run launches, once a step)
REFERENCE_SLICES = {
    "float32": ("float32", {}, {}, ("binned_sgd",)),
    FP8: (FP8, {}, {}, ("binned_scatter_add", "stochastic_sgd_round")),
    "adagrad float32": ("float32", {"embedding_optimizer": "rowwise_adagrad", "learning_rate": 0.1}, {},
                        ("binned_adagrad",)),
    "sparse bfloat16": ("bfloat16", {"use_sparse_embed_grad": True}, {"ship_sort_perm": False},
                        ("ordered_scatter_add",)),
    "float8_e4m3fn rounding off": (FP8, {}, {"stochastic_rounding": "off"}, ("binned_sgd",)),
    "float8_e5m2 rounding on": (E5M2, {}, {}, ("binned_scatter_add", "stochastic_sgd_round")),
    # ragged windows (RAGGED_SLICE: tests/test_ragged_window.py's shape) and DLRM's gather interaction
    "ragged bfloat16": ("bfloat16", {}, {}, ("ordered_grad_update",)),
    "ragged adagrad float32": ("float32", {"embedding_optimizer": "rowwise_adagrad", "learning_rate": 0.1}, {},
                               ("ordered_grad_update",)),
    "ragged sparse bfloat16": ("bfloat16", {"use_sparse_embed_grad": True}, {}, ("ordered_scatter_add",)),
    "ragged float8_e4m3fn rounding on": (FP8, {}, {"stochastic_rounding": "on"}, ("ordered_grad_update",)),
    "ragged mean": ("bfloat16", {"reduction_mode": "mean"}, {}, ("ordered_grad_update",)),
    "gather interaction bfloat16": ("bfloat16", {"interaction_impl": "gather"}, {}, ("binned_sgd",)),
    # the window wire: quantized dense inputs and admit payloads, and each id
    # wire with its learning shortened (the wire's attributes, then the format
    # its frozen windows must ship)
    "int8 dense": ("bfloat16", {"dense_input_dtype": "int8"}, {}, ("binned_sgd",)),
    "int4 dense": ("bfloat16", {"dense_input_dtype": "int4"}, {}, ("binned_sgd",)),
    "int8 transfer float32": ("float32", {}, {"transfer_dtype": "int8"}, ("binned_sgd",)),
    "int4 transfer bfloat16": ("bfloat16", {}, {"transfer_dtype": "int4"}, ("binned_sgd",)),
    "plain wire": ("bfloat16", {}, {"id_wire": "plain"}, ("binned_sgd",), {}, "plain"),
    "escape wire": ("bfloat16", {}, {"id_wire": "escape"}, ("binned_sgd",), {"_esc_learn_windows": 2}, "esc"),
    "ranktier wire": ("bfloat16", {}, {"id_wire": "ranktier"}, ("binned_sgd",),
                      {"_RT_SKIP_WINDOWS": 1, "_RT_LEARN_WINDOWS": 4}, "rt"),
}
# the ragged small slices: 3 tables of 500 rows, bags of 0-5 ids, rows * u**2 ids,
# batch 64, prefetch 2, a cache of half the rows (750 slots) with no resident region
RAGGED_SLICE = dict(tables=[500, 500, 500], batch=64, prefetch=2, cache_ratio=0.5)


def phase_reference(device, name: str) -> dict:
    """The slice ``name`` of REFERENCE_SLICES at a small width with f32
    compute, once on the card (through the kernels) and once on the CPU
    (through their plain versions), on the same seeded stream; the gates are
    in the module docstring (phase 2). The windows, through a cache smaller
    than the rows they touch, evict trained rows and admit them again, so a
    writeback that read a slot out of order (before the previous window's
    update, or after this window's admits) would show. Returns what the
    gates measured."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
    from cachedembedding_tpu_torch.data.synth import SynthTraceDataset
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.ops.rounding import storage_steps
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    cache_dtype, cfg_kw, cache_kw, entries, *wire_kw = REFERENCE_SLICES[name]
    wire_attrs, wire_format = wire_kw or ({}, None)
    ragged = name.startswith("ragged")
    if ragged:
        tables, B, P, ratio = (RAGGED_SLICE[k] for k in ("tables", "batch", "prefetch", "cache_ratio"))
        resident = 0
    else:
        tables, B, P, ratio, resident = [50, 300, 4000, 20000], 256, 4, 0.02, 500
    steps = 24
    cfg = DLRMConfig(
        num_embeddings_per_feature=tables, embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1),
        batch_size=B, compute_dtype="float32", **{"learning_rate": 1.0, **cfg_kw},
        cache=CacheConfig(**{
            "cache_ratio": ratio, "resident_threshold": resident, "prefetch_num": P, "weight_init": "virtual",
            "ship_sort_perm": True, "use_pallas_lookup": True, "cache_dtype": cache_dtype, **cache_kw,
        }),
    )
    if ragged:
        rng = np.random.default_rng(5)
        traces = []
        for n in tables:
            offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 6, 4096))])
            traces.append((np.minimum((n * rng.random(offsets[-1]) ** 2).astype(np.int64), n - 1), offsets))
        train = SynthTraceDataset(traces, tables, B, steps, dense_in_features=13, seed=7)
        test = SynthTraceDataset(traces, tables, B, 4, dense_in_features=13, seed=99)
    else:
        train = SyntheticLongTailDataset(tables, B, steps, dense_in_features=13, skew=0.5, seed=7)
        test = SyntheticLongTailDataset(tables, B, 4, dense_in_features=13, skew=0.5, seed=99)
    batches = list(train)
    touched = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in batches]))
    first = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in batches[:P]]))
    tag = f"[reference {name}]"
    runs = []
    for dev in (device, "cpu"):
        tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=dev)
        for k, v in wire_attrs.items():
            setattr(tr.wire, k, v)
        zero_launch_counts()
        rep = tr.train(batches, num_iters=steps)
        if dev == device:
            check_update_launches(tag, ops.launch_counts(), steps, *entries)
        formats = [w["format"] for w in rep.window_wire]
        if wire_format and formats[-1] != wire_format:
            raise AssertionError(f"{tag} the last window shipped {formats[-1]}, not {wire_format}: {formats}")
        emb = tr.embed
        # trained in the first window, written back on eviction, and in the
        # cache again at the end: evicted and admitted again
        emb._drain_writebacks()
        _, cached_rows = emb._dir.resident()
        again = first[emb.host_table.written_mask(first) & np.isin(first, cached_rows)]
        ev = tr.evaluate(test)
        s = emb.stats
        counts = (s.num_hits_history, s.num_miss_history, s.num_write_back_history)
        weights = [p.detach().cpu().numpy() for p in tr.model.parameters()]
        rows = emb.dense_weight(touched)  # flushes
        acc = None if emb.host_accum is None else emb.host_accum.gather(touched)
        tr.close()
        runs.append((np.asarray(rep.losses), ev["auroc"], counts, weights, rows, again, acc))
    (lg, ag, cg, wg, rg, xg, accg), (lc, ac, cc, wc, rc, xc, accc) = runs
    if cg != cc:
        raise AssertionError(f"{tag} cache counts differ between the card and the CPU: {cg} vs {cc}")
    if not np.array_equal(xg, xc) or xg.size == 0:
        raise AssertionError(f"{tag} no trained row was evicted and admitted again ({xg.size} vs {xc.size})")
    if lg.shape != (steps,) or not np.isfinite(lg).all():
        raise AssertionError(f"{tag} losses not finite: {lg}")
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    w_rel = max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-7))) for a, b in zip(wg, wc))
    out = {"loss_max_rel": rel, "weights_max_rel": w_rel, "auroc": (ag, ac), "writebacks": sum(cg[2]),
           "evicted_and_admitted_again": int(xg.size)}
    if cache_dtype != "float32":
        dt = getattr(torch, cache_dtype)
        steps_off = storage_steps(*(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (rg, rc)),
                                  dt).numpy()
        equal = float((steps_off == 0).mean())
        if not np.allclose(lg, lc, rtol=1e-3, atol=0):
            raise AssertionError(f"{tag} losses differ between the card and the CPU: {lg} vs {lc}")
        if equal < 0.999 or int(steps_off.max()) > 2:
            raise AssertionError(f"{tag} flushed rows: {equal:.5f} of elements equal, "
                                 f"up to {int(steps_off.max())} {cache_dtype} steps apart")
        out.update(flushed_equal_share=equal, flushed_max_steps=int(steps_off.max()))
        rows_msg = (f"{equal * 100:.3f}% of {rg.size} flushed elements equal, {int((steps_off > 0).sum())} one "
                    f"or two {cache_dtype} steps apart (max {int(steps_off.max())})")
    else:
        if not np.allclose(lg, lc, rtol=1e-4, atol=0):
            raise AssertionError(f"{tag} losses differ between the card and the CPU: {lg} vs {lc}")
        if abs(ag - ac) > 1e-4:
            raise AssertionError(f"{tag} AUROC differs between the card and the CPU: {ag} vs {ac}")
        for a, b in zip(wg, wc):
            if not np.allclose(a, b, rtol=1e-4, atol=1e-7):
                raise AssertionError(f"{tag} dense weights differ between the card and the CPU")
        row_err = float(np.abs(rg - rc).max())
        if row_err > 1e-5:
            raise AssertionError(f"{tag} flushed rows differ between the card and the CPU by {row_err}")
        out["flushed_max_abs_diff"] = row_err
        rows_msg = f"{touched.size} trained rows max abs diff {row_err:.2e}"
    if accg is not None:
        acc_rel = float(np.max(np.abs(accg - accc) / np.maximum(np.abs(accc), 1e-12)))
        if not np.allclose(accg, accc, rtol=1e-4, atol=1e-9) or not (accg > 0).any():
            raise AssertionError(f"{tag} flushed accumulators differ between the card and the CPU (max rel "
                                 f"{acc_rel:.2e}) or none grew")
        out["accum_max_rel"] = acc_rel
        rows_msg += f"; {int((accg > 0).sum())} accumulators grew, max rel diff {acc_rel:.2e}"
    if wire_format:
        out["formats"] = formats
        rows_msg += f"; id formats {formats}"
    log(f"{tag} small slice, card vs CPU: counts equal, {sum(cg[2])} writebacks, "
        f"{xg.size} trained rows evicted and admitted again; {rows_msg}; loss max rel diff "
        f"{rel:.2e}; dense weights max rel diff {w_rel:.2e}; auroc {ag:.6f} vs {ac:.6f}")
    return out


def phase_slice(cfg, device):
    """Drive a full-width slice through its entry points with the launch
    counts zeroed just before. Returns the counts, the trainer (still open),
    its first training window and, where the update rounds stochastically,
    the first step's (cache rows before the update, row grads, slr, seed),
    which the kernel phases read."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    tag = f"[slice {cfg.cache.cache_dtype}]"
    steps, P = 24, cfg.cache.prefetch_num
    sizes = cfg.num_embeddings_per_feature
    train = SyntheticLongTailDataset(sizes, cfg.batch_size, steps, skew=0.5, seed=7)
    test = SyntheticLongTailDataset(sizes, cfg.batch_size, P, skew=0.5, seed=8)
    t0 = time.perf_counter()
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    torch.cuda.synchronize()
    log(f"{tag} trainer built in {time.perf_counter() - t0:.1f} s: capacity "
        f"{tr.embed.capacity}, device rows {tr.embed.device_rows}, rows {tr.embed.cache_weight.dtype}")
    first_win, first_update, peaks = [], [], []
    begin = tr._begin_window

    def begin_and_keep(batches, with_plan=True, dense_mode=None):
        win = begin(batches, with_plan, dense_mode)
        if not first_win:
            first_win.append(win)
        return win

    tr._begin_window = begin_and_keep
    if tr._sr:
        sr_update = tr._sr_update

        def sr_update_and_keep(cw, g_rows, perm, grouped, bins, slr, seed, *branch):
            if first_update:
                return sr_update(cw, g_rows, perm, grouped, bins, slr, seed, *branch)
            # the first step: its inputs copied to pinned host memory in stream
            # order (no device copy in the peak), the device peak read around its update
            keep = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                    for t in (cw, g_rows.detach())]
            first_update.append((*keep, slr, seed))
            peaks.append(torch.cuda.max_memory_allocated(device))
            sr_update(cw, g_rows, perm, grouped, bins, slr, seed, *branch)
            peaks.append(torch.cuda.max_memory_allocated(device))
            return None

        tr._sr_update = sr_update_and_keep
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    rep = tr.train(train, num_iters=steps)
    t1 = time.perf_counter()
    ev = tr.evaluate(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    losses = np.asarray(rep.losses)
    per_window = [float(x) for x in losses.reshape(-1, P).mean(axis=1)]
    log(f"{tag} loss per window {per_window}")
    log(f"{tag} hit rate {rep.hit_rate:.4f}; {rep.examples_per_s:.0f} examples/s "
        f"({rep.it_per_s:.2f} it/s) over {steps} steps; peak device memory {peak / 2**30:.2f} GiB"
        + (f" ({peaks[0] / 2**30:.2f} GiB before the first step's update, {peaks[1] / 2**30:.2f} after it)"
           if peaks else ""))
    log(f"{tag} host s/window {[round(x, 4) for x in rep.window_host_s]}; "
        f"device s/window {[round(x, 4) for x in rep.window_device_s]}")
    log(f"{tag} eval of {ev['count']} examples in {eval_s:.2f} s: auroc {ev['auroc']:.4f}")
    SLICE_NUMBERS[cfg.cache.cache_dtype] = {
        "host_s_window": rep.window_host_s, "device_s_window": rep.window_device_s,
        "plan_host_ms_step": 1e3 * sum(rep.window_plan_s) / steps, "examples_per_s": rep.examples_per_s,
        "peak_gib": peak / 2**30, "hit_rate": rep.hit_rate}
    log(f"{tag} kernel launches {launches}")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if not 0.0 < rep.hit_rate <= 1.0:
        raise AssertionError(f"{tag} hit rate {rep.hit_rate} outside (0, 1]")
    if launches["gather_rows"] < steps + P:
        raise AssertionError(f"{tag} kernel gather_rows launched {launches['gather_rows']} times: {launches}")
    check_update_launches(tag, launches, steps,
                          *(("binned_scatter_add", "stochastic_sgd_round") if tr._sr else ("binned_sgd",)))
    if ev["count"] != P * cfg.batch_size or not np.isfinite(ev["auroc"]):
        raise AssertionError(f"{tag} bad eval: {ev}")
    from cachedembedding_tpu_torch.slice_ab import profile_window

    prof = profile_window(tr, cfg)
    log(f"{tag} one more training window under torch.profiler: {json.dumps(prof)}")
    check_flush(tr, tag)
    first = None
    if first_update:
        cw0, g0, slr, seed = first_update[0]
        first = (cw0.to(device), g0.to(device), slr, seed)
    return launches, tr, first_win[0], first


# scripts/terabyte.sh's flags with prefetch 8; the directory name picks the
# Criteo-1TB tables and is never read (the batches are synthetic)
TERABYTE_FLAGS = ["--dataset_dir", "criteo_1tb", "--batch_size", "16384", "--learning_rate", "1.0", "--use_cache",
                  "--cache_ratio", "0.01", "--use_freq", "--use_overlap", "--prefetch_num", "8",
                  "--transfer_dtype", "bfloat16"]


def phase_terabyte(device) -> tuple:
    """The sparse-gradient branch at Criteo-1TB width: the trainer built from
    terabyte.sh's flags (26 tables, 177,944,275 rows, D=128, batch 16,384, a
    1% cache of 1,779,442 bf16 rows and no resident region, bf16 transfers,
    prefetch 8), driven directly so that the host table can be virtual (its
    memory the touched rows, not a 91 GB dense table). Its device rows
    exceed 4x a step's 425,984 ids, so the update is the ordered scatter.
    Trains 24 steps, evaluates one window and flushes, with the launch
    counts zeroed just before; then one more window under torch.profiler,
    and the ordered scatter on the first step (``check_ordered_scatter``).
    Returns the path's launch counts and the kernel's entry."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.slice_ab import profile_window
    from cachedembedding_tpu_torch.train import dlrm_main
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer, update_branch

    tag = "[1tb sparse]"
    cfg = dlrm_main.build_config(dlrm_main.parse_args(TERABYTE_FLAGS))
    cfg.cache.weight_init = "virtual"
    steps, P, B, F = 24, cfg.cache.prefetch_num, cfg.batch_size, cfg.num_sparse_features
    sizes = cfg.num_embeddings_per_feature
    t0 = time.perf_counter()
    train = SyntheticLongTailDataset(sizes, B, steps, skew=0.5, seed=7)
    test = SyntheticLongTailDataset(sizes, B, P, skew=0.5, seed=8)
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    torch.cuda.synchronize()
    branch = update_branch(cfg, False, tr.embed.device_rows, B * F)
    log(f"{tag} trainer built in {time.perf_counter() - t0:.1f} s: {sum(sizes)} rows, capacity "
        f"{tr.embed.capacity}, device rows {tr.embed.device_rows} against 4 x {B * F} ids a step; rows "
        f"{tr.embed.cache_weight.dtype}; update branch {branch}")
    if branch != "sparse":
        raise AssertionError(f"{tag} the update branch is {branch}, not sparse")
    first, update = [], tr._update

    def update_and_keep(cw, g_rows, perm, grouped, bins, slr, branch):
        if not first:  # the first step's inputs: the rows before the update
            first.append((cw.clone(), g_rows.detach().clone(), perm, grouped, slr))
        return update(cw, g_rows, perm, grouped, bins, slr, branch)

    tr._update = update_and_keep
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    rep = tr.train(train, num_iters=steps)
    t1 = time.perf_counter()
    ev = tr.evaluate(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    tr._update = update
    losses = np.asarray(rep.losses)
    log(f"{tag} loss per window {[float(x) for x in losses.reshape(-1, P).mean(axis=1)]}; hit rate "
        f"{rep.hit_rate:.4f}; {rep.examples_per_s:.0f} examples/s over {steps} steps; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    log(f"{tag} host s/window {[round(x, 4) for x in rep.window_host_s]}; device s/window "
        f"{[round(x, 4) for x in rep.window_device_s]}; plan host ms/step "
        f"{1e3 * sum(rep.window_plan_s) / steps:.2f}; eval of {ev['count']} in {eval_s:.2f} s: auroc "
        f"{ev['auroc']:.4f}; kernel launches {launches}")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if not 0.0 < rep.hit_rate <= 1.0 or ev["count"] != P * B or not np.isfinite(ev["auroc"]):
        raise AssertionError(f"{tag} hit rate {rep.hit_rate}, eval {ev}")
    if launches["gather_rows"] < steps + P:
        raise AssertionError(f"{tag} kernel launches {launches}")
    check_update_launches(tag, launches, steps, "ordered_scatter_add")
    prof = profile_window(tr, cfg)
    log(f"{tag} one more training window under torch.profiler: {json.dumps(prof)}")
    check_flush(tr, tag)
    tr.close()
    del tr
    gc.collect()
    k5 = check_ordered_scatter(*first[0])
    k5["window"] = {"host_s": rep.window_host_s, "device_s": rep.window_device_s, "profiled": prof}
    return launches, k5


def visible_run_faults(g_run, a_run, dt, finish) -> tuple:
    """Planted faults for a gate on one run of Kernel 5: its addends
    ``a_run`` ((n, D) f32 on the host, as the kernel adds them) summed one
    rounded add at a time from a zero row; ``finish`` maps the final sum to
    the row the function writes. Each fault must change that row (an
    absorbed addend is no fault): the run's trajectory on the host finds the
    last addend whose removal changes it, the last pair of nearby addends
    (one of them moving the sum) whose swap changes it, and the same for the
    kernel's ring: the last stage (32 contributors from the run's start)
    whose skipping changes it, and the last pair of adjacent stages whose
    swap does. Returns ({fault: ``g_run`` with the fault}, the positions
    whose add moves the sum)."""
    import torch

    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    n = a_run.shape[0]
    states = [torch.zeros_like(a_run[:1])]
    for i in range(n):
        states.append(astype_storage(states[-1] + a_run[i], dt).float())
    moving = [i for i in range(n) if not torch.equal(states[i + 1], states[i])]
    target = finish(states[n])

    def final(w, order):
        for i in order:
            w = astype_storage(w + a_run[i], dt).float()
        return finish(w)

    faults = {}
    for i in reversed(moving[-16:]):
        if not torch.equal(final(states[i], range(i + 1, n)), target):
            dropped = g_run.clone()
            dropped[i] = 0
            faults[f"addend {i} of {n} dropped"] = dropped
            break
    pairs = [(min(i, j), max(i, j)) for i in reversed(moving[-8:]) for j in range(i - 8, i + 9)
             if 0 <= j < n and j != i]
    for i, j in pairs:  # a_j in a_i's place, a_i in a_j's
        if not torch.equal(final(states[i], [j, *range(i + 1, j), i, *range(j + 1, n)]), target):
            swapped = g_run.clone()
            swapped[[i, j]] = g_run[[j, i]]
            faults[f"addends {i} and {j} of {n} swapped"] = swapped
            break
    # faults of the kernel's ring: a stage (32 contributors of the run) skipped, two stages swapped
    stages = -(-n // 32)
    moving_stages = sorted({i // 32 for i in moving})
    for k in reversed(moving_stages[-16:]):
        if not torch.equal(final(states[32 * k], range(min(32 * k + 32, n), n)), target):
            skipped = g_run.clone()
            skipped[32 * k:32 * k + 32] = 0  # a zero addend adds nothing: the stage is skipped
            faults[f"stage {k} of {stages} skipped"] = skipped
            break
    for k in reversed(moving_stages[-16:]):
        for a, b in ((k - 1, k), (k, k + 1)):
            if a < 0 or b >= stages:
                continue
            end = min(32 * b + 32, n)
            seg = [*range(32 * b, end), *range(32 * a, 32 * a + 32)]  # stage b, then stage a
            if not torch.equal(final(states[32 * a], [*seg, *range(end, n)]), target):
                swapped = g_run.clone()
                swapped[32 * a:end] = g_run[seg]
                faults[f"stages {a} and {b} of {stages} swapped"] = swapped
                break
        if len(faults) == 4:
            break
    if len(faults) != 4:
        raise AssertionError(f"no visible fault of each kind in the heaviest run ({n} ids, {len(moving)} addends "
                             f"move a zero row): {list(faults)}")
    return faults, moving


def int_view(t):
    """The bits of a tensor of 4-, 2- or 1-byte elements, for bit equality (NaN included)."""
    import torch

    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()])


def check_ordered_run_cases(device) -> dict:
    """Kernel 5 on its run-shape cases (``ordered_run_cases``: runs of 1, 31,
    32, 33, 255, 256, 257, 385, 513 and 3,000 contributors, four of them
    heavy) for f32, bf16, e4m3fn and e5m2 rows: the scatter and SGD entries
    at D = 128 and D = 32 (four elements a lane), D = 18 and D = 128 with the
    grads one element off 16-byte alignment (one element a lane), the
    Adagrad entry at D = 128 and 32. Each launch bit-equal to the plain
    version (rows and accumulators) and to a second launch, with the four
    heavy runs sent through the ring (the kernel's count; f32 rows take no
    ring). The Adagrad entry must refuse D > 128."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np
    from cachedembedding_tpu_torch.ops.ordered_scatter import (
        ORDERED_ADAGRAD_SHAPES,
        heavy_runs,
        last_heavy_runs,
        ordered_grad_update_,
        ordered_grad_update_plain,
        ordered_run_cases,
        ordered_scatter_add_,
        ordered_scatter_add_plain,
    )
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    t0 = time.perf_counter()
    checked = []
    for shape, case in ordered_run_cases(0):
        (C, D), L = case["cw0"].shape, case["v"].shape[0]
        perm, grouped, _ = (torch.from_numpy(a).to(device) for a in sort_plan_np(case["v"], C))
        slr, eps, off = case["slr"], case["eps"], case["offset"]
        for name in ("float32", "bfloat16", FP8, E5M2):
            dt = getattr(torch, name)
            want_heavy = heavy_runs(grouped, dt)
            cw0 = astype_storage(torch.from_numpy(case["cw0"]).to(device), dt)
            g = torch.empty(L * D + off, dtype=dt, device=device)[off:].view(L, D)
            g.copy_(astype_storage(torch.from_numpy(case["g"]).to(device), dt))
            if (g.data_ptr() % 16 == 0) != (off == 0):
                raise AssertionError(f"run case {shape}: grads at {g.data_ptr()}")
            acc0 = torch.from_numpy(case["acc0"]).to(device)
            entries = {
                "scatter": (lambda f, cw, acc: f(cw, g, perm, grouped, slr),
                            ordered_scatter_add_, ordered_scatter_add_plain, False),
                "sgd": (lambda f, cw, acc: f(cw, None, g, perm, grouped, slr),
                        ordered_grad_update_, ordered_grad_update_plain, False),
            }
            if shape in ORDERED_ADAGRAD_SHAPES:
                entries["adagrad"] = (lambda f, cw, acc: f(cw, acc, g, perm, grouped, slr, eps),
                                      ordered_grad_update_, ordered_grad_update_plain, True)
            for entry, (call, kernel, plain, adagrad) in entries.items():
                tag = f"run case {shape} {name} {entry}"
                outs = []
                for _ in range(2):
                    cw, acc = cw0.clone(), acc0.clone() if adagrad else None
                    call(kernel, cw, acc)
                    torch.cuda.synchronize()
                    if last_heavy_runs() != want_heavy:
                        raise AssertionError(f"{tag}: {last_heavy_runs()} heavy runs, the plan has {want_heavy}")
                    outs.append((cw, acc))
                cw_p, acc_p = cw0.clone(), acc0.clone() if adagrad else None
                call(plain, cw_p, acc_p)
                for what, x in (("a second launch", outs[1]), ("the plain version", (cw_p, acc_p))):
                    if not torch.equal(int_view(outs[0][0]), int_view(x[0])):
                        n_bad = int((int_view(outs[0][0]) != int_view(x[0])).sum())
                        raise AssertionError(f"{tag}: rows differ from {what} in {n_bad} elements")
                    if adagrad and not torch.equal(int_view(outs[0][1]), int_view(x[1])):
                        raise AssertionError(f"{tag}: accumulators differ from {what}")
                checked.append(f"{shape} {name} {entry}")
    cw = torch.zeros((4, 136), device=device)
    perm, grouped = (torch.tensor([0, 1], dtype=torch.int32, device=device) for _ in range(2))
    try:
        ordered_grad_update_(cw, torch.zeros(4, device=device), torch.zeros((2, 136), device=device), perm,
                             grouped, 1.0)
        raise AssertionError("the Adagrad entry took D = 136")
    except ValueError:
        pass
    out = {"cases": len(checked), "heavy_runs_each_ring_dtype": want_heavy,
           "seconds": time.perf_counter() - t0,
           "tolerance": "bit-exact against the plain version (rows, accumulators); two launches bit-identical"}
    log(f"[kernel] ordered run cases: {len(checked)} cases bit-equal to the plain version and across launches, "
        f"{want_heavy} heavy runs each; the Adagrad entry refuses D = 136; {json.dumps(out)}; {checked}")
    return out


def check_bf16_add_sweep(device) -> dict:
    """Kernel 5's bf16 chain adds with the card's bf16 add (one rounding of
    the exact sum) where the function is the f32 add then the cast to bf16
    (two): the two must agree on all 2^32 pairs of bf16 operands, NaN
    included, bit for bit."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import bf16_add_sweep

    bf16_add_sweep(device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bad, nan = bf16_add_sweep(device)
    secs = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"the bf16 chain's add differs from the f32 add and cast on {bad} of 2^32 pairs "
                             f"({nan} of them NaN both ways)")
    out = {"pairs": 1 << 32, "differing": bad, "seconds": secs}
    log(f"[kernel] ordered_scatter_add's bf16 chain: add.rn.bf16x2 equals the f32 add then the cast on all 2^32 "
        f"pairs of bf16 operands; {json.dumps(out)}")
    return out


def one_grad_row_ns(entry: str, n: int, D: int, device) -> dict:
    """Kernel 5's rate on one run with memory out of the picture, by row
    dtype: the entry on one run of n contributors into one row, every
    contributor reading grad row 0, device ms / n, in ns. Its ring's pace
    (each stage's hand-over, read and adds) for bf16 and fp8 rows; the light
    walk's for f32 rows, which take no ring."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_grad_update_, ordered_scatter_add_
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    perm = torch.zeros(n, dtype=torch.int32, device=device)
    grouped = torch.zeros(n, dtype=torch.int32, device=device)
    g0 = torch.randn(D, generator=torch.Generator().manual_seed(0)) * 0.01
    out = {}
    for name in ("float32", "bfloat16", FP8, E5M2):
        dt = getattr(torch, name)
        g = torch.zeros((n, D), dtype=dt, device=device)
        g[0] = astype_storage(g0.to(device), dt)
        row = torch.zeros((1, D), dtype=dt, device=device)
        if entry == "ordered_scatter_add":
            out[name] = device_median_ms(lambda: ordered_scatter_add_(row, g, perm, grouped, 0.5)) * 1e6 / n
        else:
            out[name] = device_median_ms(lambda: ordered_grad_update_(row, None, g, perm, grouped, 0.5)) * 1e6 / n
    return out


CHAIN_LINKS = 1 << 18  # dependent links a lane in chain_latency_ns: about 0.5-10 device ms


def chain_latency_ns(device) -> dict:
    """The chain bound's time an add, by row dtype: Kernel 5's link (the f32
    add then the cast to the rows' dtype; bf16's one add) run CHAIN_LINKS
    times in dependence, in registers (``chain_latency``: no memory, no ring,
    no hand-over), device ms / CHAIN_LINKS, in ns. Each dtype's links are
    first held bit for bit against the same 64 links on the host."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import chain_latency
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    gen = torch.Generator().manual_seed(0)
    out = {}
    for name in ("float32", "bfloat16", FP8, E5M2):
        dt = getattr(torch, name)
        a = astype_storage(torch.randn((32, 8), generator=gen) * 0.05, dt).float()
        w = torch.zeros(32)
        for i in range(64):
            w = astype_storage(w + a[:, i % 8], dt).float()
        a_d = a.to(device)
        got = chain_latency(a_d, 64, dt).cpu()
        if not torch.equal(int_view(got), int_view(w)):
            raise AssertionError(f"chain_latency's {name} links differ from the same links on the host: "
                                 f"{got.tolist()} against {w.tolist()}")
        out[name] = device_median_ms(lambda: chain_latency(a_d, CHAIN_LINKS, dt)) * 1e6 / CHAIN_LINKS
    return out


def light_part_plan(g, perm, grouped):
    """The step's plan without its heavy runs (more than heavy_threshold(L)
    contributors): the light runs' grads in their stream order, the plan
    renumbered to them."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import heavy_threshold

    _, inv, counts = torch.unique_consecutive(grouped, return_inverse=True, return_counts=True)
    light = counts[inv] <= heavy_threshold(grouped.shape[0])
    src = perm[light].long()
    keep = torch.zeros(grouped.shape[0], dtype=torch.bool, device=g.device)
    keep[src] = True
    pos = torch.cumsum(keep, 0) - 1
    return g[keep].contiguous(), pos[src].int(), grouped[light].contiguous()


def kernel5_design_numbers(entry: str, call, cw0, g, perm, grouped, n: int, device_ms: float,
                           bytes_bound_ms: float) -> dict:
    """The ring design's numbers for one of Kernel 5's entries on a step;
    ``call(cw, g, perm, grouped)`` launches it. The heavy runs that the step's
    launch sent through the ring (the kernel's count: non-zero, and the
    plan's); the chain bound of the step's heaviest run (n contributors) at
    the rows' dtype, n times the link's latency in registers
    (``chain_latency_ns``), with the entry's share of it beside its share of
    the bytes bound; the entry's own rate on that run with memory out of the
    picture (``one_grad_row_ns``: the ring's pace); the light part alone
    (``light_part_plan``) beside its bytes bound."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import heavy_runs, heavy_threshold, last_heavy_runs

    L, D = g.shape
    call(cw0.clone(), g, perm, grouped)
    torch.cuda.synchronize()
    found, want = last_heavy_runs(), heavy_runs(grouped, cw0.dtype)
    if found != want or found == 0:
        raise AssertionError(f"{entry}: the step's launch found {found} heavy runs, its plan has {want}")
    chain = chain_latency_ns(g.device)
    one_row = one_grad_row_ns(entry, n, D, g.device)
    name = str(cw0.dtype).removeprefix("torch.")
    chain_bound_ms = n * chain[name] * 1e-6
    g_l, perm_l, grouped_l = light_part_plan(g, perm, grouped)
    L_l, touched_l = g_l.shape[0], int(torch.unique_consecutive(grouped_l).numel())
    cw_l = cw0.clone()
    light_device_ms = device_median_ms(lambda: call(cw_l, g_l, perm_l, grouped_l))
    light_bound_ms = (L_l * D * g.element_size() + 2 * L_l * 4 + 2 * touched_l * D * cw0.element_size()) \
        / HBM_BYTES_PER_S * 1e3
    out = dict(
        heavy_threshold=heavy_threshold(L), heavy_runs=found,
        chain_ns_per_add=chain, chain_bound_ms=chain_bound_ms,
        chain_bound_by=f"{n} dependent adds in {name}, in registers",
        share_of_bytes_bound=bytes_bound_ms / device_ms, share_of_chain_bound=chain_bound_ms / device_ms,
        one_grad_row_ns_per_add=one_row, one_grad_row_ms=n * one_row[name] * 1e-6,
        light_part=dict(ids=L_l, touched_rows=touched_l, ms=median_ms(lambda: call(cw_l, g_l, perm_l, grouped_l)),
                        device_ms=light_device_ms, bound_ms=light_bound_ms, share=light_bound_ms / light_device_ms),
    )
    log(f"[kernel] {entry}: {found} heavy runs through the ring (threshold {out['heavy_threshold']}); chain "
        f"{json.dumps(chain)} ns an add in registers, {json.dumps(one_row)} on one grad row; {json.dumps(out)}")
    return out


# Kernel 5 built from another source (``--kernel5-against``): {entry: C function}
KERNEL5_AGAINST: dict = {}


def build_kernel5_against(source) -> dict:
    """Kernel 5 built from ``source``: an ordered_scatter_add.cu (an earlier
    one, say) with this checkout's C interface for its two entries
    (``ops/_cuda.py``), compiled beside this checkout's headers. Returns
    {entry: C function}."""
    import ctypes

    from cachedembedding_tpu_torch import _build
    from cachedembedding_tpu_torch.ops import _cuda

    include = ["-I", str(_cuda.SOURCES["ordered_scatter_add"].parent)]
    path, secs, _ = _build.build("libordered_scatter_add_against", [source],
                                 lambda s, o: [*_build.nvcc_command(s, o), *include], _cuda.HEADERS)
    log(f"[build] {source} (nvcc sm_90a): {secs:.1f} s -> {path.name}")
    lib = ctypes.CDLL(str(path))
    return {e: _cuda.bind(lib, e) for e in ("ordered_scatter_add", "ordered_grad_update")}


def kernel5_against_call(fn, entry: str, slr: float):
    """``call(cw, g, perm, grouped)`` for another build's entry ``fn``, as the
    wrapper calls this build's (a scratch of the interface's size, always)."""
    import torch

    from cachedembedding_tpu_torch.ops import _cuda
    from cachedembedding_tpu_torch.ops.ordered_scatter import _DTYPE_CODES, heavy_threshold

    def call(cw, g, perm, grouped):
        L, D = g.shape
        scratch = torch.empty(1 + L // (heavy_threshold(L) + 1), dtype=torch.int64, device=cw.device)
        ptrs = (g.data_ptr(), perm.data_ptr(), grouped.data_ptr(), L, D)
        if entry == "ordered_scatter_add":
            rc = fn(cw.data_ptr(), *ptrs, -slr, _DTYPE_CODES[cw.dtype], scratch.data_ptr(), _cuda.stream_of(cw))
        else:
            rc = fn(cw.data_ptr(), None, *ptrs, slr, 0.0, _DTYPE_CODES[cw.dtype], scratch.data_ptr(),
                    _cuda.stream_of(cw))
        _cuda.check_launch(f"{entry} (against)", rc)

    return call


def kernel5_against_turns(entry: str, call, cw0, g, perm, grouped, slr: float) -> dict:
    """``--kernel5-against``: Kernel 5's entry ``call(cw, g, perm, grouped)``
    of this build against the same entry of the KERNEL5_AGAINST build, on
    the step as it is and cast to f32 rows and grads (a cache of f32 rows
    takes the same entry): the same bits, then device ms of the step and of
    its heaviest run alone, in turns: the other build, this one twice, the
    other."""
    import torch

    rows, counts = torch.unique_consecutive(grouped, return_counts=True)
    r = int(torch.argmax(counts))
    v, n, start = int(rows[r]), int(counts[r]), int(counts[:r].sum())
    perm_run = torch.arange(n, dtype=torch.int32, device=g.device)
    grouped_run = torch.zeros(n, dtype=torch.int32, device=g.device)
    other = kernel5_against_call(KERNEL5_AGAINST[entry], entry, slr)
    out = {"heaviest_run": n}
    for cw_d, g_d in ((cw0, g), (cw0.float(), g.float())):
        g_run = g_d[perm[start:start + n].long()].contiguous()
        want, got = cw_d.clone(), cw_d.clone()
        call(want, g_d, perm, grouped)
        other(got, g_d, perm, grouped)
        if not torch.equal(int_view(got), int_view(want)):
            raise AssertionError(f"{entry}: the other build and this one differ on the step's {cw_d.dtype} rows")
        turns = []
        for src, fn in (("other", other), ("this", call), ("this", call), ("other", other)):
            cw, row = cw_d.clone(), cw_d[v:v + 1].clone()
            turns.append(dict(kernel=src, device_ms=device_median_ms(lambda: fn(cw, g_d, perm, grouped)),
                              heaviest_run_device_ms=device_median_ms(
                                  lambda: fn(row, g_run, perm_run, grouped_run))))
        out[str(cw_d.dtype).removeprefix("torch.")] = {"same_bits": True, "turns": turns}
        del want, got, g_run
    log(f"[against] {entry}: {json.dumps(out)}")
    return out


def check_ordered_scatter(cw0, g, perm, grouped, slr: float) -> dict:
    """The ordered scatter (Kernel 5) on the 1TB run's first step: its bf16
    rows before the update, its bf16 row grads, its plan. Bit-equal to its
    plain version (the same addends, rounded the same way, in the same
    order) and on two launches. The step's heaviest run is applied alone to
    its row (equal to that row in the step) and to a zero row, where its
    addends are not absorbed (a heavy row of a small table starts far above
    its addends, which bf16 adds then absorb, order or not): there the
    kernel equals its plain version, and the gate, bit equality, is shown
    to reject two planted faults: one addend dropped, and two addends
    swapped (the gate sees order). Timed on the step and on the heaviest
    run alone (serial by definition: each add depends on the one before)."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_scatter_add_, ordered_scatter_add_plain
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    (C, D), L, device, dt = cw0.shape, g.shape[0], cw0.device, cw0.dtype
    i16 = torch.int16
    a = ordered_scatter_add_(cw0.clone(), g, perm, grouped, slr)
    b = ordered_scatter_add_(cw0.clone(), g, perm, grouped, slr)
    t0 = time.perf_counter()
    ref = ordered_scatter_add_plain(cw0.clone(), g, perm, grouped, slr)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(a.view(i16), b.view(i16)):
        raise AssertionError("ordered_scatter_add is not deterministic across launches")
    if not torch.equal(a.view(i16), ref.view(i16)):
        n_bad = int((a.view(i16) != ref.view(i16)).sum())
        raise AssertionError(f"ordered_scatter_add differs from its plain version in {n_bad} elements")
    rows, counts = torch.unique_consecutive(grouped, return_counts=True)
    r = int(torch.argmax(counts))
    v, n, start = int(rows[r]), int(counts[r]), int(counts[:r].sum())
    # the heaviest run alone: one row, its addends in stream order
    g_run = g[perm[start:start + n].long()].contiguous()
    perm_run = torch.arange(n, dtype=torch.int32, device=device)
    grouped_run = torch.zeros(n, dtype=torch.int32, device=device)
    row0, zero = cw0[v:v + 1].clone(), torch.zeros((1, D), dtype=dt, device=device)

    def run(fn, row, gr):
        return fn(row.clone(), gr, perm_run, grouped_run, slr).view(i16)

    if not torch.equal(run(ordered_scatter_add_, row0, g_run), a[v:v + 1].view(i16)):
        raise AssertionError("the heaviest run alone differs from its row in the step")
    want = run(ordered_scatter_add_, zero, g_run)
    if not torch.equal(want, run(ordered_scatter_add_plain, zero, g_run)):
        raise AssertionError("ordered_scatter_add differs from its plain version on the heaviest run into a zero row")
    faults, moving = visible_run_faults(g_run, astype_storage(g_run.float() * -slr, dt).float().cpu(), dt,
                                        lambda w: w)
    for fault, gr in faults.items():  # the gate: the kernel's result against each faulty run's plain version
        if torch.equal(run(ordered_scatter_add_plain, zero, gr), want):
            raise AssertionError(f"the ordered scatter's gate passed a planted fault ({fault})")
    touched = int(rows.numel())
    ids_stream = torch.empty_like(grouped)
    ids_stream[perm.long()] = grouped  # the step's ids in stream order (the grads' order)
    cw_t, row_t, cw_l = cw0.clone(), row0.clone(), cw0.clone()
    entry = dict(
        name="ordered_scatter_add", route="cuda",
        source="cachedembedding_tpu_torch/csrc/ordered_scatter_add.cu",
        replaces="cachedembedding_tpu/train/trainer.py:404 (cw.at[v].add in the sparse-gradient branch, "
                 "an XLA scatter; no Pallas kernel)",
        max_abs_err=0.0,
        ms=median_ms(lambda: ordered_scatter_add_(cw_t, g, perm, grouped, slr)),
        device_ms=device_median_ms(lambda: ordered_scatter_add_(cw_t, g, perm, grouped, slr)),
        plain_ms=plain_s * 1e3,  # one call: it loops once per contributor rank of the heaviest run
        # the grads and the plan read once, each touched row read and written
        bound_ms=(L * D * g.element_size() + 2 * L * 4 + 2 * touched * D * cw0.element_size())
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        # atomic, in no fixed order, bf16 sums: another function, timed as a yardstick
        library_ms=median_ms(lambda: cw_l.index_add_(0, ids_stream.long(), g, alpha=-slr)),
        library="Tensor.index_add_ (atomics: no fixed order)",
        timed_on=f"1tb sparse, first training step ({C} x {D} bf16 rows, {L} ids)",
        tolerance="bit-exact against the plain version; two launches bit-identical",
        touched_rows=touched, heaviest_run=n, planted_faults=list(faults),
        heaviest_run_addends_moving_a_zero_row=len(moving),
        heaviest_run_ms=median_ms(lambda: ordered_scatter_add_(row_t, g_run, perm_run, grouped_run, slr)),
        heaviest_run_device_ms=device_median_ms(lambda: ordered_scatter_add_(row_t, g_run, perm_run, grouped_run, slr)),
    )
    call = lambda c, gg, p, gr: ordered_scatter_add_(c, gg, p, gr, slr)  # noqa: E731
    entry.update(kernel5_design_numbers("ordered_scatter_add", call, cw0, g, perm, grouped, n, entry["device_ms"],
                                        entry["bound_ms"]))
    if KERNEL5_AGAINST:
        entry["against"] = kernel5_against_turns("ordered_scatter_add", call, cw0, g, perm, grouped, slr)
    entry["heaviest_run_share_of_chain_bound"] = entry["chain_bound_ms"] / entry["heaviest_run_device_ms"]
    entry["heaviest_run_share_of_one_grad_row"] = entry["one_grad_row_ms"] / entry["heaviest_run_device_ms"]
    log(f"[kernel] ordered_scatter_add: {touched} touched rows, heaviest run {n} ids (row {v}); bit-equal to its "
        f"plain version and across launches, on the step and on the heaviest run into a zero row; the gate "
        f"rejects all four planted faults; {json.dumps(entry)}")
    return entry


RAGGED_POOL_BAGS = 262_144  # bags a table's pool: 4x the published traces' 65,536, so windows move
RAGGED_MAX_LEN = 8          # bag lengths uniform in [0, 8)
RAGGED_CACHE_RATIO = 0.10   # 0.05 gives 1,659,664 slots, fewer than a window's 2.09M distinct cached ids


def ragged_traces(sizes, seed: int = 0):
    """Per-table trace pools in the replayer's (indices, offsets) format,
    generated from a seed: RAGGED_POOL_BAGS bags a table, lengths uniform in
    [0, RAGGED_MAX_LEN), ids ``rows * u**2`` (tests/test_ragged_window.py's
    law)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    traces = []
    for n in sizes:
        lengths = rng.integers(0, RAGGED_MAX_LEN, RAGGED_POOL_BAGS)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        ids = np.minimum((n * rng.random(offsets[-1]) ** 2).astype(np.int64), n - 1)
        traces.append((ids, offsets))
    return traces


def window_distinct_cached(traces, sizes, resident_threshold: int, B: int, P: int, windows: int) -> list:
    """Distinct ids of the cached tables in each of the first ``windows``
    windows of P batches of B bags."""
    import numpy as np

    out = []
    for w in range(windows):
        n = 0
        for (ids, off), rows in zip(traces, sizes):
            if rows <= resident_threshold:
                continue
            bags = np.arange(w * P * B, (w + 1) * P * B) % (off.shape[0] - 1)
            runs = np.split(bags, np.flatnonzero(np.diff(bags) != 1) + 1)  # consecutive bags: one slice
            n += int(np.unique(np.concatenate([ids[off[r[0]]:off[r[-1] + 1]] for r in runs])).size)
        out.append(n)
    return out


def phase_ragged(device) -> tuple:
    """The ragged path at full width (``ragged``): DLRM at the Kaggle widths
    of ``slice_config`` (26 Criteo-Kaggle tables, 33,762,577 rows, D = 128,
    batch 16,384, bf16 rows and compute, prefetch 8, resident tables <= 500k
    rows) on the fbgemm-trace replayer (``SynthTraceDataset``) over
    generated pools (``ragged_traces``): about 1.49M ids a step, so Vp =
    2,097,152 and a cache of RAGGED_CACHE_RATIO (3,319,328 slots + 569,296
    resident rows, under 4 Vp) takes the dense ragged branch. Trains 24
    steps, evaluates one window and flushes, with the launch counts zeroed
    just before: Kernel 1 and ``ordered_grad_update`` once a step and no
    other update entry; then one more window under torch.profiler, and
    Kernels 1 and 5 on the first step (``check_ordered_grad_update``).
    Returns the path's launch counts, Kernel 1's entry and Kernel 5's."""
    import dataclasses

    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synth import SynthTraceDataset
    from cachedembedding_tpu_torch.slice_ab import profile_window
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    tag = "[ragged]"
    cfg = slice_config("bfloat16")
    cfg.cache = dataclasses.replace(cfg.cache, cache_ratio=RAGGED_CACHE_RATIO)
    steps, P, B = 24, cfg.cache.prefetch_num, cfg.batch_size
    sizes = cfg.num_embeddings_per_feature
    t0 = time.perf_counter()
    traces = ragged_traces(sizes)
    distinct = window_distinct_cached(traces, sizes, cfg.cache.resident_threshold, B, P, steps // P)
    train = SynthTraceDataset(traces, sizes, B, steps, seed=7)
    test = SynthTraceDataset(traces, sizes, B, P, seed=8)
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    torch.cuda.synchronize()
    log(f"{tag} pools of {RAGGED_POOL_BAGS} bags a table and trainer built in {time.perf_counter() - t0:.1f} s: "
        f"capacity {tr.embed.capacity} (cache ratio {RAGGED_CACHE_RATIO}), device rows {tr.embed.device_rows}; "
        f"distinct cached ids a window {distinct}")
    if max(distinct) > tr.embed.capacity:
        raise AssertionError(f"{tag} a window's distinct cached ids exceed the {tr.embed.capacity} slots")
    first, update = [], tr._ragged_update
    begin = tr._begin_window

    def begin_and_keep(batches, with_plan=True, dense_mode=None):
        win = begin(batches, with_plan, dense_mode)
        if with_plan and not first:
            first.append(win)
        return win

    def update_and_keep(cw, g, perm, grouped, bins, slr, branch):
        if len(first) == 1:  # the first step's rows before the update, its grads and plan
            first.append((cw.clone(), g.detach().clone(), perm, grouped, slr, branch))
        return update(cw, g, perm, grouped, bins, slr, branch)

    tr._begin_window, tr._ragged_update = begin_and_keep, update_and_keep
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    rep = tr.train(train, num_iters=steps)
    t1 = time.perf_counter()
    ev = tr.evaluate(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    tr._begin_window, tr._ragged_update = begin, update
    peak = torch.cuda.max_memory_allocated(device)
    win, (cw0, g0, perm0, grouped0, slr, branch) = first
    losses = np.asarray(rep.losses)
    wb = sum(tr.embed.stats.num_write_back_history)
    log(f"{tag} Vp {win.vp}, ids a step {np.diff(win.bounds).tolist()}, update branch {branch}; loss per window "
        f"{[float(x) for x in losses.reshape(-1, P).mean(axis=1)]}; hit rate {rep.hit_rate:.4f}; {wb} writebacks; "
        f"{rep.examples_per_s:.0f} examples/s over {steps} steps; peak device memory {peak / 2**30:.2f} GiB")
    log(f"{tag} host s/window {[round(x, 4) for x in rep.window_host_s]}; device s/window "
        f"{[round(x, 4) for x in rep.window_device_s]}; plan host ms/step {1e3 * sum(rep.window_plan_s) / steps:.2f}; "
        f"eval of {ev['count']} in {eval_s:.2f} s: auroc {ev['auroc']:.4f}; kernel launches {launches}")
    if branch != "dense":
        raise AssertionError(f"{tag} the update branch is {branch} at Vp {win.vp}, not dense")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if not 0.0 < rep.hit_rate <= 1.0 or wb <= 0 or ev["count"] != P * B or not np.isfinite(ev["auroc"]):
        raise AssertionError(f"{tag} hit rate {rep.hit_rate}, {wb} writebacks, eval {ev}")
    if launches["gather_rows"] != steps + P:
        raise AssertionError(f"{tag} kernel launches {launches}")
    check_update_launches(tag, launches, steps, "ordered_grad_update")
    prof = profile_window(tr, cfg, list(SynthTraceDataset(traces, sizes, B, P, seed=9)))
    log(f"{tag} one more training window under torch.profiler: {json.dumps(prof)}")
    check_flush(tr, tag)
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    k1 = check_gather_ragged(cw0, win.step_ids(0))
    k5 = check_ordered_grad_update(cw0, g0, perm0, grouped0, slr)
    k5["window"] = {"host_s": rep.window_host_s, "device_s": rep.window_device_s, "profiled": prof,
                    "examples_per_s": rep.examples_per_s, "peak_gib": peak / 2**30, "hit_rate": rep.hit_rate}
    return launches, k1, k5


def check_gather_ragged(cw, ids) -> dict:
    """Kernel 1 on the ragged path's first step: the flat gather (F = 1) of
    its 1.49M ids from the bf16 rows, bit-equal to its plain version and to
    index_select."""
    import torch

    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

    L, D = ids.shape[0], cw.shape[1]
    out = gather_rows(cw, ids, 1)
    plain = gather_rows_plain(cw, ids, 1)
    if not (torch.equal(out, plain) and torch.equal(out[:, 0], torch.index_select(cw, 0, ids.long()))):
        raise AssertionError("gather_rows differs from index_select on the ragged step")
    n_distinct = int(torch.unique(ids).numel())
    row_bytes = D * cw.element_size()
    entry = dict(
        ms=median_ms(lambda: gather_rows(cw, ids, 1)),
        device_ms=device_median_ms(lambda: gather_rows(cw, ids, 1)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw, ids, 1)),
        bound_ms=(L * 4 + (n_distinct + L) * row_bytes) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=median_ms(lambda: torch.index_select(cw, 0, ids.long())), max_abs_err=0.0,
        timed_on=f"ragged, first training step ({L} ids, {n_distinct} distinct, bf16 rows)",
    )
    log(f"[kernel] gather_rows on the ragged step: equal to index_select; {json.dumps(entry)}")
    return entry


def check_ordered_grad_update(cw0, g, perm, grouped, slr: float) -> dict:
    """Kernel 5's dense ragged entry on the ragged path's first step (its bf16
    rows before the update, its bf16 row grads, its plan): bit-equal to its
    plain version and on two launches. The step's heaviest run is applied
    alone to its row (equal to that row in the step) and to a zero row,
    where the row is -slr times the run's sum: there the kernel equals its
    plain version, and the gate, bit equality, is shown to reject two planted
    faults (one grad dropped, two swapped), each placed where it changes the
    row. Timed on the step and on the heaviest run alone; the yardstick is
    the (C, D) bf16 grad by ``index_add_`` (atomics, no fixed order) into
    zeros, then ``sub_``: JAX's shape of the function, not its values."""
    import torch

    from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_grad_update_, ordered_grad_update_plain
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    (C, D), L, device, dt = cw0.shape, g.shape[0], cw0.device, cw0.dtype
    i16 = torch.int16
    a = ordered_grad_update_(cw0.clone(), None, g, perm, grouped, slr)
    b = ordered_grad_update_(cw0.clone(), None, g, perm, grouped, slr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ordered_grad_update_plain(cw0.clone(), None, g, perm, grouped, slr)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(a.view(i16), b.view(i16)):
        raise AssertionError("ordered_grad_update is not deterministic across launches")
    if not torch.equal(a.view(i16), ref.view(i16)):
        n_bad = int((a.view(i16) != ref.view(i16)).sum())
        raise AssertionError(f"ordered_grad_update differs from its plain version in {n_bad} elements")
    rows, counts = torch.unique_consecutive(grouped, return_counts=True)
    touched = int(rows.numel())
    untouched = torch.ones(C, dtype=torch.bool, device=device)
    untouched[rows.long()] = False
    if not torch.equal(a[untouched].view(i16), cw0[untouched].view(i16)):
        raise AssertionError("ordered_grad_update wrote a row that no id touched")
    r = int(torch.argmax(counts))
    v, n, start = int(rows[r]), int(counts[r]), int(counts[:r].sum())
    g_run = g[perm[start:start + n].long()].contiguous()
    perm_run = torch.arange(n, dtype=torch.int32, device=device)
    grouped_run = torch.zeros(n, dtype=torch.int32, device=device)
    row0, zero = cw0[v:v + 1].clone(), torch.zeros((1, D), dtype=dt, device=device)

    def run(fn, row, gr):
        return fn(row.clone(), None, gr, perm_run, grouped_run, slr).view(i16)

    if not torch.equal(run(ordered_grad_update_, row0, g_run), a[v:v + 1].view(i16)):
        raise AssertionError("the heaviest run alone differs from its row in the step")
    want = run(ordered_grad_update_, zero, g_run)
    if not torch.equal(want, run(ordered_grad_update_plain, zero, g_run)):
        raise AssertionError("ordered_grad_update differs from its plain version on the heaviest run into a zero row")
    faults, moving = visible_run_faults(g_run, g_run.float().cpu(), dt,
                                        lambda s: astype_storage(-slr * s, dt).float())
    for fault, gr in faults.items():
        if torch.equal(run(ordered_grad_update_plain, zero, gr), want):
            raise AssertionError(f"the dense ragged update's gate passed a planted fault ({fault})")
    ids_stream = torch.empty_like(grouped)
    ids_stream[perm.long()] = grouped  # the step's ids in stream order (the grads' order)
    ids_long = ids_stream.long()
    cw_t, row_t, cw_l = cw0.clone(), row0.clone(), cw0.clone()
    entry = dict(
        name="ordered_scatter_add", route="cuda",
        source="cachedembedding_tpu_torch/csrc/ordered_scatter_add.cu",
        replaces="cachedembedding_tpu/train/trainer.py:503-538 (the dense branch on ragged windows: the grad "
                 "w.r.t. the storage-dtype cache, an XLA scatter-add in that dtype, and its f32 update) and :404 "
                 "(cw.at[v].add in the sparse-gradient branch); XLA scatters, no Pallas kernel",
        entry="ordered_grad_update", max_abs_err=0.0,
        ms=median_ms(lambda: ordered_grad_update_(cw_t, None, g, perm, grouped, slr)),
        device_ms=device_median_ms(lambda: ordered_grad_update_(cw_t, None, g, perm, grouped, slr)),
        plain_ms=plain_s * 1e3,  # one call: it loops once per contributor rank of the heaviest run
        # the grads and the plan read once, each touched row read and written
        bound_ms=(L * D * g.element_size() + 2 * L * 4 + 2 * touched * D * cw0.element_size())
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        # the (C, D) grad in bf16 by atomics, in no fixed order, then the update
        # of every row: JAX's shape of the work, another function's values
        library_ms=median_ms(lambda: cw_l.sub_(torch.zeros_like(cw_l).index_add_(0, ids_long, g), alpha=slr)),
        library="torch.zeros_like + Tensor.index_add_ (atomics: no fixed order) + Tensor.sub_",
        timed_on=f"ragged, first training step ({C} x {D} bf16 rows, {L} ids)",
        tolerance="bit-exact against the plain version; two launches bit-identical; untouched rows bit-equal",
        touched_rows=touched, heaviest_run=n, planted_faults=list(faults),
        heaviest_run_addends_moving_its_sum=len(moving),
        heaviest_run_ms=median_ms(lambda: ordered_grad_update_(row_t, None, g_run, perm_run, grouped_run, slr)),
        heaviest_run_device_ms=device_median_ms(
            lambda: ordered_grad_update_(row_t, None, g_run, perm_run, grouped_run, slr)),
    )
    call = lambda c, gg, p, gr: ordered_grad_update_(c, None, gg, p, gr, slr)  # noqa: E731
    entry.update(kernel5_design_numbers("ordered_grad_update", call, cw0, g, perm, grouped, n, entry["device_ms"],
                                        entry["bound_ms"]))
    if KERNEL5_AGAINST:
        entry["against"] = kernel5_against_turns("ordered_grad_update", call, cw0, g, perm, grouped, slr)
    entry["heaviest_run_share_of_chain_bound"] = entry["chain_bound_ms"] / entry["heaviest_run_device_ms"]
    entry["heaviest_run_share_of_one_grad_row"] = entry["one_grad_row_ms"] / entry["heaviest_run_device_ms"]
    log(f"[kernel] ordered_grad_update: {touched} touched rows, heaviest run {n} ids (row {v}); bit-equal to its "
        f"plain version and across launches, untouched rows unchanged; the gate rejects all four planted faults; "
        f"{json.dumps(entry)}")
    return entry


# phase wire's runs on one trainer, in order: (id wire, dense wire, learning
# windows, frozen windows, the format the frozen windows must ship)
WIRE_RUNS = {"escape int8": ("escape", "int8", 12, 4, "esc"), "ranktier int8": ("ranktier", "int8", 24, 4, "rt"),
             "escape int4": ("escape", "int4", 2, 0, None), "plain int8": ("plain", "int8", 2, 0, None)}


def wire_window_check(win, batches, dmode: str) -> dict:
    """The window's ids, dense features and labels decoded on the card
    against the host's own arrays, bit for bit; then a byte flipped at the
    start of the buffer's id block must make the ids differ (a planted
    fault the comparison has to reject)."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.train import wire

    host_ids = win.staging.slot_ids
    dense = torch.stack([b.dense_features for b in batches]).float().numpy()
    labels = torch.stack([b.labels for b in batches]).float().numpy()
    ids_ok = np.array_equal(win.slot_ids.cpu().numpy(), host_ids)
    dense_ok = np.array_equal(win.dense.cpu().numpy().view(np.uint32), wire.dense_reference(dense, dmode).view(np.uint32))
    labels_ok = np.array_equal(win.labels.cpu().numpy(), labels)
    P, L = host_ids.shape
    again, _ = wire.decode_window_ids(win.buf, P, L, win.wire["id_spec"])
    flipped = win.buf.clone()
    flipped[0] ^= 0x5A
    bad, _ = wire.decode_window_ids(flipped, P, L, win.wire["id_spec"])
    fault_caught = not np.array_equal(bad.cpu().numpy(), host_ids)
    return {"ids": ids_ok and np.array_equal(again.cpu().numpy(), host_ids), "dense": dense_ok, "labels": labels_ok,
            "flipped_id_byte_rejected": fault_caught}


def phase_wire(device) -> tuple:
    """The window wire at full width: the bf16 slice's configuration with
    bench.py's dense and id wires (``WIRE_RUNS``, one trainer): the escape
    wire on int8 dense features for 16 windows (it freezes after 12), the
    rank-tier wire for 28 (it freezes after 24), then 2 windows each of
    int4 dense features and the plain wire. Gates: finite losses, a hit
    rate in (0, 1], Kernels 1 and 2 once a step and no other update entry,
    the frozen windows in the frozen format, the last window of each run
    decoded on the card bit-equal to the host's ids, dense features and
    labels, a flipped id byte rejected, and the flush. Numbers per run: bytes
    a window by block beside raw int32 ids and bf16 dense features, the host
    id encoder's ms, the rest of the packing's host ms (dense features and
    labels encoded, admits and buffer assembled), the buffer copy's device ms, host and device s a window,
    and examples/s over the frozen windows. Returns (launches, numbers)."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train import wire
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    tag = "[wire]"
    t_phase = time.perf_counter()
    cfg = slice_config("bfloat16")
    cfg.dense_input_dtype = "int8"
    P, B, Din, F = cfg.cache.prefetch_num, cfg.batch_size, cfg.dense_in_features, cfg.num_sparse_features
    steps = P * sum(r[2] + r[3] for r in WIRE_RUNS.values())
    data = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, B, steps, skew=0.5, seed=11)
    t0 = time.perf_counter()
    tr = CachedDLRMTrainer(cfg, id_freq_map=data.id_freq_map(), device=device)
    torch.cuda.synchronize()
    log(f"{tag} trainer built in {time.perf_counter() - t0:.1f} s")
    kept = {}
    begin = tr._begin_window

    def begin_and_keep(batches, *a):
        win = begin(batches, *a)
        kept.update(win=win, batches=batches)
        return win

    tr._begin_window = begin_and_keep
    it = iter(data)
    zero_launch_counts()
    numbers = {}
    for name, (id_wire, dmode, learn, frozen, frozen_format) in WIRE_RUNS.items():
        tr.cfg.dense_input_dtype = dmode
        tr.wire = wire.WindowWire(id_wire, True, tr._rt_dict_features(), tr._device_rows())
        reps = [tr.train(it, num_iters=learn * P)] + ([tr.train(it, num_iters=frozen * P)] if frozen else [])
        losses = np.concatenate([r.losses for r in reps])
        if losses.shape != ((learn + frozen) * P,) or not np.isfinite(losses).all():
            raise AssertionError(f"{tag} {name}: losses not finite: {losses}")
        if not 0.0 < reps[-1].hit_rate <= 1.0:
            raise AssertionError(f"{tag} {name}: hit rate {reps[-1].hit_rate} outside (0, 1]")
        last = reps[-1]
        formats = [w["format"] for r in reps for w in r.window_wire]
        if frozen_format and set(w["format"] for w in last.window_wire) != {frozen_format}:
            raise AssertionError(f"{tag} {name}: the frozen windows shipped {formats}, not {frozen_format}")
        check = wire_window_check(kept["win"], kept["batches"], dmode)
        if not all(check.values()):
            raise AssertionError(f"{tag} {name}: decode on the card against the host: {check}")
        ws = last.window_wire
        mean = lambda xs: float(np.mean(xs)) if len(xs) else None  # noqa: E731
        by_block = {k: mean([w["bytes"][k] for w in ws]) for k in ("ids", "dense", "labels", "admits", "tail")}
        numbers[name] = {
            "formats": formats, "bytes_per_window": by_block,
            "raw_bytes_per_window": {"ids_int32": P * B * F * 4, "dense_bf16": P * B * Din * 2, "labels_u8": P * B},
            "encode_ms": mean([1e3 * w["encode_s"] for w in ws]), "pack_ms": mean([1e3 * w["pack_s"] for w in ws]),
            "host_s_per_window": mean(last.window_host_s), "device_s_per_window": mean(last.window_device_s),
            "examples_per_s": last.examples_per_s, "decode_check": check, "hit_rate": last.hit_rate,
            "loss_last_window": float(losses[-P:].mean()),
        }
        log(f"{tag} {name}: {json.dumps(numbers[name])}")
    launches = ops.launch_counts()
    log(f"{tag} kernel launches {launches}")
    if launches["gather_rows"] < steps:
        raise AssertionError(f"{tag} kernel gather_rows launched {launches['gather_rows']} times")
    check_update_launches(tag, launches, steps, "binned_sgd")
    check_flush(tr, tag)
    tr.close()
    log(f"{tag} phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches, numbers


DEVICE_PLANNER_RATIOS = (0.01, 0.02, 0.05)  # the run takes the smallest that holds its counted windows
DEVICE_PLANNER_WINDOWS = 3
# run -> (LFU eviction, use_sparse_embed_grad, the update entry it launches once a step)
DEVICE_PLANNER_RUNS = {"device_planner dataset": (False, False, "binned_sgd"),
                       "device_planner lfu sparse": (True, True, "ordered_scatter_add")}
SLICE_NUMBERS: dict = {}  # phase_slice's numbers by row dtype, printed beside the device planner's


def pinned_copy(t):
    """An asynchronous copy of ``t`` into pinned host memory, in stream order."""
    import torch

    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda).copy_(t, non_blocking=t.is_cuda)


def device_planner_config(ratio: float, lfu: bool, sparse: bool):
    """The bf16 slice's model at full width (Kaggle tables, D = 128, batch
    16,384, prefetch 8, bf16 rows and compute) with the device planner and
    every table cached (``resident_threshold=0``; the device planner takes
    no resident region)."""
    import dataclasses

    cfg = slice_config("bfloat16")
    cfg.use_sparse_embed_grad = sparse
    cfg.cache = dataclasses.replace(cfg.cache, planner="device", resident_threshold=0, cache_ratio=ratio,
                                    use_lfu_eviction=lfu)
    return cfg


def synthetic_distinct(sizes, B: int, P: int, windows: int, seed: int) -> list:
    """Distinct ids of each of the first ``windows`` windows of P batches of
    the slice's synthetic stream (``seed``)."""
    import numpy as np

    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

    ds = SyntheticLongTailDataset(sizes, B, P * windows, skew=0.5, seed=seed)
    return [int(np.unique(np.concatenate([ds.make_batch(w * P + i).sparse_features.values.numpy()
                                          for i in range(P)])).size) for w in range(windows)]


def check_device_planner_errors(device) -> None:
    """On a small device-planner bag on the card: an id out of range raises
    ValueError before the plan, and a window of more distinct ids than slots
    raises a RuntimeError that names the capacity."""
    import numpy as np

    from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag

    bag = CachedEmbeddingBag(1000, 16, cuda_row_num=8, planner="device", warmup_ratio=0.0, device=device)
    try:
        try:
            bag.prepare_ids(np.array([3, 1000], np.int32))
            raise AssertionError("[device_planner] an out-of-range id was accepted")
        except ValueError as e:
            log(f"[device_planner] out-of-range id: ValueError({e})")
        try:
            bag.prepare_ids(np.arange(9, dtype=np.int32))
            raise AssertionError("[device_planner] 9 distinct ids were accepted by 8 slots")
        except RuntimeError as e:
            if "capacity 8" not in str(e) and "8 slots" not in str(e):
                raise AssertionError(f"[device_planner] the capacity error does not name the capacity: {e}")
            log(f"[device_planner] over capacity: RuntimeError({e})")
        slots = bag.prepare_ids(np.arange(8, dtype=np.int32))
        if sorted(slots.cpu().tolist()) != list(range(8)):
            raise AssertionError(f"[device_planner] a full window after the errors got slots {slots.tolist()}")
    finally:
        bag.close()


def check_plan_ties(device, windows: int = 8) -> dict:
    """``plan_ids`` under eviction on the card against the CPU, bit for bit:
    LFU and DATASET chains over a 1,000,000-row domain and a 20,000-slot
    directory, windows of 100,000 Zipf ids (about 13,000 distinct, so from
    the second window on every miss evicts a resident row), frequencies in
    [0, 4) so that most victims tie with others. The phase's own runs at a
    1% cache evict nothing in their windows; this holds the victim order
    over equal frequencies of resident rows. Returns the rows evicted."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.cache.state import EvictionStrategy, init_cache_state, plan_ids

    N, C, L = 1_000_000, 20_000, 100_000
    rng = np.random.default_rng(17)
    freq = torch.from_numpy(rng.integers(0, 4, N).astype(np.int32))
    evicted = {}
    for strat in (EvictionStrategy.LFU, EvictionStrategy.DATASET):
        cpu, card = init_cache_state(N, C), init_cache_state(N, C, device)
        n = 0
        for w in range(windows):
            ids = torch.from_numpy((rng.zipf(1.2, L) * 7919 % N).astype(np.int32))
            cpu, plan = plan_ids(cpu, ids, freq, unique_budget=L, strategy=strat)
            card, plan_c = plan_ids(card, ids.to(device), freq.to(device), unique_budget=L, strategy=strat)
            for what, a, b in (*zip(("slot_to_row", "row_to_slot", "slot_freq"), cpu, card),
                               ("indices", plan.indices, plan_c.indices), ("scalars", plan.scalars, plan_c.scalars)):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"[device_planner] {strat.name} window {w}: plan_ids {what} differs")
            if not int(plan.scalars[1]) <= C:
                raise AssertionError(f"[device_planner] {int(plan.scalars[1])} distinct ids exceed {C} slots")
            n += int((plan.indices[2] >= 0).sum())
        if n == 0:
            raise AssertionError(f"[device_planner] {strat.name} chain evicted nothing")
        evicted[strat.name] = n
    log(f"[device_planner] plan_ids under eviction with tied frequencies, {windows} windows each, card equal to "
        f"CPU bit for bit; rows evicted {evicted}")
    return evicted


def phase_device_planner(device) -> tuple:
    """The device planner at full width (``device_planner``): two runs of
    DEVICE_PLANNER_WINDOWS windows and one evaluation window (planned batch
    by batch, as JAX does), each through ``dispatch.get_dataloader("custom",
    ..., prefetch_depth=2)`` and timed by ``utils.timer.Timer``, with the
    launch counts zeroed just before: DATASET eviction on the dense branch
    (Kernel 2 fed by the plans made on the card) and LFU with
    use_sparse_embed_grad on the sparse branch (Kernel 5). The cache ratio
    is the smallest of DEVICE_PLANNER_RATIOS that holds every window's
    distinct ids, counted on the host. Gates: each training window's
    plan_ids on the card bit-equal to the same function on CPU copies of the
    state and ids (the new state's three arrays, the plan's indices and
    scalars), each step's update plan bit-equal to ``sort_plan_np`` of its
    ids read back, the update entry launched once a step and no other,
    finite losses, a hit rate in (0, 1], the flush; then the error paths on
    a small bag. Returns each run's launch counts and numbers."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.cache.state import CacheState, plan_ids
    from cachedembedding_tpu_torch.data import dispatch
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan, sort_plan_np
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer
    from cachedembedding_tpu_torch.utils.timer import Timer

    t_phase = time.perf_counter()
    cfg0 = slice_config("bfloat16")
    sizes, B, P = cfg0.num_embeddings_per_feature, cfg0.batch_size, cfg0.cache.prefetch_num
    steps = DEVICE_PLANNER_WINDOWS * P
    distinct = synthetic_distinct(sizes, B, P, DEVICE_PLANNER_WINDOWS, 7)
    eval_distinct = max(synthetic_distinct(sizes, B, 1, P, 8))
    ratio = next((r for r in DEVICE_PLANNER_RATIOS if int(r * sum(sizes)) >= max(distinct + [eval_distinct])), None)
    log(f"[device_planner] distinct ids a window {distinct}, an eval batch at most {eval_distinct}: cache ratio "
        f"{ratio} ({int((ratio or 0) * sum(sizes))} slots of {sum(sizes)} rows)")
    if ratio is None:
        raise AssertionError("[device_planner] no cache ratio of DEVICE_PLANNER_RATIOS holds the windows")
    paths, numbers = {}, {"cache_ratio": ratio, "distinct_ids_a_window": distinct}
    for run, (lfu, sparse, entry) in DEVICE_PLANNER_RUNS.items():
        tag = f"[{run}]"
        cfg = device_planner_config(ratio, lfu, sparse)
        freq = SyntheticLongTailDataset(sizes, B, steps, skew=0.5, seed=7).id_freq_map()
        t0 = time.perf_counter()
        tr = CachedDLRMTrainer(cfg, id_freq_map=freq, device=device)
        emb = tr.embed
        torch.cuda.synchronize()
        log(f"{tag} trainer built in {time.perf_counter() - t0:.1f} s: capacity {emb.capacity}, "
            f"{emb.evict_strategy.name} eviction, directory on the card "
            f"({sum(t.nbytes for t in emb.state) / 2**20:.1f} MiB)")
        state0 = tuple(t.cpu() for t in emb.state)
        freq_cpu = emb.dataset_freq.cpu() if emb.dataset_freq is not None else None
        windows, update_plans, branches = [], [], set()
        begin_prepare, step_plan, branch_of = emb.begin_prepare, tr._step_plan, tr.branch_of

        def begin_and_keep(ids, out_shape=None):
            pw = begin_prepare(ids, out_shape)
            windows.append((np.asarray(ids), pw, tuple(pinned_copy(t) for t in emb.state)))
            return pw

        def step_plan_and_keep(win, p):
            plan = step_plan(win, p)
            update_plans.append((pinned_copy(win.step_ids(p)), *(pinned_copy(t) for t in plan)))
            return plan

        def branch_and_keep(win):
            branch = branch_of(win)
            branches.add(branch)
            return branch

        emb.begin_prepare, tr._step_plan, tr.branch_of = begin_and_keep, step_plan_and_keep, branch_and_keep
        train = dispatch.get_dataloader("custom", "train", B, table_sizes=sizes, num_batches=steps,
                                        prefetch_depth=2, skew=0.5, seed=7)
        timer = Timer(device=device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_launch_counts()
        timer.start()
        rep = tr.train(train, num_iters=steps)
        train_s = timer.stop()
        emb.begin_prepare, tr._step_plan, tr.branch_of = begin_prepare, step_plan, branch_of
        timer.start()
        ev = tr.evaluate(dispatch.get_dataloader("custom", "val", B, table_sizes=sizes, num_batches=P,
                                                 prefetch_depth=2, skew=0.5, seed=7))
        eval_s = timer.stop()
        paths[run] = launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
        losses = np.asarray(rep.losses)
        if losses.shape != (steps,) or not np.isfinite(losses).all():
            raise AssertionError(f"{tag} losses not finite: {losses}")
        if not 0.0 < rep.hit_rate <= 1.0 or ev["count"] != P * B or not np.isfinite(ev["auroc"]):
            raise AssertionError(f"{tag} hit rate {rep.hit_rate}, eval {ev}")
        if branches != {"sparse" if sparse else "dense"}:
            raise AssertionError(f"{tag} update branches {branches}")
        check_update_launches(tag, launches, steps, entry)
        if launches["gather_rows"] != steps + P:
            raise AssertionError(f"{tag} kernel launches {launches}")
        # the plans on the card against the same function on the CPU
        t1 = time.perf_counter()
        st = CacheState(*state0)
        if len(windows) != DEVICE_PLANNER_WINDOWS:
            raise AssertionError(f"{tag} {len(windows)} windows planned, expected {DEVICE_PLANNER_WINDOWS}")
        for w, (ids, pw, new) in enumerate(windows):
            st, plan = plan_ids(st, torch.from_numpy(ids.astype(np.int32)), freq_cpu, unique_budget=pw.budget,
                                strategy=emb.evict_strategy)
            for what, a, b in (("slot_to_row", st[0], new[0]), ("row_to_slot", st[1], new[1]),
                               ("slot_freq", st[2], new[2]), ("indices", plan.indices, pw.host_indices),
                               ("scalars", plan.scalars, pw.host_scalars)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{tag} window {w}: plan_ids {what} on the card differs from the CPU's")
        F = len(sizes)
        for s, (ids, perm, grouped, bins) in enumerate(update_plans):
            want = sort_plan_np(ids.numpy().reshape(F, -1).T, emb.device_rows)
            if not all(np.array_equal(a.numpy(), b) for a, b in zip((perm, grouped, bins), want)):
                raise AssertionError(f"{tag} step {s}: the update plan made on the card differs from sort_plan_np")
        if len(update_plans) != steps:
            raise AssertionError(f"{tag} {len(update_plans)} update plans for {steps} steps")
        gate_s = time.perf_counter() - t1
        stream = update_plans[0][0].to(device).reshape(F, -1).t().reshape(-1)
        upd_ms = device_median_ms(lambda: sort_plan(stream, emb.device_rows))
        check_flush(tr, tag)
        rb = rep.window_readback
        res = {
            "capacity": emb.capacity, "host_s_window": rep.window_host_s, "device_s_window": rep.window_device_s,
            "plan_ids_device_ms_window": [1e3 * x for x in rep.window_plan_device_s],
            "readback_device_ms_window": [1e3 * r["device_s"] for r in rb if r["device_s"] is not None],
            "readback_wait_ms_window": [1e3 * r["wait_s"] for r in rb], "readback_bytes": rb[0]["bytes"],
            "update_plan_device_ms_step": upd_ms, "timer_train_s": train_s, "timer_eval_s": eval_s,
            "examples_per_s": rep.examples_per_s, "timer_examples_per_s": steps * B / train_s,
            "peak_gib": peak / 2**30, "hit_rate": rep.hit_rate, "auroc": ev["auroc"],
            "writebacks": sum(emb.stats.num_write_back_history), "gate_cpu_s": gate_s,
        }
        numbers[run] = res
        log(f"{tag} loss per window {[float(x) for x in losses.reshape(-1, P).mean(axis=1)]}; hit rate "
            f"{rep.hit_rate:.4f}; {res['writebacks']} writebacks; eval auroc {ev['auroc']:.4f}; kernel launches "
            f"{launches}")
        log(f"{tag} host s/window {[round(x, 4) for x in rep.window_host_s]}; device s/window "
            f"{[round(x, 4) for x in rep.window_device_s]}; plan_ids device ms/window "
            f"{[round(x, 3) for x in res['plan_ids_device_ms_window']]}; readback {res['readback_bytes']} bytes, "
            f"device ms {[round(x, 3) for x in res['readback_device_ms_window']]}, host wait ms "
            f"{[round(x, 3) for x in res['readback_wait_ms_window']]}; update plan {upd_ms:.3f} device ms/step; "
            f"{rep.examples_per_s:.0f} examples/s ({train_s:.2f} s by Timer for {steps} steps); peak device "
            f"memory {peak / 2**30:.2f} GiB")
        log(f"{tag} every window's plan_ids equal to the CPU's and every step's update plan equal to "
            f"sort_plan_np ({gate_s:.1f} s of CPU checks)")
        tr.close()
        del tr, emb, windows, update_plans
        gc.collect()
        torch.cuda.empty_cache()
    if "bfloat16" in SLICE_NUMBERS:
        log(f"[device_planner] beside the bf16 slice's host planner in this call: {json.dumps(SLICE_NUMBERS)}")
        numbers["host_planner_bf16_slice"] = SLICE_NUMBERS["bfloat16"]
    numbers["evicted_under_ties"] = check_plan_ties(device)
    check_device_planner_errors(device)
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"[device_planner] phase done in {numbers['seconds']:.1f} s")
    return paths, numbers


def check_quantized_admits(device) -> dict:
    """int8 and int4 admit payloads on the card, at phase 2's small width
    with a 2.5% cache (evictions and re-admissions): in every window with
    fetched admits, the payload equals the host quantizer's of the host rows,
    and the rows landed on the card equal its dequantization cast to the
    rows' dtype, bit for bit; afterwards every trained row written back and
    not admitted again holds a bf16 value in the f32 host table."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.cache import manager, state
    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.ops.rounding import astype_storage
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    out = {}
    tables = [50, 300, 4000, 20000]
    for mode, rows_dtype in (("int8", "float32"), ("int4", "bfloat16")):
        tag = f"[quantized admits {mode}]"
        cfg = DLRMConfig(
            num_embeddings_per_feature=tables, embedding_dim=16, dense_in_features=13,
            dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1), batch_size=256,
            cache=CacheConfig(cache_ratio=0.025, resident_threshold=500, prefetch_num=4, weight_init="virtual",
                              ship_sort_perm=True, cache_dtype=rows_dtype, transfer_dtype=mode))
        train = SyntheticLongTailDataset(tables, 256, 24, dense_in_features=13, skew=0.5, seed=7)
        tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
        checked = []
        land = tr._land_admits

        def land_and_check(win):
            ws = win.staging
            if not ws.fetch_slots.shape[0]:
                return land(win)
            quant = manager._quant_rows_host if mode == "int8" else manager._quant_rows_host4
            q, sc = quant(tr.embed.host_table.gather(ws.fetch_rows))
            payload_ok = np.array_equal(q, ws.fetch_payload.numpy()) and np.array_equal(sc, ws.fetch_scales)
            deq = (state.dequant_q8(torch.from_numpy(q), torch.from_numpy(sc)) if mode == "int8"
                   else state.dequant_rows_q4(torch.from_numpy(q), torch.from_numpy(sc), 16))
            want = astype_storage(deq, tr.embed.cache_weight.dtype).float().numpy()
            land(win)
            got = tr.embed.cache_weight[torch.from_numpy(ws.fetch_slots.astype(np.int64)).to(device)].float()
            checked.append({"fetched": int(ws.fetch_slots.shape[0]), "payload_equal": payload_ok,
                            "landed_equal": bool(np.array_equal(got.cpu().numpy(), want))})
            return None

        tr._land_admits = land_and_check
        rep = tr.train(train, num_iters=24)
        emb = tr.embed
        emb._drain_writebacks()
        touched = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in train])).astype(np.int64)
        _, cached_rows = emb._dir.resident()
        back = touched[emb.host_table.written_mask(touched) & ~np.isin(touched, cached_rows) & ~np.isin(
            touched, emb._res_rows)]
        vals = emb.host_table.gather(back)
        bf16_ok = np.array_equal(vals, torch.from_numpy(vals).to(torch.bfloat16).float().numpy())
        tr.close()
        if not checked or not all(c["payload_equal"] and c["landed_equal"] for c in checked):
            raise AssertionError(f"{tag} fetched admits on the card: {checked}")
        if not back.size or not bf16_ok or not np.isfinite(rep.losses).all():
            raise AssertionError(f"{tag} {back.size} written-back rows, bf16 values: {bf16_ok}")
        out[mode] = {"windows_with_fetches": len(checked), "fetched": sum(c["fetched"] for c in checked),
                     "payload_equal": True, "landed_equal": True, "written_back_rows": int(back.size),
                     "written_back_bf16": bf16_ok}
        log(f"{tag} {json.dumps(out[mode])}")
    return out


def phase_bare_module(device) -> None:
    """The bare-module API on the card with fp8 rows: prepare_ids, then
    lookup (Kernel 1), over six seeded id sets whose union exceeds the
    capacity. Nothing trains, so each lookup must equal the host table's
    rows of those ids through the storage cast, summed over the pooling
    axis in f32, exactly."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
    from cachedembedding_tpu_torch.jagged import RaggedFeatures
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    sizes, D, B, P = [40, 30_000, 5_000], 128, 256, 2
    F = len(sizes)
    bag = CachedEmbeddingBag(
        sum(sizes), D, cache_ratio=0.05, table_sizes=sizes, seed=5, weight_init="virtual",
        resident_tables=[0], warmup_ratio=0.0, dtype=FP8, device=device,
    )
    off = np.concatenate([[0], np.cumsum(sizes)])
    rng = np.random.default_rng(11)
    seen = set()
    g0 = gather_rows.launches
    for _ in range(6):
        ids = np.stack([off[t] + rng.integers(0, n, (B, P)) for t, n in enumerate(sizes)]).astype(np.int32)
        seen.update(ids[1:].reshape(-1).tolist())
        slots = bag.prepare_ids(torch.from_numpy(ids.reshape(-1)))
        got = bag.lookup(RaggedFeatures.from_uniform(slots.reshape(F, B, P))).cpu()
        with bag._host_lock:
            host = torch.from_numpy(bag.host_table.gather(ids.reshape(-1).astype(np.int64)))
        want = astype_storage(host, torch.float8_e4m3fn).float().reshape(F, B, P, D).sum(dim=2).transpose(0, 1)
        if got.shape != (B, F, D) or not torch.equal(got, want):
            raise AssertionError("bare-module lookup of fp8 rows differs from the host rows")
    wb = sum(bag.stats.num_write_back_history)
    launched = gather_rows.launches - g0
    bag.close()
    if len(seen) <= bag.capacity or wb == 0 or launched < 6:
        raise AssertionError(f"bare module: {len(seen)} cached ids vs capacity {bag.capacity}, "
                             f"{wb} writebacks, {launched} gathers")
    log(f"[bare module] fp8 rows: 6 prepare_ids + lookup calls over {len(seen)} distinct cached ids "
        f"(capacity {bag.capacity}), {wb} writebacks, {launched} gather launches; every lookup equals "
        f"the host rows through the storage cast, pooled")


CLI_TRAIN_BATCHES, CLI_EVAL_BATCHES, CLI_BATCH = 24, 4, 16384
CLI_FLAGS = ["--kaggle", "--use_freq", "--cache_ratio", "0.01", "--warmup_ratio", "0.7",
             "--buffer_size", "50000", "--prefetch_num", "8", "--limit_train_batches", str(CLI_TRAIN_BATCHES),
             "--limit_val_batches", "2", "--limit_test_batches", "2"]
# DeepFM diverges at DLRM's learning rate of 1.0 on this data (its scores
# collapse to one value); it trains at 0.1, as the JAX package's DeepFM test
# does
# Row-wise Adagrad diverges at 1.0 too (each touched element moves by about
# the learning rate on its first step); at 0.1 it learns
ADAGRAD_FLAGS = ["--embedding_optimizer", "rowwise_adagrad", "--learning_rate", "0.1"]
CLI_RUNS = {"cli cached": ["--use_cache"], "cli resident": [],
            "cli deepfm": ["--use_cache", "--model", "deepfm", "--learning_rate", "0.1"],
            "cli adagrad": ["--use_cache", *ADAGRAD_FLAGS], "cli adagrad resident": ADAGRAD_FLAGS,
            "cli int8": ["--use_cache", "--transfer_dtype", "int8"],
            "cli int4": ["--use_cache", "--transfer_dtype", "int4"],
            "cli device": ["--use_cache", "--planner", "device"]}
CHECKPOINT_TABLE_CAP = 20_000  # the checkpoint round trip's tables: Kaggle's, capped at this many rows
CLI_TAIL = 0.2  # P(rank >= r) ~ r^-CLI_TAIL: 426,827 distinct training ids, above the 1% cache's 337,625


def write_cli_dataset(root):
    """A Criteo-Kaggle-format dataset under ``root``: ``day_0_*`` with
    CLI_TRAIN_BATCHES x 16,384 rows, ``day_6_*`` (the final day: val and test
    halves) with CLI_EVAL_BATCHES x 16,384. Each feature's raw values are
    long-tail ranks (CLI_TAIL) over 4x its Kaggle table size, scattered by a
    multiplicative hash, so ``% hash`` spreads the hot ids over the table and
    the training ids outnumber the cache's slots (evictions happen).
    Labels follow a logistic of the first dense feature and hidden weights of
    the 32 hottest ranks of four features."""
    import numpy as np

    from cachedembedding_tpu_torch.config import CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE as sizes

    rng = np.random.default_rng(2024)
    hidden = rng.normal(0.0, 1.5, (4, 32))
    for day, nb in ((0, CLI_TRAIN_BATCHES), (6, CLI_EVAL_BATCHES)):
        n = nb * CLI_BATCH
        dense = np.log1p(rng.exponential(4.0, (n, 13))).astype(np.float32)
        sparse = np.empty((n, len(sizes)), np.int64)
        logit = 1.5 * (dense[:, 0] - 1.5)
        for f, size in enumerate(sizes):
            lo = (1.0 / (4 * size)) ** CLI_TAIL
            rank = np.floor((rng.random(n) * (1 - lo) + lo) ** (-1.0 / CLI_TAIL)).astype(np.int64) - 1
            if f < 4:
                logit += np.where(rank < 32, hidden[f, np.minimum(rank, 31)], 0.0)
            sparse[:, f] = (rank * 2654435761 + 97 * f) % (1 << 31)
        labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
        np.save(root / f"day_{day}_dense.npy", dense)
        np.save(root / f"day_{day}_sparse.npy", sparse)
        np.save(root / f"day_{day}_labels.npy", labels)
    return root


def run_cli(name: str, data_dir, extra) -> dict:
    """One run of the users' command in its own process: ``python -m
    cachedembedding_tpu_torch.train.dlrm_main``. Returns what it printed:
    the epoch line, val/test metrics, the frequency map's and the table's
    seconds, and its ``run stats``."""
    import re

    argv = [sys.executable, "-m", "cachedembedding_tpu_torch.train.dlrm_main",
            "--dataset_dir", str(data_dir), *CLI_FLAGS, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{name}] exit {proc.returncode}: {proc.stderr[-4000:]}")
    out, err = proc.stdout, proc.stderr
    epoch = re.search(r"epoch 0: (\d+) iters .*?\(([0-9.]+) it/s, (\d+) ex/s, hit_rate=([0-9.]+)\)", out)
    metrics = {s: (float(a), int(c)) for s, a, c in
               re.findall(r"epoch 0 (val|test): auroc=([0-9.]+) accuracy=[0-9.]+ over (\d+)", out)}
    freq = re.search(r"id_freq_map: (loaded|computed) in ([0-9.]+) s", err)
    stats = json.loads(re.search(r"run stats: (\{.*\})", err).group(1))
    if not (epoch and freq and set(metrics) == {"val", "test"}):
        raise AssertionError(f"[{name}] unexpected output:\n{out[-3000:]}\n{err[-3000:]}")
    res = dict(wall_s=wall, iters=int(epoch.group(1)), examples_per_s=float(epoch.group(3)),
               hit_rate=float(epoch.group(4)), metrics=metrics, freq=freq.group(1), freq_s=float(freq.group(2)),
               stats=stats, comm=next((ln for ln in out.splitlines() if "CacheStats" in ln or "Resident" in ln), ""))
    log(f"[{name}] {' '.join(argv[1:])}")
    log(f"[{name}] {wall:.1f} s wall; {res['iters']} steps at {res['examples_per_s']:.0f} examples/s, hit rate "
        f"{res['hit_rate']:.4f}; val auroc {metrics['val'][0]:.4f}, test auroc {metrics['test'][0]:.4f} over "
        f"{metrics['test'][1]}; id_freq_map {res['freq']} in {res['freq_s']:.2f} s; table filled in "
        f"{stats['table_init_s']:.2f} s; plan {stats['plan_host_ms_per_step']:.3f} host ms/step; peak device "
        f"memory {stats['peak_device_bytes'] / 2**30:.2f} GiB; {res['comm']}")
    log(f"[{name}] host s/window {[round(x, 4) for x in stats['window_host_s']]}; device s/window "
        f"{[round(x, 4) for x in stats['window_device_s']]}; kernel launches {stats['kernel_launches']}")
    log(f"[{name}] fetched admits {stats['swap_in_bytes']} f32 bytes; id wire {stats['wire_formats']}; first "
        f"window bytes {stats['window_bytes']}")
    if stats["window_plan_device_s"]:
        log(f"[{name}] plan_ids device ms/window {[round(1e3 * x, 3) for x in stats['window_plan_device_s']]}; "
            f"readback {stats['window_readback'][0]['bytes']} bytes, host wait ms "
            f"{[round(1e3 * r['wait_s'], 3) for r in stats['window_readback']]}")
    losses = stats["losses"]
    if len(losses) != CLI_TRAIN_BATCHES or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{name}] losses not finite: {losses}")
    for stage, (auroc, count) in metrics.items():
        if not auroc > 0.5 or count != 2 * CLI_BATCH:
            raise AssertionError(f"[{name}] {stage}: auroc {auroc} over {count}")
    k = stats["kernel_launches"]
    if k["gather_rows"] < CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES:
        raise AssertionError(f"[{name}] kernel launches {k}")
    adagrad = "rowwise_adagrad" in extra
    check_update_launches(f"[{name}]", k, CLI_TRAIN_BATCHES, "binned_adagrad" if adagrad else "binned_sgd")
    if adagrad:
        cached = "--use_cache" in extra
        # accumulators grew on the card and, where a cache evicts, were written back
        if stats["accum_positive_device_rows"] <= 0 or (cached and (
                stats["accum_positive_host_rows"] <= 0 or not res["hit_rate"] < 1.0)):
            raise AssertionError(f"[{name}] accumulators: {stats.get('accum_positive_device_rows')} device rows, "
                                 f"{stats.get('accum_positive_host_rows')} written back, hit rate {res['hit_rate']}")
        log(f"[{name}] accumulators grew on {stats['accum_positive_device_rows']} device rows"
            + (f", {stats['accum_positive_host_rows']} written back to the host store on eviction" if cached else ""))
    return res


def check_resident_kernels(data_dir, device) -> tuple:
    """Kernels 1 and 2 on the resident path's first training step: the f32
    rows of the 33,762,577-row table and its row-wise Adagrad accumulators,
    built as the CLI builds them. Kernel 1 bit for bit against its plain
    version and index_select. Kernel 2 in place on the table, since a 17 GB
    clone would not fit beside it: on the touched rows within 1e-5 of slr *
    sum|g| (plus one f32 ulp) of the float64 result, as is its plain version
    on a compact copy of those rows; a sample of 65,536 untouched rows
    bit-equal; a second launch from the restored rows bit-identical; and the
    gate shown to reject a planted fault (the heaviest row without one
    chunk). Then its Adagrad epilogue under the same scheme
    (``check_resident_adagrad``). Returns their entries."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import ROW_CHUNK, binned_sgd_update, binned_sgd_update_plain
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
    from cachedembedding_tpu_torch.train import dlrm_main

    args = dlrm_main.parse_args(["--dataset_dir", str(data_dir), *CLI_FLAGS, *ADAGRAD_FLAGS])
    cfg = dlrm_main.build_config(args)
    t0 = time.perf_counter()
    tr = dlrm_main.build_trainer(args, cfg, None, device)
    build_s = time.perf_counter() - t0
    F, B = cfg.num_sparse_features, cfg.batch_size
    batches = [b for _, b in zip(range(cfg.cache.prefetch_num), dlrm_main.get_data(args, cfg, "train"))]
    win = tr._begin_window(batches)
    ids = win.slot_ids[0]
    perm, grouped, bins = (a[0] for a in win.plan)
    cw = tr.embed.cache_weight
    C, D = cw.shape
    L = ids.shape[0]
    row_bytes = D * cw.element_size()
    ids_nf = ids.reshape(F, B).t().reshape(-1).long()

    out = gather_rows(cw, ids, F)
    if not (torch.equal(out, gather_rows_plain(cw, ids, F)) and
            torch.equal(out, torch.index_select(cw, 0, ids_nf).reshape(B, F, D))):
        raise AssertionError("gather_rows differs from index_select on the resident table")
    del out
    n_distinct = int(torch.unique(ids).numel())
    k1 = dict(
        max_abs_err=0.0,
        ms=median_ms(lambda: gather_rows(cw, ids, F)),
        device_ms=device_median_ms(lambda: gather_rows(cw, ids, F)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw, ids, F)),
        bound_ms=(L * 4 + (n_distinct + L) * row_bytes) / HBM_BYTES_PER_S * 1e3,
        library_ms=median_ms(lambda: torch.index_select(cw, 0, ids_nf)),
        timed_on=f"cli resident, first training step ({C} x {D} f32 rows)", tolerance="bit-exact",
    )
    log(f"[cli kernels] gather_rows on the resident table: {n_distinct} distinct rows, equal to index_select; "
        f"{json.dumps(k1)}")

    slr = cfg.learning_rate
    gen = torch.Generator(device=device).manual_seed(0)
    g = 1e-3 * torch.randn((L, D), generator=gen, device=device)  # stream order (B, F)
    touched = torch.unique(grouped)
    before = cw[touched.long()].clone()
    pos = torch.searchsorted(touched, grouped).to(torch.int32)  # the plan over the compact rows
    untouched = torch.ones(C, dtype=torch.bool, device=device)
    untouched[touched.long()] = False
    sample = torch.nonzero(untouched)[:, 0]
    sample = sample[torch.randperm(sample.numel(), generator=gen, device=device)[:65536]]
    del untouched
    before_u = cw[sample].clone()
    exact = before.double() - slr * torch.zeros_like(before, dtype=torch.float64).index_add_(
        0, pos.long(), g[perm.long()].double())
    abs64 = torch.zeros_like(exact).index_add_(0, pos.long(), g[perm.long()].double().abs())
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 23)

    def faults(x) -> int:
        return int(((x.double() - exact).abs() > SCATTER_RTOL * slr * abs64 + ulp).sum())

    binned_sgd_update(cw, g, perm, grouped, bins, slr)
    a = cw[touched.long()].clone()
    if not torch.equal(cw[sample], before_u):
        raise AssertionError("binned_sgd changed untouched rows of the resident table")
    cw[touched.long()] = before
    binned_sgd_update(cw, g, perm, grouped, bins, slr)
    if not torch.equal(cw[touched.long()], a):
        raise AssertionError("binned_sgd is not deterministic across launches on the resident table")
    plain = binned_sgd_update_plain(before.clone(), g, perm, pos, bins, slr)
    for what, x in (("kernel", a), ("plain version", plain)):
        if faults(x):
            raise AssertionError(f"binned_sgd {what} on the resident table: {faults(x)} elements off the float64 "
                                 f"result by more than {SCATTER_RTOL} x slr x sum|g| + 1 ulp")
    g_drop = g.clone()
    g_drop[perm[heaviest_row_chunk(grouped, ROW_CHUNK)].long()] = 0
    if not faults(binned_sgd_update_plain(before.clone(), g_drop, perm, pos, bins, slr)):
        raise AssertionError("the resident-table gate passed a planted fault (heaviest row missing one chunk)")
    del g_drop
    n_touched = touched.numel()
    compact = before.clone()
    k2 = dict(
        max_abs_err=(a - plain).abs().max().item(),
        max_err_over_slr_sum_abs_g=((a.double() - exact).abs() / (slr * abs64).clamp_min(1e-300)).max().item(),
        ms=median_ms(lambda: binned_sgd_update(cw, g, perm, grouped, bins, slr)),
        device_ms=device_median_ms(lambda: binned_sgd_update(cw, g, perm, grouped, bins, slr)),
        # on the touched rows: its (C, D) f32 accumulator would be a second 17 GB table
        plain_ms=median_ms(lambda: binned_sgd_update_plain(compact, g, perm, pos, bins, slr)),
        plain_on="the touched rows (compact copy)",
        bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), n_touched, cw.element_size()),
        library_ms=median_ms(lambda: cw.index_add_(0, ids_nf, g, alpha=-slr)),
        library="Tensor.index_add_ (f32 atomics: another sum order)",
        timed_on=f"cli resident, first training step ({C} x {D} f32 rows)",
        tolerance=f"touched rows within {SCATTER_RTOL} x slr x sum|g| + 1 f32 ulp of float64; untouched sample "
                  "bit-equal; two launches bit-identical",
        plan_host_ms=plan_host_ms(win, F, C), touched_rows=n_touched, **row_runs(grouped, ROW_CHUNK),
    )
    log(f"[cli kernels] binned_sgd on the resident table: {n_touched} touched rows of {C}, a sample of "
        f"{sample.numel()} untouched rows bit-equal, two launches bit-identical, the gate rejects the planted "
        f"fault; trainer built in {build_s:.1f} s; {json.dumps(k2)}")
    cw[touched.long()] = before
    ka = check_resident_adagrad(tr.embed, g, perm, grouped, bins, pos, touched, sample, abs64, slr,
                                cfg.adagrad_eps)
    tr.close()
    return k1, k2, ka


def check_resident_adagrad(embed, g, perm, grouped, bins, pos, touched, sample, abs64, slr: float,
                           eps: float) -> dict:
    """Kernel 2's Adagrad epilogue in place on the resident table and its
    (N,) accumulators, on its first step's plan (``pos``: the plan's ids
    renumbered over the touched rows, in order). Against float64, with s the
    step's sum of a row's grads and a its new accumulator: each accumulator
    within 3e-5 x (a + mean(|s| x sum|g|)) and each touched element within
    slr x 3 x (1e-5 x sum|g| + 1e-5 x |s|) / (sqrt(a) + eps) plus one f32
    ulp (the f32 sums' and mean square's rounding carried through the
    division); the plain version on a compact copy of the touched rows too;
    the untouched sample's rows and accumulators bit-equal; a second launch
    from the restored rows bit-identical; and the gate shown to reject a
    planted fault (the mean square taken over D - 1 columns)."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        binned_adagrad_update,
        binned_adagrad_update_plain,
        binned_scatter_add_plain,
    )

    cw, acc = embed.cache_weight, embed.cache_accum
    (C, D), L, n_touched = cw.shape, g.shape[0], touched.numel()
    t = touched.long()
    before, acc0 = cw[t].clone(), acc[t].clone()
    before_u, acc_u = cw[sample].clone(), acc[sample].clone()
    s64 = torch.zeros_like(before, dtype=torch.float64).index_add_(0, pos.long(), g[perm.long()].double())
    a64 = acc0.double() + (s64 * s64).mean(dim=1)
    den64 = torch.sqrt(a64) + eps
    w64 = before.double() - slr * s64 / den64[:, None]
    acc_tol = 3e-5 * (a64 + (s64.abs() * abs64).mean(dim=1))
    row_tol = (slr * 3 * (SCATTER_RTOL * abs64 + 1e-5 * s64.abs()) / den64[:, None]
               + torch.exp2(torch.floor(torch.log2(w64.abs().clamp_min(2.0 ** -126))) - 23))

    def faults(w, a) -> int:
        return int(((w.double() - w64).abs() > row_tol).sum()) + int(((a.double() - a64).abs() > acc_tol).sum())

    binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)
    kw, ka = cw[t].clone(), acc[t].clone()
    if not (torch.equal(cw[sample], before_u) and torch.equal(acc[sample], acc_u)):
        raise AssertionError("binned_adagrad changed untouched rows or accumulators of the resident table")
    cw[t], acc[t] = before, acc0
    binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)
    if not (torch.equal(cw[t], kw) and torch.equal(acc[t], ka)):
        raise AssertionError("binned_adagrad is not deterministic across launches on the resident table")
    pw, pa = before.clone(), acc0.clone()
    binned_adagrad_update_plain(pw, pa, g, perm, pos, bins, slr, eps)
    for what, (w, a) in (("kernel", (kw, ka)), ("plain version", (pw, pa))):
        if faults(w, a):
            raise AssertionError(f"binned_adagrad {what} on the resident table: {faults(w, a)} elements or "
                                 "accumulators off float64 beyond the tolerance")
    s32 = binned_scatter_add_plain(g, perm, pos, bins, n_touched)
    fa = acc0 + (s32[:, :-1] * s32[:, :-1]).mean(dim=1)
    if not faults(before - slr * s32 / (torch.sqrt(fa) + eps)[:, None], fa):
        raise AssertionError("the Adagrad gate passed a planted fault (the mean square over D - 1 columns)")
    compact, compact_acc = before.clone(), acc0.clone()
    entry = dict(
        max_abs_err=(kw - pw).abs().max().item(),
        accum_max_rel_err=((ka.double() - a64).abs() / a64.clamp_min(1e-300)).max().item(),
        max_err_over_tolerance=max(((kw.double() - w64).abs() / row_tol).max().item(),
                                   ((ka.double() - a64).abs() / acc_tol).max().item()),
        ms=median_ms(lambda: binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)),
        device_ms=device_median_ms(lambda: binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)),
        plain_ms=median_ms(lambda: binned_adagrad_update_plain(compact, compact_acc, g, perm, pos, bins, slr, eps)),
        plain_on="the touched rows (compact copy)",
        bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), n_touched, cw.element_size(), True),
        bound_by="bytes", library_ms=None,  # no PyTorch call computes row-wise Adagrad
        timed_on=f"cli adagrad resident, first training step ({C} x {D} f32 rows, (C,) f32 accumulators)",
        tolerance="see check_resident_adagrad", touched_rows=n_touched,
    )
    cw[t], acc[t] = before, acc0
    log(f"[cli kernels] binned_sgd's Adagrad epilogue on the resident table: {n_touched} touched rows and "
        f"accumulators within the tolerance of float64 (kernel and plain version), the untouched sample "
        f"bit-equal, two launches bit-identical, the gate rejects the planted fault; {json.dumps(entry)}")
    return entry


def check_cached_adagrad(data_dir, device) -> dict:
    """Kernel 2's Adagrad epilogue on ``cli adagrad``'s first training step:
    the cached trainer of ADAGRAD_FLAGS with --use_cache, built in this
    process (bf16 cache rows, f32 accumulators), its first window's plan,
    seeded bf16 grads. Against the plain version (a (C, D) f32 grad): touched
    rows within one bf16 ulp (sgd_faults), accumulators within rtol 1e-5
    (another sum order), untouched rows and accumulators bit-equal, two
    launches bit-identical, and the gate shown to reject a planted fault (the
    mean square over D - 1 columns). Returns its entry."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        ROW_CHUNK,
        binned_adagrad_update,
        binned_adagrad_update_plain,
        binned_scatter_add_plain,
    )
    from cachedembedding_tpu_torch.ops.rounding import index_copy_storage_
    from cachedembedding_tpu_torch.train import dlrm_main

    args = dlrm_main.parse_args(["--dataset_dir", str(data_dir), *CLI_FLAGS, *ADAGRAD_FLAGS, "--use_cache"])
    cfg = dlrm_main.build_config(args)
    tr = dlrm_main.build_trainer(args, cfg, dlrm_main.get_freq(args, cfg), device)
    batches = [b for _, b in zip(range(cfg.cache.prefetch_num), dlrm_main.get_data(args, cfg, "train"))]
    win = tr._begin_window(batches)
    perm, grouped, bins = (a[0] for a in win.plan)
    cw0, acc0 = tr.embed.cache_weight.clone(), tr.embed.cache_accum.clone()
    tr.close()
    (C, D), L = cw0.shape, perm.shape[0]
    slr, eps = cfg.learning_rate, cfg.adagrad_eps
    g = (1e-3 * torch.randn((L, D), generator=torch.Generator(device=device).manual_seed(0),
                            device=device)).to(cw0.dtype)
    touched = torch.zeros(C, dtype=torch.bool, device=device)
    touched[grouped.long()] = True
    results = []
    for _ in range(2):
        cw, acc = cw0.clone(), acc0.clone()
        binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)
        results.append((cw, acc))
    (kw, ka), (kw2, ka2) = results
    if not (torch.equal(kw, kw2) and torch.equal(ka, ka2)):
        raise AssertionError("binned_adagrad is not deterministic across launches on cli adagrad's step")
    pw, pa = cw0.clone(), acc0.clone()
    binned_adagrad_update_plain(pw, pa, g, perm, grouped, bins, slr, eps)

    def faults(w, a) -> int:
        if not torch.equal(a[~touched], acc0[~touched]):
            raise AssertionError("binned_adagrad changed untouched accumulators on cli adagrad's step")
        return sgd_faults(w, cw0, pw, touched) + int(((a - pa).abs() > 1e-5 * pa.abs()).sum())

    n_bad = faults(kw, ka)
    if n_bad:
        raise AssertionError(f"binned_adagrad on cli adagrad's step: {n_bad} elements or accumulators off the "
                             "plain version")
    s32 = binned_scatter_add_plain(g, perm, grouped, bins, C)
    fa = acc0 + (s32[:, :-1] * s32[:, :-1]).mean(dim=1)
    fw = cw0.clone()
    index_copy_storage_(fw, torch.arange(C, device=device), cw0.float() - slr * s32 / (torch.sqrt(fa) + eps)[:, None])
    if not faults(fw, fa):
        raise AssertionError("the cached Adagrad gate passed a planted fault (the mean square over D - 1 columns)")
    del s32, fa, fw, kw2, ka2
    n_touched = int(touched.sum())
    cw_t, acc_t = cw0.clone(), acc0.clone()
    entry = dict(
        max_abs_err=(kw.float() - pw.float()).abs().max().item(),
        accum_max_rel_err=((ka - pa).abs() / pa.abs().clamp_min(1e-30)).max().item(),
        ms=median_ms(lambda: binned_adagrad_update(cw_t, acc_t, g, perm, grouped, bins, slr, eps)),
        device_ms=device_median_ms(lambda: binned_adagrad_update(cw_t, acc_t, g, perm, grouped, bins, slr, eps)),
        plain_ms=median_ms(lambda: binned_adagrad_update_plain(cw_t, acc_t, g, perm, grouped, bins, slr, eps)),
        bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), n_touched, cw0.element_size(), True),
        bound_by="bytes", library_ms=None,  # no PyTorch call computes row-wise Adagrad
        timed_on=f"cli adagrad, first training step ({C} x {D} bf16 cache rows, bf16 grads)",
        tolerance="touched rows within one bf16 ulp (+1e-6) of the plain version, accumulators within rtol 1e-5; "
                  "untouched bit-equal; two launches bit-identical",
        touched_rows=n_touched, **row_runs(grouped, ROW_CHUNK),
    )
    log(f"[cli kernels] binned_sgd's Adagrad epilogue on cli adagrad's step: {n_touched} touched rows of {C}, "
        f"within the tolerance of the plain version, untouched rows bit-equal, two launches bit-identical, the "
        f"gate rejects the planted fault; {json.dumps(entry)}")
    return entry


def check_checkpoint_round_trip(data_dir, ckpt_root, device, adagrad: bool = False) -> dict:
    """Train through the CLI's functions on small tables (Kaggle's, capped at
    CHECKPOINT_TABLE_CAP rows; the same files serve, the ids being hashed),
    save, load into a fresh trainer and evaluate: the scores and AUROC equal
    the saved trainer's bit for bit. With ``adagrad`` (ADAGRAD_FLAGS) the
    loaded host accumulators also equal the saved ones bit for bit, and two
    more steps of both trainers give losses within rtol 1e-5 (the restored
    cache holds other slots, so runs cross other chunk boundaries)."""
    import numpy as np
    import torch

    import cachedembedding_tpu_torch.train.trainer as trainer_mod
    from cachedembedding_tpu_torch.config import CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE as sizes
    from cachedembedding_tpu_torch.train import dlrm_main
    from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    small_dir = ckpt_root / "small_tables_kaggle"  # its own frequency map
    if not small_dir.exists():
        small_dir.mkdir()
        for f in data_dir.glob("day_*.npy"):
            (small_dir / f.name).symlink_to(f)
    tables = ",".join(str(min(n, CHECKPOINT_TABLE_CAP)) for n in sizes)
    args = dlrm_main.parse_args(["--dataset_dir", str(small_dir), *CLI_FLAGS, "--use_cache",
                                 "--num_embeddings_per_feature", tables, "--cache_ratio", "0.8",
                                 *(ADAGRAD_FLAGS if adagrad else [])])
    cfg = dlrm_main.build_config(args)
    freq = dlrm_main.get_freq(args, cfg)
    scores = []
    tag = "[cli checkpoint adagrad]" if adagrad else "[cli checkpoint]"
    path = str(ckpt_root / ("ckpt_adagrad" if adagrad else "ckpt"))

    class Recording(trainer_mod.StreamingMetrics):
        def update(self, s, labels):
            scores.append(np.asarray(s))
            super().update(s, labels)

    def evaluate(tr):
        scores.clear()
        original, trainer_mod.StreamingMetrics = trainer_mod.StreamingMetrics, Recording
        try:
            m = tr.evaluate(list(dlrm_main.get_data(args, cfg, "val"))[:2])
        finally:
            trainer_mod.StreamingMetrics = original
        return m, np.concatenate(scores)

    t0 = time.perf_counter()
    tr = dlrm_main.build_trainer(args, cfg, freq, device)
    tr.train(dlrm_main.get_data(args, cfg, "train"), num_iters=CLI_TRAIN_BATCHES)
    save_checkpoint(path, tr)
    m1, s1 = evaluate(tr)
    tr2 = dlrm_main.build_trainer(args, cfg, freq, device)
    step = load_checkpoint(path, tr2)
    m2, s2 = evaluate(tr2)
    torch.cuda.synchronize()
    if step != CLI_TRAIN_BATCHES or not np.array_equal(s1, s2) or m1 != m2:
        raise AssertionError(f"{tag} step {step}, auroc {m1['auroc']} vs {m2['auroc']}, "
                             f"{int((s1 != s2).sum())} scores differ")
    res = {"tables_rows": int(sum(cfg.num_embeddings_per_feature)), "step": step, "auroc": m1["auroc"],
           "scores": int(s1.size)}
    if adagrad:
        if not np.array_equal(tr.embed.host_accum.arr, tr2.embed.host_accum.arr):
            raise AssertionError(f"{tag} the loaded accumulators differ from the saved ones")
        more = [b for _, b in zip(range(2), dlrm_main.get_data(args, cfg, "train"))]
        r1, r2 = (np.asarray(t.train(more, num_iters=2).losses) for t in (tr, tr2))
        if not np.allclose(r1, r2, rtol=1e-5):
            raise AssertionError(f"{tag} the resumed trainer's next losses {r2} differ from {r1}")
        res.update(accum_rows=int((tr.embed.host_accum.arr > 0).sum()), next_losses_max_rel=float(
            np.max(np.abs(r1 - r2) / np.abs(r1))))
    tr.close()
    tr2.close()
    res["seconds"] = time.perf_counter() - t0
    log(f"{tag} trained {step} steps on {res['tables_rows']} rows of small tables, saved, loaded into a fresh "
        f"trainer: {s1.size} scores and auroc {m1['auroc']:.6f} bit-equal"
        + (f"; {res['accum_rows']} accumulators restored bit for bit, the next two losses within "
           f"{res['next_losses_max_rel']:.1e}" if adagrad else "") + f"; {res['seconds']:.1f} s")
    return res


def phase_cli(device) -> dict:
    """Phase 11: the users' command line at full Criteo-Kaggle width on a
    written dataset (cached, resident and DeepFM runs, each its own
    process), Kernels 1 and 2 on the resident table, the checkpoint round
    trip, then the table-wise phase on the same dataset. Returns each run's
    kernel launches by path, the kernels' resident-table entries and the
    table-wise phase's numbers."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from cachedembedding_tpu_torch import _build

    gc.collect()
    torch.cuda.empty_cache()  # the runs' processes share the card with this one
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_", dir=_build.BUILD_DIR))
    try:
        data_dir = write_cli_dataset(Path(tempfile.mkdtemp(prefix="criteo_kaggle_", dir=root)))
        log(f"[cli] wrote {CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES} x {CLI_BATCH} rows in "
            f"{time.perf_counter() - t0:.1f} s to {data_dir.relative_to(_build.PKG_DIR.parent)}")
        with open("/proc/meminfo") as f:
            mem = {k: int(v.split()[0]) / 2**20 for k, v in (ln.split(":", 1) for ln in f)}
        log(f"[cli] host memory: {mem['MemTotal']:.1f} GiB total, {mem['MemAvailable']:.1f} GiB available")
        freq_path = data_dir / "id_freq_map.npy"
        runs, mtime = {}, None
        for name, extra in CLI_RUNS.items():
            runs[name] = run_cli(name, data_dir, extra)
            if name == "cli cached":
                mtime = freq_path.stat().st_mtime_ns
            if (runs[name]["freq"] == "computed") != (name == "cli cached"):
                raise AssertionError(f"[{name}] id_freq_map {runs[name]['freq']}")
            if "--use_cache" in extra and not 0.0 < runs[name]["hit_rate"] <= 1.0:
                raise AssertionError(f"[{name}] hit rate {runs[name]['hit_rate']} outside (0, 1]")
        if freq_path.stat().st_mtime_ns != mtime:
            raise AssertionError("id_freq_map.npy was written again")
        log(f"[cli] id_freq_map.npy computed once by the first run and reused by the other {len(runs) - 1}")
        baseline = phase_baseline(data_dir)
        torch.cuda.empty_cache()
        k1, k2, ka = check_resident_kernels(data_dir, device)
        gc.collect()
        torch.cuda.empty_cache()
        ka_cached = check_cached_adagrad(data_dir, device)
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = {"sgd": check_checkpoint_round_trip(data_dir, root, device),
                "adagrad": check_checkpoint_round_trip(data_dir, root, device, adagrad=True)}
        gc.collect()
        torch.cuda.empty_cache()
        tablewise = phase_tablewise(data_dir, runs["cli resident"]["stats"]["losses"])
        rowwise = phase_rowwise(data_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t0
    log(f"[cli] phase done in {secs:.1f} s")
    launches = {name: r["stats"]["kernel_launches"] for name, r in runs.items()}
    launches.update({name: r["launches"] for name, r in baseline.items() if "launches" in r})
    launches["tablewise"] = tablewise["cli"]["launches"]
    launches["rowwise"] = rowwise["cli"]["launches"]
    numbers = {name: {"host_s_window": r["stats"]["window_host_s"], "device_s_window": r["stats"]["window_device_s"],
                      "examples_per_s": r["examples_per_s"], "peak_gib": r["stats"]["peak_device_bytes"] / 2**30,
                      "auroc": {k: v[0] for k, v in r["metrics"].items()}} for name, r in runs.items()}
    return {"launches": launches, "baseline": baseline, "tablewise": tablewise, "rowwise": rowwise, "numbers": numbers,
            "gather_rows": k1, "binned_sgd": k2, "binned_adagrad": ka, "binned_adagrad_cached": ka_cached,
            "checkpoint": ckpt, "seconds": secs}


BASELINE_FLAGS = ["--batch_size", str(CLI_BATCH), "--limit_train_batches", str(CLI_TRAIN_BATCHES),
                  "--limit_val_batches", "2", "--use_freq"]
# --hbm_gb 16 (the JAX command line's default) holds every Kaggle table
# (8.05 GiB of bf16 rows under its 9.6 GiB budget); at 8 the planner demotes
# the two largest to CACHED and keeps the other 24 HBM_FULL
BASELINE_RUNS = {"baseline plan_only": ["--kernel", "auto", "--hbm_gb", "8", "--plan_only"],
                 "baseline hbm": ["--kernel", "hbm"],
                 "baseline auto": ["--kernel", "auto", "--hbm_gb", "8"]}


def run_baseline(name: str, data_dir, extra) -> dict:
    """One run of the baseline command, ``python -m
    cachedembedding_tpu_torch.baselines.dlrm_main``, in its own process.
    Returns its plan, validation AUROC and ``run stats``; checks the gates:
    the plan printed, and for training runs finite losses, AUROC above 0.5,
    Kernel 1 and Kernel 2 (the sparse branch of f32 rows) launched, and the
    mixed bag's resident tables the plan's HBM_FULL tables."""
    import re

    argv = [sys.executable, "-m", "cachedembedding_tpu_torch.baselines.dlrm_main", "--dataset_dir", str(data_dir),
            *BASELINE_FLAGS, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{name}] exit {proc.returncode}: {proc.stderr[-4000:]}")
    out, err = proc.stdout, proc.stderr
    lines = out.splitlines()
    plan = [ln for ln in lines if ln.startswith(("EmbeddingShardingPlan", "table ", "t", "HBM/device"))]
    kernels = [ln.split()[4] for ln in plan if re.match(r"t\d+ ", ln)]
    log(f"[{name}] {' '.join(argv[1:])}: {wall:.1f} s wall")
    for ln in plan:
        log(f"[{name}]   {ln}")
    if not (plan and plan[0].startswith("EmbeddingShardingPlan") and len(kernels) == 26):
        raise AssertionError(f"[{name}] no plan printed:\n{out[-3000:]}")
    res = {"wall_s": wall, "kernels": kernels}
    if "--plan_only" in extra:
        if "val:" in out:
            raise AssertionError(f"[{name}] --plan_only trained")
        return res
    auroc = float(re.search(r"val: auroc=([0-9.]+)", out).group(1))
    stats = json.loads(re.search(r"run stats: (\{.*\})", err).group(1))
    res.update(auroc=auroc, stats=stats, examples_per_s=stats["examples_per_s"])
    log(f"[{name}] {len(stats['losses'])} steps at {stats['examples_per_s']:.0f} examples/s; val auroc "
        f"{auroc:.4f}; peak device memory {stats['peak_device_bytes'] / 2**30:.2f} GiB; host s/window "
        f"{[round(x, 4) for x in stats['window_host_s']]}; device s/window "
        f"{[round(x, 4) for x in stats['window_device_s']]}; kernel launches {stats['kernel_launches']}")
    if len(stats["losses"]) != CLI_TRAIN_BATCHES or not all(math.isfinite(x) for x in stats["losses"]):
        raise AssertionError(f"[{name}] losses: {stats['losses']}")
    if not auroc > 0.5:
        raise AssertionError(f"[{name}] val auroc {auroc}")
    k = stats["kernel_launches"]
    if k["gather_rows"] < CLI_TRAIN_BATCHES:
        raise AssertionError(f"[{name}] kernel launches {k}")
    check_update_launches(f"[{name}]", k, CLI_TRAIN_BATCHES, "binned_sgd")
    if "auto" in extra:
        full = [i for i, kern in enumerate(kernels) if kern == "hbm_full"]
        if not (stats["resident_tables"] == stats["plan_hbm_full_tables"] == full and 0 < len(full) < 26):
            raise AssertionError(f"[{name}] resident tables {stats['resident_tables']}, the plan's HBM_FULL "
                                 f"{stats['plan_hbm_full_tables']} ({full} printed)")
        log(f"[{name}] the mixed bag holds the plan's {len(full)} HBM_FULL tables whole; "
            f"{26 - len(full)} cached")
    return res


def phase_baseline(data_dir) -> dict:
    """Phase 11b: the baseline command line on the CLI phase's dataset:
    the plan alone, the resident table (``hbm``) and the plan executed
    (``auto``)."""
    runs = {name: run_baseline(name, data_dir, extra) for name, extra in BASELINE_RUNS.items()}
    return {name: {k: v for k, v in r.items() if k != "stats"} | (
        {"launches": r["stats"]["kernel_launches"], "peak_gib": r["stats"]["peak_device_bytes"] / 2**30,
         "host_s_window": r["stats"]["window_host_s"], "device_s_window": r["stats"]["window_device_s"]}
        if "stats" in r else {}) for name, r in runs.items()}


HOST_LINK_BYTES = 256 << 20


def measure_host_link(device) -> dict:
    """The pinned host-to-device copy rate of 256 MB (median of 5 copies,
    CUDA events): the planner's ``Topology.host_link_bytes_per_s``."""
    import torch

    src = torch.ones(HOST_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(HOST_LINK_BYTES, dtype=torch.uint8, device=device)
    times = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    if not bool((dst[:: 1 << 20] == 1).all()):
        raise AssertionError("[host_link] the copy did not land")
    ms = sorted(times[1:])[2]
    rate = HOST_LINK_BYTES / (ms / 1e3)
    log(f"[host_link] pinned host-to-device copy of {HOST_LINK_BYTES} B: {ms:.4f} ms, {rate / 1e9:.2f} GB/s")
    del src, dst
    return {"bytes": HOST_LINK_BYTES, "ms": ms, "bytes_per_s": rate}


# the mesh phase's runs: (windows, cache rows, use_sparse_embed_grad, update entries)
MESH_RUNS = {"dense": (3, "bfloat16", False, ("binned_sgd",)),
             "sparse": (1, "bfloat16", True, ("ordered_scatter_add",)),
             "fp8 rounding": (1, FP8, False, ("binned_scatter_add", "stochastic_sgd_round"))}
MESH_SAMPLE_ROWS = 65_536


def mesh_run_config(cache_dtype: str, sparse: bool):
    """The bf16 slice's configuration (Kaggle tables, D = 128, batch 16,384,
    1% cache, prefetch 8, resident tables <= 500k rows) without sort plans
    shipped: JAX ships none to a mesh window, so the one-card run takes the
    same branch by JAX's rule."""
    import dataclasses

    cfg = slice_config(cache_dtype)
    cfg.use_sparse_embed_grad = sparse
    cfg.cache = dataclasses.replace(cfg.cache, ship_sort_perm=False)
    return cfg


def mesh_one_run(cfg, steps: int, device, mesh) -> dict:
    """Train ``steps`` steps, evaluate one window and flush, on one card or
    on ``mesh``, with the launch counts zeroed just before. Returns what the
    gates compare."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    P = cfg.cache.prefetch_num
    sizes = cfg.num_embeddings_per_feature
    train = SyntheticLongTailDataset(sizes, cfg.batch_size, steps, skew=0.5, seed=7)
    test = SyntheticLongTailDataset(sizes, cfg.batch_size, P, skew=0.5, seed=8)
    tr = (CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device) if mesh is None
          else CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), mesh=mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    rep = tr.train(train, num_iters=steps)
    ev = tr.evaluate(test)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    ids = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in train]))
    rows = np.sort(np.random.default_rng(0).choice(ids, min(MESH_SAMPLE_ROWS, ids.size), replace=False))
    out = dict(losses=np.asarray(rep.losses), auroc=ev["auroc"], count=ev["count"], hit_rate=rep.hit_rate,
               rows=np.asarray(tr.embed.dense_weight(rows)), launches=launches,
               host_s_window=rep.window_host_s, device_s_window=rep.window_device_s,
               examples_per_s=rep.examples_per_s, peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_child() -> int:
    """``chip_smoke.py --mesh``: the mesh phase's process. A column-wise mesh
    of one rank over NCCL (``parallel/mesh.make_mesh(1)``) trains the bf16
    slice's configuration through ``CachedDLRMTrainer(mesh=...)`` beside the
    one-card trainer on the same data: 3 windows on the dense branch, 1 with
    use_sparse_embed_grad, 1 of float8_e4m3fn rows with stochastic rounding.
    Gates: losses, flushed rows (a sample of the trained ids) and the
    evaluation window's AUROC bit-equal to the one-card run's (at one rank
    the collectives are identities and the loss factor 1.0), every update
    kernel of the path launched once a step and no other, Kernel 1 launched,
    a hit rate in (0, 1]; then ``--world_size 2`` on one visible card raises.
    Prints one JSON line of its numbers last."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    from cachedembedding_tpu_torch.train import dlrm_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_mesh(1)
    device = mesh.device  # the one-card runs too
    log(f"[mesh] make_mesh(1): rank {mesh.rank} of {mesh.size} on {mesh.device}, "
        f"{torch.distributed.get_backend()} backend")
    out = {}
    for name, (windows, dtype, sparse, entries) in MESH_RUNS.items():
        cfg = mesh_run_config(dtype, sparse)
        steps = windows * cfg.cache.prefetch_num
        one = mesh_one_run(cfg, steps, device, None)
        got = mesh_one_run(cfg, steps, device, mesh)
        tag = f"[mesh {name}]"
        for key in ("losses", "rows"):
            if not np.array_equal(got[key], one[key]):
                raise AssertionError(f"{tag} {key} differ from the one-card run's: "
                                     f"{int((got[key] != one[key]).sum())} of {got[key].size}")
        if got["auroc"] != one["auroc"] or got["count"] != one["count"]:
            raise AssertionError(f"{tag} evaluation {got['auroc']} over {got['count']}, one card {one['auroc']}")
        if not np.isfinite(got["losses"]).all() or not 0.0 < got["hit_rate"] <= 1.0:
            raise AssertionError(f"{tag} losses {got['losses']}, hit rate {got['hit_rate']}")
        check_update_launches(tag, got["launches"], steps, *entries)
        if got["launches"]["gather_rows"] < steps:
            raise AssertionError(f"{tag} kernel launches {got['launches']}")
        log(f"{tag} {steps} steps: losses, {got['rows'].shape[0]} flushed rows and the evaluation's AUROC "
            f"({got['auroc']:.6f}) bit-equal to the one-card run; hit rate {got['hit_rate']:.4f}; kernel launches "
            f"{got['launches']}")
        for who, r in (("mesh", got), ("one card", one)):
            log(f"{tag} {who}: host s/window {[round(x, 4) for x in r['host_s_window']]}; device s/window "
                f"{[round(x, 4) for x in r['device_s_window']]}; {r['examples_per_s']:.0f} examples/s; peak "
                f"{r['peak_gib']:.2f} GiB")
        out[name] = {who: {k: r[k] for k in ("host_s_window", "device_s_window", "examples_per_s", "peak_gib",
                                             "hit_rate", "launches")} for who, r in (("mesh", got), ("one", one))}
    destroy_mesh(mesh)
    if torch.cuda.device_count() == 1:
        try:
            dlrm_main.resolve_world_size(dlrm_main.parse_args(["--world_size", "2"]))
        except ValueError as e:
            log(f"[mesh] --world_size 2 on one card raises: {e}")
        else:
            raise AssertionError("[mesh] --world_size 2 on one visible card did not raise")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"mesh_child": out}), flush=True)
    return 0


def phase_mesh() -> dict:
    """Phase 12: ``mesh_child`` in its own process (its process group and
    CUDA context end with it). Returns its numbers."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--mesh"], capture_output=True, text=True, timeout=900)
    for ln in proc.stdout.splitlines()[:-1]:
        log(ln)
    if proc.returncode != 0:
        raise AssertionError(f"[mesh] exit {proc.returncode}: {proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.splitlines()[-1])["mesh_child"]
    res["wall_s"] = time.perf_counter() - t0
    log(f"[mesh] phase done in {res['wall_s']:.1f} s")
    return res


# the bench phase's runs (``--bench NAME ...``): flags of
# ``python3 -m cachedembedding_tpu_torch.bench``
# beside its defaults, the update entries its branch launches, and whether
# its timed segments must write evicted rows back (terabyte's 1,779,442
# cache slots are not full by the end of the default run's 992 iterations)
BENCH_RUNS = {"kaggle": ([], ("binned_sgd",), True),  # the dense branch: 901,228 device rows < 4 L
              "fp8": (["--cache-dtype", "float8_e4m3fn"], ("binned_scatter_add", "stochastic_sgd_round"), True),
              "sparse": (["--sparse-grad"], ("ordered_scatter_add",), True),
              "terabyte": (["--scale", "terabyte"], ("ordered_scatter_add",), False),  # 2,685,154 device rows > 4 L
              "avazu": (["--scale", "avazu"], ("ordered_scatter_add",), False)}  # 9,445,823 resident rows > 4 L
BENCH_PEAK_GIB = 4.0  # a cached run's peak device memory: the table lives on the host
BENCH_TIMEOUT_S = 600


def phase_bench(name: str = "kaggle", extra=()) -> dict:
    """The headline bench (``bench``): ``python3 -m
    cachedembedding_tpu_torch.bench`` with BENCH_RUNS[name]'s flags (the
    kaggle defaults for the smoke run) in its own process. Gates: exit 0,
    exactly one stdout line with the bench's metric for the scale, a
    positive finite value; the chosen segment churned (wrote evicted rows
    back) where BENCH_RUNS says it must; a cached run's hit rate in (0, 1]
    and its peak device memory under BENCH_PEAK_GIB; in its segments Kernel
    1 launched once a step, and the run's update entries once a step and no
    other. Logs its stderr but the warmup chunks and returns its ``bench
    summary`` with the record and the phase's wall seconds."""
    import re

    flags, entries, must_churn = BENCH_RUNS[name]
    argv = [sys.executable, "-m", "cachedembedding_tpu_torch.bench", *flags, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    tag = f"[bench {name}]"
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exit {proc.returncode}: {proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    for ln in proc.stderr.splitlines():
        if "  warmup " not in ln:
            log(f"{tag} {ln}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"{tag} {len(lines)} stdout lines, not one: {proc.stdout[-2000:]}")
    rec = json.loads(lines[0])
    summary = json.loads(re.search(r"^bench summary: (\{.*\})$", proc.stderr, re.M).group(1))
    resident = "avazu" in argv
    scale = argv[argv.index("--scale") + 1] if "--scale" in argv else "kaggle"
    want = f"dlrm_{scale}_{'resident' if resident else 'cached'}_train_throughput"
    if set(rec) - {"excluded_segments"} != {"metric", "value", "unit", "vs_baseline"} or rec["metric"] != want \
            or rec["unit"] != "examples/s" or not (math.isfinite(rec["value"]) and rec["value"] > 0):
        raise AssertionError(f"{tag} record {rec}")
    if (must_churn and not summary["churned"]) or not (resident or (
            0 < summary["hit_rate"] <= 1 and summary["peak_gib"] < BENCH_PEAK_GIB)):
        raise AssertionError(f"{tag} churned {summary['churned']}, hit rate {summary['hit_rate']}, peak "
                             f"{summary['peak_gib']} GiB (under {BENCH_PEAK_GIB} expected)")
    k = {e: summary["launches"].get(e, 0) for e in ("gather_rows",) + UPDATE_ENTRIES}
    if k["gather_rows"] != summary["steps"]:
        raise AssertionError(f"{tag} Kernel 1 launched {k['gather_rows']} times in {summary['steps']} steps")
    check_update_launches(tag, k, summary["steps"], *entries)
    log(f"{tag} {' '.join(argv[1:])}: {wall:.1f} s wall; {json.dumps(rec)}")
    return {**summary, "record": rec, "flags": argv[3:], "wall_s": wall}


def run_bench_only(names) -> int:
    """``--bench [NAME ...]``: the build, then the bench phase for each
    name of BENCH_RUNS (kaggle alone by default) in turn; prints the card
    and one JSON line of the runs. Not the smoke run: no ``ok`` line."""
    phase_build()
    runs = {name: phase_bench(name) for name in names or ["kaggle"]}
    print(card_name())
    print(json.dumps({"bench": runs}), flush=True)
    return 0


# the table-wise phase's small card-vs-CPU case, beside REFERENCE_SLICES
# (it needs a process group, so it runs in the table-wise child): Kaggle's
# hand-tuned map at one rank, tables of 50-20,000 rows with n // 16 cache
# rows each (1,522 slots: the reference's floor of 2,000 rows a table would
# hold every row the 24 steps touch, 2,768 of them), DATASET eviction after
# a 70% warmup, batch 256, windows of 4, f32 compute
TABLEWISE_SLICE = dict(tables=[50, 300, 4000, 20000], batch=256, prefetch=4, skew=0.2, steps=24, eval=4)
TABLEWISE_SAMPLE_ROWS = 65_536


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tablewise_small_run(mesh) -> dict:
    """TABLEWISE_SLICE on ``mesh``'s device through ``parallel/tablewise``:
    the windows planned, staged and trained (``tablewise_window_step``), one
    evaluation window (``tablewise_eval_step``), a flush. Returns what the
    card-vs-CPU gates compare and the run's launch counts."""
    import numpy as np

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.models.dlrm import DLRM
    from cachedembedding_tpu_torch.parallel import tablewise as tw
    from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics

    s = TABLEWISE_SLICE
    tables, B, P = s["tables"], s["batch"], s["prefetch"]
    train = SyntheticLongTailDataset(tables, B, s["steps"], dense_in_features=13, skew=s["skew"], seed=7,
                                     global_ids=False)
    test = SyntheticLongTailDataset(tables, B, s["eval"], dense_in_features=13, skew=s["skew"], seed=99,
                                    global_ids=False)
    configs = tw.prepare_tablewise_config(tables, 0.0, train.id_freq_map(), "criteo_kaggle", 1)
    for c in configs:
        c.cuda_row_num = c.num_embeddings // 16
    emb = tw.ParallelCachedEmbeddingBagTablewise(configs, 16, mesh, warmup_ratio=0.7,
                                                 evict_strategy=EvictionStrategy.DATASET)
    model = DLRM(16, len(tables), 13, (32, 16), (64, 32, 1), device=mesh.device)
    kw = dict(feature_perm=emb.feature_select_perm(), f_max=emb.F_max, global_batch=B)
    step, score = tw.tablewise_window_step(mesh, **kw), tw.tablewise_eval_step(mesh, **kw)

    def window(batches):
        slot_ids, plans = emb.begin_prepare_window(
            [b.sparse_features.values.numpy().reshape(len(tables), B).T for b in batches])
        emb.finish_prepare(plans)
        return slot_ids, np.stack([b.dense_features.numpy() for b in batches])

    batches = list(train)
    zero_launch_counts()
    losses = []
    for w in range(0, len(batches), P):
        slot_ids, dense = window(batches[w: w + P])
        labels = np.stack([b.labels.numpy() for b in batches[w: w + P]])
        losses.append(step(model, emb.cache_weight, slot_ids, emb._to_device(dense), emb._to_device(labels),
                           [1.0] * P, [1.0] * P))
    evb = list(test)
    slot_ids, dense = window(evb)
    probs = score(model, emb.cache_weight, slot_ids, emb._to_device(dense))
    _sync(mesh.device)
    launches = ops.launch_counts()
    metrics = StreamingMetrics()
    metrics.update(probs.reshape(-1).cpu().numpy(), np.concatenate([b.labels.numpy() for b in evb]))
    emb.flush()
    touched = np.unique(np.concatenate([b.sparse_features.values.numpy().reshape(len(tables), B).T
                                        + np.cumsum([0] + tables[:-1]) for b in batches]))
    st = emb.stats
    return dict(losses=np.concatenate([x.cpu().numpy() for x in losses]), auroc=metrics.compute()["auroc"],
                rows=emb.host_tables[0].gather(touched), launches=launches,
                weights=[p.detach().cpu().numpy() for p in model.parameters()],
                counts=(st.num_hits_history, st.num_miss_history, st.swap_in_bytes, st.swap_out_bytes))


def tablewise_hybrid_step(mesh, fused_op: str) -> dict:
    """Three ``parallel/hybrid.hybrid_train_step`` steps on ``mesh`` (one
    rank) on ``tests/test_parallel.py``'s inputs: losses, the shard, the
    dense weights."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.models.dlrm import DLRM
    from cachedembedding_tpu_torch.parallel.hybrid import hybrid_train_step

    rng = np.random.default_rng(0)
    Bg, F, D, Din, C = 16, 3, 32, 5, 64
    dev = mesh.device
    model = DLRM(D, F, Din, (8, D), (8, 4, 1), seed=0, device=dev)
    cw = torch.from_numpy(rng.normal(size=(C, D)).astype(np.float32) * 0.1).to(dev)
    step = hybrid_train_step(mesh, num_features=F, global_batch=Bg, fused_op=fused_op)
    losses = []
    for _ in range(3):
        dense = torch.from_numpy(rng.random((Bg, Din)).astype(np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(0, 2, Bg).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, C, (F * Bg,)).astype(np.int32)).to(dev)
        losses.append(float(step(model, cw, dense, ids, labels, 0.05, 0.05)))
    return dict(losses=np.asarray(losses), cache=cw.cpu().numpy(),
                weights=[p.detach().cpu().numpy() for p in model.parameters()])


def tablewise_full_width(data_dir, device) -> dict:
    """The users' command, ``dlrm_main.main`` with ``--use_tablewise`` on the
    written Criteo-Kaggle dataset, in this process (so on the one-rank mesh
    it made), with the launch counts zeroed just before; then the flush
    gate on the model it returns. Returns its numbers."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.train import dlrm_main

    argv = ["--dataset_dir", str(data_dir), *CLI_FLAGS, "--use_tablewise"]
    tag = "[tablewise cli]"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    t0 = time.perf_counter()
    res = dlrm_main.main(argv)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses, m = res["losses"], res["metrics"][0]
    emb = res["model"].embed
    log(f"{tag} {' '.join(argv)}: {wall:.1f} s in this process")
    if len(losses) != CLI_TRAIN_BATCHES or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} losses {losses}")
    if not 0.0 < res["hit_rate"] <= 1.0:
        raise AssertionError(f"{tag} hit rate {res['hit_rate']}")
    for stage in ("val", "test"):
        if not m[stage]["auroc"] > 0.5 or m[stage]["count"] != 2 * CLI_BATCH:
            raise AssertionError(f"{tag} {stage}: {m[stage]}")
    if device.type == "cuda":  # (a rehearsal on the CPU runs the plain versions)
        if launches["gather_rows"] != CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES:
            raise AssertionError(f"{tag} Kernel 1 launched {launches['gather_rows']} times, expected one a training "
                                 f"and an evaluation step ({CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES}): {launches}")
        check_update_launches(tag, launches, CLI_TRAIN_BATCHES, "binned_sgd")
    # the flush: a sample of the cached rows, read from the cache before it,
    # must be in the host table after it, and some of them must be trained
    slots, rows = emb.dirs[0].resident()
    real = rows != emb.pad_row
    slots, rows = slots[real], rows[real]
    pick = np.sort(np.random.default_rng(0).choice(slots.size, min(TABLEWISE_SAMPLE_ROWS, slots.size), replace=False))
    held = emb.cache_weight[torch.from_numpy(slots[pick].astype(np.int64)).to(device)].cpu().numpy()
    before = emb.host_tables[0].gather(rows[pick])
    emb.flush()
    after = emb.host_tables[0].gather(rows[pick])
    moved = int((after != before).any(axis=1).sum())
    if not np.array_equal(after, held) or moved == 0:
        raise AssertionError(f"{tag} flush: {int((after != held).any(axis=1).sum())} of {pick.size} sampled rows "
                             f"differ from the cache's, {moved} moved")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    out = dict(wall_s=wall, losses=losses, auroc={s: m[s]["auroc"] for s in ("val", "test")},
               hit_rate=res["hit_rate"], launches=launches, host_s_window=res["window_host_s"],
               device_s_window=res["window_device_s"], examples_per_s=res["examples_per_s"][0], peak_gib=peak,
               table_init_s=res["table_init_s"], freq_s=res["freq_s"], swap_in_bytes=res["swap_in_bytes"],
               swap_out_bytes=res["swap_out_bytes"], cache_rows=int(emb.C_max), flush_rows=int(pick.size),
               flush_trained_rows=moved)
    log(f"{tag} {CLI_TRAIN_BATCHES} steps, val auroc {out['auroc']['val']:.4f}, test auroc {out['auroc']['test']:.4f}; "
        f"hit rate {res['hit_rate']:.4f}; {emb.C_max} f32 cache rows; table filled in {res['table_init_s']:.2f} s; "
        f"kernel launches {launches}")
    log(f"{tag} flush: {pick.size} sampled cached rows equal in the host table, {moved} of them trained")
    log(f"{tag} host s/window {[round(x, 4) for x in out['host_s_window']]}; device s/window "
        f"{[round(x, 4) for x in out['device_s_window']]}; {out['examples_per_s']:.0f} examples/s; peak "
        f"{peak if peak is None else round(peak, 3)} GiB; swap in {res['swap_in_bytes']} B, out "
        f"{res['swap_out_bytes']} B")
    return out


def tablewise_child(data_dir, device_type: str = "cuda") -> int:
    """``chip_smoke.py --tablewise DATA_DIR``: the table-wise phase's
    process, on a mesh of one rank (NCCL on the card) and, for the CPU
    runs it is held against, a mesh of the same rank over the mesh's gloo
    host group. (1) The users' command at full Criteo-Kaggle width
    (``tablewise_full_width``); (2) TABLEWISE_SLICE on the card and on the
    CPU: cache counts equal with writebacks, losses within rtol 1e-4, the
    evaluation's AUROC within 1e-4, dense weights within rtol 1e-4 / atol
    1e-7, flushed rows within 1e-5 (f32 sums in another order; reference
    slice a's gates), the card's Kernel 1 once a step (the evaluation
    window's 4 included) and Kernel 2 once a training step; (3) the
    hybrid step, each fused op, 3 steps on the card and on the CPU: losses
    within rtol 1e-5, the shard and the dense weights within rtol 1e-4 /
    atol 1e-6 (JAX's tolerances for a mesh against one device); (4)
    ``dryrun_hybrid_train_step(1)``. Prints one JSON line of its numbers
    last."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.parallel.hybrid import dryrun_hybrid_train_step
    from cachedembedding_tpu_torch.parallel.mesh import Mesh, destroy_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_mesh(1, device_type)
    cpu = Mesh(group=mesh.host_group, host_group=mesh.host_group, rank=0, size=1, device=torch.device("cpu"))
    log(f"[tablewise] make_mesh(1): rank {mesh.rank} of {mesh.size} on {mesh.device}, "
        f"{torch.distributed.get_backend()} backend")
    out = {"cli": tablewise_full_width(data_dir, mesh.device)}
    gc.collect()

    tag = "[tablewise small]"
    got, ref = tablewise_small_run(mesh), tablewise_small_run(cpu)
    steps = TABLEWISE_SLICE["steps"]
    if got["counts"] != ref["counts"] or got["counts"][3] == 0:
        raise AssertionError(f"{tag} cache counts {got['counts']} vs the CPU's {ref['counts']} (or no writeback)")
    if mesh.device.type == "cuda":
        check_update_launches(tag, got["launches"], steps, "binned_sgd")
        if got["launches"]["gather_rows"] != steps + TABLEWISE_SLICE["eval"]:
            raise AssertionError(f"{tag} kernel launches {got['launches']}")
    loss_rel = float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])))
    row_err = float(np.abs(got["rows"] - ref["rows"]).max())
    if (not np.isfinite(got["losses"]).all() or loss_rel > 1e-4 or abs(got["auroc"] - ref["auroc"]) > 1e-4
            or row_err > 1e-5 or not all(np.allclose(a, b, rtol=1e-4, atol=1e-7)
                                         for a, b in zip(got["weights"], ref["weights"]))):
        raise AssertionError(f"{tag} card vs CPU: loss max rel {loss_rel:.2e}, auroc {got['auroc']} vs "
                             f"{ref['auroc']}, flushed rows max abs {row_err:.2e}")
    out["small"] = dict(loss_max_rel=loss_rel, rows_max_abs=row_err, auroc=(got["auroc"], ref["auroc"]),
                        writeback_bytes=got["counts"][3])
    log(f"{tag} card vs CPU: counts equal ({got['counts'][3]} writeback bytes); loss max rel diff {loss_rel:.2e}; "
        f"{got['rows'].shape[0]} flushed rows max abs diff {row_err:.2e}; auroc {got['auroc']:.6f} vs "
        f"{ref['auroc']:.6f}")

    for op in ("all_to_all", "gather_scatter"):
        tag = f"[tablewise hybrid_train_step {op}]"
        zero_launch_counts()
        got = tablewise_hybrid_step(mesh, op)
        launches = ops.launch_counts()
        ref = tablewise_hybrid_step(cpu, op)
        rel = float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])))
        if rel > 1e-5 or not np.allclose(got["cache"], ref["cache"], rtol=1e-4, atol=1e-6) or not all(
                np.allclose(a, b, rtol=1e-4, atol=1e-6) for a, b in zip(got["weights"], ref["weights"])):
            raise AssertionError(f"{tag} card vs CPU: loss max rel {rel:.2e}, shard max abs "
                                 f"{float(np.abs(got['cache'] - ref['cache']).max()):.2e}")
        if mesh.device.type == "cuda":
            check_update_launches(tag, launches, 3, "binned_sgd")
            if launches["gather_rows"] != 3:
                raise AssertionError(f"{tag} kernel launches {launches}")
        out[f"hybrid_{op}"] = dict(loss_max_rel=rel, cache_max_abs=float(np.abs(got["cache"] - ref["cache"]).max()))
        log(f"{tag} 3 steps, card vs CPU: loss max rel diff {rel:.2e}, shard max abs diff "
            f"{out[f'hybrid_{op}']['cache_max_abs']:.2e}")
    out["dryrun_loss"] = dryrun_hybrid_train_step(1, device_type)
    log(f"[tablewise] dryrun_hybrid_train_step(1): loss {out['dryrun_loss']:.6f}")
    destroy_mesh(mesh)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"tablewise_child": out}), flush=True)
    return 0


def phase_tablewise(data_dir, resident_losses) -> dict:
    """Phase 13: ``tablewise_child`` in its own process (its process group
    and CUDA context end with it), on the CLI phase's dataset. Returns its
    numbers, with its losses' largest relative difference from ``cli
    resident``'s (no gate: see ``tests/test_torch_cli.py::
    test_tablewise_against_the_resident_run``)."""
    import numpy as np

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--tablewise", str(data_dir)], capture_output=True, text=True,
                          timeout=900)
    for ln in proc.stdout.splitlines()[:-1]:
        log(ln)
    if proc.returncode != 0:
        raise AssertionError(f"[tablewise] exit {proc.returncode}: {proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.splitlines()[-1])["tablewise_child"]
    tw, rl = np.asarray(res["cli"]["losses"]), np.asarray(resident_losses)
    res["cli"]["vs_resident_loss_max_rel"] = float(np.max(np.abs(tw - rl) / np.abs(rl)))
    res["wall_s"] = time.perf_counter() - t0
    log(f"[tablewise] losses against cli resident's (bf16 dense inputs there, f32 here; no gate): max rel diff "
        f"{res['cli']['vs_resident_loss_max_rel']:.2e}")
    log(f"[tablewise] phase done in {res['wall_s']:.1f} s")
    return res


# the row-wise phase's small card-vs-CPU case: tests/test_row_cached.py's
# shapes (N 4096, D 32, F 4, B 64, 8 dense features) at one rank, a seeded
# initial table, LFU, 6 per-batch steps then 2 windows of 3, one scored
# batch; 384 cache rows (a window of 3 batches touches about 300 distinct
# ids, so the cache evicts)
ROWWISE_SLICE = dict(N=4096, D=32, F=4, B=64, Din=8, steps=6, windows=2, window=3, cap=384, lr=0.5)


def rowwise_small_run(mesh) -> dict:
    """ROWWISE_SLICE on ``mesh``'s device through ``parallel/row_cached``
    (its training step and window and its evaluation step) and
    ``parallel/row``'s lookup. Returns what the card-vs-CPU gates compare and the run's launch
    counts (the lookup's launch not among them)."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.models.dlrm import DLRM
    from cachedembedding_tpu_torch.parallel.row import make_rowwise_embedding_fn
    from cachedembedding_tpu_torch.parallel.row_cached import (
        RowShardedCachedEmbeddingBag,
        build_rowwise_cached_step,
        build_rowwise_cached_window,
    )

    s = ROWWISE_SLICE
    N, D, F, B, Din, cap, lr = s["N"], s["D"], s["F"], s["B"], s["Din"], s["cap"], s["lr"]
    n = s["steps"] + s["windows"] * s["window"] + 1
    rng = np.random.default_rng(5)
    ids = ((rng.zipf(1.3, size=(n, F * B)) - 1) % N).astype(np.int64)
    dense = rng.standard_normal((n, B, Din)).astype(np.float32)
    labels = (rng.random((n, B)) < 0.3).astype(np.float32)
    w0 = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32) * 0.05
    dev = mesh.device
    bag = RowShardedCachedEmbeddingBag(N, D, mesh=mesh, cuda_row_num=cap, initial_weight=w0,
                                       evict_strategy=EvictionStrategy.LFU, buffer_size=0)
    net = DLRM(D, F, Din, (16, D), (16, 8, 1), seed=0, device=dev)
    kw = dict(num_features=F, global_batch=B, pooling=1, capacity=cap)
    step, window = build_rowwise_cached_step(mesh, **kw), build_rowwise_cached_window(mesh, **kw)
    score = build_rowwise_cached_step(mesh, train=False, **kw)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    zero_launch_counts()
    encs, losses = [], []
    for i in range(s["steps"]):
        enc = bag.prepare_ids_per_rank(ids[i][None])
        encs.append(enc)
        losses.append(step(net, bag.global_cache(), t(enc[0]), t(dense[i]), t(labels[i]), lr, lr).reshape(1))
    P = s["window"]
    for w in range(s["windows"]):
        a = s["steps"] + w * P
        enc = bag.prepare_ids_per_rank(ids[a: a + P].reshape(1, -1))
        encs.append(enc)
        losses.append(window(net, bag.global_cache(), t(enc.reshape(P, -1)), t(dense[a: a + P]),
                             t(labels[a: a + P]), [lr] * P, [lr] * P))
    enc = bag.prepare_ids_per_rank(ids[-1][None])
    encs.append(enc)
    probs = score(net, bag.global_cache(), t(enc[0]), t(dense[-1]))
    _sync(dev)
    launches = ops.launch_counts()
    st = bag.aggregate_stats()
    out = dict(enc=encs, losses=torch.cat(losses).cpu().numpy(), probs=probs.cpu().numpy(), launches=launches,
               stats=(st.prepare_calls, st.num_hits_history, st.num_miss_history, st.num_write_back_history,
                      st.swap_in_bytes), master=bag.dense_weight())
    bag.close()
    lookup, shard_weight = make_rowwise_embedding_fn(mesh, N)
    wl = shard_weight(w0).requires_grad_(True)
    rows = lookup(wl, t(ids[0]))
    rows.sum().backward()
    out.update(lookup=rows.detach().cpu().numpy(), lookup_grad=wl.grad.cpu().numpy())
    return out


def check_rowwise_kernels(embed, data_dir, device) -> tuple:
    """Kernels 1 and 2 on a row-wise step at full width: the first training
    batch's 425,984 ids planned into the (337,625, 128) f32 cache (after the
    run and its flush), as the owner's lanes (at one rank the rank's slots
    in stream order). Kernel 1 bit-equal to its plain version and
    index_select. Kernel 2 on a copy of the cache with seeded f32 grads,
    from the step's plan sorted on the card, against float64 as
    ``check_resident_kernels`` holds it (touched rows within 1e-5 of slr *
    sum|g| plus one f32 ulp, the plain version likewise, untouched rows
    bit-equal, two launches bit-identical). Returns their entries."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, binned_sgd_update_plain, sort_plan
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
    from cachedembedding_tpu_torch.train import dlrm_main

    args = dlrm_main.parse_args(["--dataset_dir", str(data_dir), *CLI_FLAGS, "--use_rowwise"])
    cfg = dlrm_main.build_config(args)
    batch = next(iter(dlrm_main.get_data(args, cfg, "train")))
    ids = np.asarray(batch.sparse_features.values).reshape(1, -1)
    slots = torch.from_numpy(embed.prepare_ids_per_rank(ids)[0]).to(device)  # at one rank: its local slots
    cw = embed.global_cache()
    C, D = cw.shape
    L = slots.shape[0]
    row_bytes = D * cw.element_size()
    out = gather_rows(cw, slots, 1)
    if not (torch.equal(out, gather_rows_plain(cw, slots, 1)) and torch.equal(out[:, 0], cw[slots.long()])):
        raise AssertionError("[rowwise kernels] gather_rows differs from index_select")
    del out
    n_distinct = int(torch.unique(slots).numel())
    k1 = dict(
        max_abs_err=0.0,
        ms=median_ms(lambda: gather_rows(cw, slots, 1)),
        device_ms=device_median_ms(lambda: gather_rows(cw, slots, 1)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw, slots, 1)),
        bound_ms=(L * 4 + (n_distinct + L) * row_bytes) / HBM_BYTES_PER_S * 1e3,
        library_ms=median_ms(lambda: torch.index_select(cw, 0, slots.long())),
        timed_on=f"rowwise, a training step's {L} owner lanes ({C} x {D} f32 cache rows)", tolerance="bit-exact",
    )
    log(f"[rowwise kernels] gather_rows: {n_distinct} distinct rows, equal to index_select; {json.dumps(k1)}")

    slr = cfg.learning_rate
    perm, grouped, bins = sort_plan(slots, C)
    gen = torch.Generator(device=device).manual_seed(0)
    g = 1e-3 * torch.randn((L, D), generator=gen, device=device)
    base = cw.clone()
    touched = torch.unique(grouped).long()
    exact = base[touched].double() - slr * torch.zeros((touched.numel(), D), dtype=torch.float64,
                                                         device=device).index_add_(
        0, torch.searchsorted(touched, grouped.long()), g[perm.long()].double())
    abs64 = torch.zeros_like(exact).index_add_(0, torch.searchsorted(touched, grouped.long()),
                                               g[perm.long()].double().abs())
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 23)

    def faults(x) -> int:
        return int(((x.double() - exact).abs() > SCATTER_RTOL * slr * abs64 + ulp).sum())

    a = binned_sgd_update(base.clone(), g, perm, grouped, bins, slr)
    b = binned_sgd_update(base.clone(), g, perm, grouped, bins, slr)
    plain = binned_sgd_update_plain(base.clone(), g, perm, grouped, bins, slr)
    untouched = torch.ones(C, dtype=torch.bool, device=device)
    untouched[touched] = False
    if not torch.equal(a, b) or not torch.equal(a[untouched], base[untouched]):
        raise AssertionError("[rowwise kernels] binned_sgd: two launches differ or untouched rows moved")
    for what, x in (("kernel", a[touched]), ("plain version", plain[touched])):
        if faults(x):
            raise AssertionError(f"[rowwise kernels] binned_sgd {what}: {faults(x)} elements off the float64 "
                                 f"result by more than {SCATTER_RTOL} x slr x sum|g| + 1 ulp")
    work = base.clone()
    ids_nf = slots.long()
    k2 = dict(
        max_abs_err=(a - plain).abs().max().item(),
        ms=median_ms(lambda: binned_sgd_update(work, g, perm, grouped, bins, slr)),
        device_ms=device_median_ms(lambda: binned_sgd_update(work, g, perm, grouped, bins, slr)),
        plain_ms=median_ms(lambda: binned_sgd_update_plain(work, g, perm, grouped, bins, slr)),
        bound_ms=kernel2_bound_ms(L, D, g.element_size(), bins.numel(), touched.numel(), cw.element_size()),
        library_ms=median_ms(lambda: work.index_add_(0, ids_nf, g, alpha=-slr)),
        library="Tensor.index_add_ (f32 atomics: another sum order)",
        sort_plan_ms=median_ms(lambda: sort_plan(slots, C)),
        timed_on=f"rowwise, a training step's {L} owner lanes ({C} x {D} f32 cache rows)",
        tolerance=f"touched rows within {SCATTER_RTOL} x slr x sum|g| + 1 f32 ulp of float64; untouched rows "
                  "bit-equal; two launches bit-identical",
        touched_rows=int(touched.numel()),
    )
    log(f"[rowwise kernels] binned_sgd: {touched.numel()} touched rows of {C}, untouched rows bit-equal, two "
        f"launches bit-identical; {json.dumps(k2)}")
    return k1, k2


def rowwise_full_width(data_dir, device, port=None) -> dict:
    """The users' command with ``--use_rowwise`` on the written Criteo-Kaggle
    dataset, in this process: ``dlrm_main.main`` (a one-rank mesh made in
    this process), or, with ``port``, the same flags with ``--multihost
    --coordinator_address 127.0.0.1:PORT --num_processes 1 --process_id 0``
    through ``dlrm_main._rank_main``, what the command starts on this host
    for its one rank (which joins over TCP). The launch counts are zeroed
    just before. Gates: finite losses, a hit rate in (0, 1], AUROC above
    0.5, Kernel 1 once a training and an evaluation step, Kernel 2 once a
    training step and no other update kernel, and the flush (65,536 sampled
    cached rows read from the cache equal in the host table after it, some
    of them trained). Returns its numbers and the embedding (still open)."""
    import hashlib

    import numpy as np
    import torch

    from cachedembedding_tpu_torch import ops
    from cachedembedding_tpu_torch.train import dlrm_main

    argv = ["--dataset_dir", str(data_dir), *CLI_FLAGS, "--use_rowwise"]
    tag = "[rowwise cli]"
    if port is not None:
        argv += ["--multihost", "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "1",
                 "--process_id", "0"]
        tag = "[rowwise cli multihost]"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_launch_counts()
    t0 = time.perf_counter()
    res = (dlrm_main.main(argv) if port is None
           else dlrm_main._rank_main(0, 1, f"tcp://127.0.0.1:{port}", argv, 0))
    _sync(device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses, m, emb = res["losses"], res["metrics"][0], res["embed"]
    log(f"{tag} {' '.join(argv)}: {wall:.1f} s in this process")
    if len(losses) != CLI_TRAIN_BATCHES or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} losses {losses}")
    if not 0.0 < res["hit_rate"] <= 1.0:
        raise AssertionError(f"{tag} hit rate {res['hit_rate']}")
    for stage in ("val", "test"):
        if not m[stage]["auroc"] > 0.5 or m[stage]["count"] != 2 * CLI_BATCH:
            raise AssertionError(f"{tag} {stage}: {m[stage]}")
    if device.type == "cuda":  # (a rehearsal on the CPU runs the plain versions)
        if launches["gather_rows"] != CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES:
            raise AssertionError(f"{tag} Kernel 1 launched {launches['gather_rows']} times, expected one a training "
                                 f"and an evaluation step ({CLI_TRAIN_BATCHES + CLI_EVAL_BATCHES}): {launches}")
        check_update_launches(tag, launches, CLI_TRAIN_BATCHES, "binned_sgd")
    slots, rows = emb.shard.resident()
    pick = np.sort(np.random.default_rng(0).choice(slots.size, min(TABLEWISE_SAMPLE_ROWS, slots.size), replace=False))
    held = emb.global_cache()[torch.from_numpy(slots[pick].astype(np.int64)).to(device)].cpu().numpy()
    before = emb.shard.host_table.gather(rows[pick])
    emb.flush()
    after = emb.shard.host_table.gather(rows[pick])
    moved = int((after != before).any(axis=1).sum())
    if not np.array_equal(after, held) or moved == 0:
        raise AssertionError(f"{tag} flush: {int((after != held).any(axis=1).sum())} of {pick.size} sampled rows "
                             f"differ from the cache's, {moved} moved")
    digest = hashlib.sha256(rows[pick].tobytes() + np.ascontiguousarray(after).tobytes()).hexdigest()
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    out = dict(wall_s=wall, losses=losses, auroc={s: m[s]["auroc"] for s in ("val", "test")},
               hit_rate=res["hit_rate"], launches=launches, host_s_window=res["window_host_s"],
               device_s_window=res["window_device_s"], examples_per_s=res["examples_per_s"][0], peak_gib=peak,
               table_init_s=res["table_init_s"], freq_s=res["freq_s"], swap_in_bytes=res["swap_in_bytes"],
               swap_out_bytes=res["swap_out_bytes"], cache_rows=int(emb.capacity), shard_rows=int(emb.per),
               flush_rows=int(pick.size), flush_trained_rows=moved, flush_digest=digest)
    log(f"{tag} {CLI_TRAIN_BATCHES} steps, val auroc {out['auroc']['val']:.4f}, test auroc {out['auroc']['test']:.4f}; "
        f"hit rate {res['hit_rate']:.4f}; {emb.capacity} f32 cache rows of a {emb.per}-row shard; table filled in "
        f"{res['table_init_s']:.2f} s; kernel launches {launches}")
    log(f"{tag} flush: {pick.size} sampled cached rows equal in the host table, {moved} of them trained")
    log(f"{tag} host s/window {[round(x, 4) for x in out['host_s_window']]}; device s/window "
        f"{[round(x, 4) for x in out['device_s_window']]}; {out['examples_per_s']:.0f} examples/s; peak "
        f"{peak if peak is None else round(peak, 3)} GiB; swap in {res['swap_in_bytes']} B, out "
        f"{res['swap_out_bytes']} B")
    return out, emb


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rowwise_child(data_dir, device_type: str = "cuda") -> int:
    """``chip_smoke.py --rowwise DATA_DIR``: the row-wise phase's process.
    (1) The users' command with ``--use_rowwise`` at full Criteo-Kaggle
    width (``rowwise_full_width``), then Kernels 1 and 2 on its step
    (``check_rowwise_kernels``); (2) the same run as the one rank of a
    one-host ``--multihost`` launch: the same losses, AUROC and flushed
    sample, bit for bit; (3) ROWWISE_SLICE on the card and on the CPU (a
    mesh of the same rank over the mesh's gloo host group): every ``enc``
    and the cache statistics equal, losses within rtol 1e-5, the scored
    probabilities within 1e-6, the flushed master within 1e-6, ``row.py``'s
    lookup and its grads bit-equal, the card's Kernel 1 once a step (the
    scored batch included) and Kernel 2 once a training step. Prints one
    JSON line of its numbers last."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.parallel.mesh import Mesh, destroy_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the CUDA context, before the memory counters are read
    cli, emb = rowwise_full_width(data_dir, device)
    out = {"cli": cli}
    if device.type == "cuda":
        out["gather_rows"], out["binned_sgd"] = check_rowwise_kernels(emb, data_dir, device)
    emb.close()
    del emb
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mh, emb = rowwise_full_width(data_dir, device, port=free_port())
    emb.close()
    del emb
    gc.collect()
    same = {k: mh[k] == cli[k] for k in ("losses", "auroc", "flush_digest")}
    if not all(same.values()):
        raise AssertionError(f"[rowwise cli multihost] differs from the plain run: {same}")
    out["multihost"] = {k: mh[k] for k in ("wall_s", "host_s_window", "device_s_window", "examples_per_s",
                                           "peak_gib")}
    log("[rowwise cli multihost] losses, AUROC and the flushed sample equal to the plain run's, bit for bit")

    tag = "[rowwise small]"
    mesh = make_mesh(1, device_type)
    cpu = Mesh(group=mesh.host_group, host_group=mesh.host_group, rank=0, size=1, device=torch.device("cpu"))
    got, ref = rowwise_small_run(mesh), rowwise_small_run(cpu)
    s = ROWWISE_SLICE
    steps = s["steps"] + s["windows"] * s["window"]
    if not all(np.array_equal(a, b) for a, b in zip(got["enc"], ref["enc"])) or got["stats"] != ref["stats"]:
        raise AssertionError(f"{tag} enc or cache counts differ: {got['stats']} vs the CPU's {ref['stats']}")
    if sum(got["stats"][3]) == 0:
        raise AssertionError(f"{tag} the cache evicted nothing: {got['stats']}")
    if mesh.device.type == "cuda":
        check_update_launches(tag, got["launches"], steps, "binned_sgd")
        if got["launches"]["gather_rows"] != steps + 1:
            raise AssertionError(f"{tag} kernel launches {got['launches']}")
    loss_rel = float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])))
    master_err = float(np.abs(got["master"] - ref["master"]).max())
    probs_err = float(np.abs(got["probs"] - ref["probs"]).max())
    if (not np.isfinite(got["losses"]).all() or loss_rel > 1e-5 or master_err > 1e-6 or probs_err > 1e-6
            or not np.array_equal(got["lookup"], ref["lookup"])
            or not np.array_equal(got["lookup_grad"], ref["lookup_grad"])):
        raise AssertionError(f"{tag} card vs CPU: loss max rel {loss_rel:.2e}, master max abs {master_err:.2e}, "
                             f"probs max abs {probs_err:.2e}, lookup equal "
                             f"{np.array_equal(got['lookup'], ref['lookup'])}")
    out["small"] = dict(loss_max_rel=loss_rel, master_max_abs=master_err, probs_max_abs=probs_err,
                        writebacks=int(sum(got["stats"][3])))
    log(f"{tag} card vs CPU: enc and counts equal ({sum(got['stats'][3])} writebacks); loss max rel diff "
        f"{loss_rel:.2e}; master max abs diff {master_err:.2e}; probs max abs diff {probs_err:.2e}; row.py lookup "
        f"and grads bit-equal")
    destroy_mesh(mesh)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"rowwise_child": out}), flush=True)
    return 0


def phase_rowwise(data_dir) -> dict:
    """Phase 14: ``rowwise_child`` in its own process (its process groups and
    CUDA context end with it), on the CLI phase's dataset. Returns its
    numbers."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--rowwise", str(data_dir)], capture_output=True, text=True,
                          timeout=900)
    for ln in proc.stdout.splitlines()[:-1]:
        log(ln)
    if proc.returncode != 0:
        raise AssertionError(f"[rowwise] exit {proc.returncode}: {proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.splitlines()[-1])["rowwise_child"]
    res["wall_s"] = time.perf_counter() - t0
    log(f"[rowwise] phase done in {res['wall_s']:.1f} s")
    return res


def run_layout_cli(name: str, data_dir, layout: str, extra) -> dict:
    """One run of the users' command with ``layout`` (``--use_tablewise`` or
    ``--use_rowwise``) in its own process (its ranks spawned by the command
    itself). Returns what rank 0 printed: the epoch line's examples/s,
    val/test metrics and its ``run stats``."""
    import re

    argv = [sys.executable, "-m", "cachedembedding_tpu_torch.train.dlrm_main", "--dataset_dir", str(data_dir),
            *CLI_FLAGS, layout, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{name}] exit {proc.returncode}: {proc.stderr[-4000:]}")
    epoch = re.search(r"\] epoch 0: (\d+) iters .*?\(([0-9.]+) it/s, (\d+) ex/s\)", proc.stdout)
    metrics = {s: (float(a), int(c)) for s, a, c in
               re.findall(r"epoch 0 (val|test): auroc=([0-9.]+) accuracy=[0-9.]+ over (\d+)", proc.stdout)}
    stats = json.loads(re.search(r"run stats: (\{.*\})", proc.stderr).group(1))
    if not epoch or set(metrics) != {"val", "test"} or not all(math.isfinite(x) for x in stats["losses"]):
        raise AssertionError(f"[{name}] unexpected output:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[{name}] {wall:.1f} s wall; {epoch.group(1)} steps at {epoch.group(3)} examples/s; val auroc "
        f"{metrics['val'][0]:.6f}, test auroc {metrics['test'][0]:.6f}; host s/window "
        f"{[round(x, 4) for x in stats['window_host_s']]}; device s/window "
        f"{[round(x, 4) for x in stats['window_device_s']]}; peak device bytes {stats['peak_device_bytes']}")
    return dict(wall_s=wall, examples_per_s=float(epoch.group(3)), metrics=metrics, stats=stats)


def run_layout_worlds(layout: str, args) -> int:
    """``--tablewise-worlds 1,4`` / ``--rowwise-worlds 1,4``: the build, the
    CLI phase's dataset, then the users' command with ``--use_tablewise`` /
    ``--use_rowwise`` at each world size in turn (every rank its own card),
    on the same stream. Prints the card's name and power limit, then one
    JSON line: each run's losses, AUROC, host and device s a window,
    examples/s, peak memory, and each run's largest loss difference from the
    first's. No gate but the runs' own; not the smoke run: no ``ok`` line."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from cachedembedding_tpu_torch import _build

    if len(args) != 1:
        print(f"chip_smoke: --{layout}-worlds takes one comma-separated list", file=sys.stderr)
        return 2
    worlds = [int(x) for x in args[0].split(",")]
    phase_build()
    smi = card_name()
    root = Path(tempfile.mkdtemp(prefix="cli_", dir=_build.BUILD_DIR))
    try:
        data_dir = write_cli_dataset(Path(tempfile.mkdtemp(prefix="criteo_kaggle_", dir=root)))
        runs = {w: run_layout_cli(f"{layout} world {w}", data_dir, f"--use_{layout}", ["--world_size", str(w)])
                for w in worlds}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first = np.asarray(runs[worlds[0]]["stats"]["losses"])
    out = {}
    for w, r in runs.items():
        st = r["stats"]
        out[w] = dict(losses=st["losses"], auroc={k: v[0] for k, v in r["metrics"].items()},
                      host_s_window=st["window_host_s"], device_s_window=st["window_device_s"],
                      examples_per_s=r["examples_per_s"], peak_device_bytes=st["peak_device_bytes"],
                      loss_max_rel_vs_first=float(np.max(np.abs(np.asarray(st["losses"]) - first) / np.abs(first))))
    print(smi)
    print(json.dumps({f"{layout}_worlds": out}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cachedembedding_tpu_torch  # noqa: F401  (fails outside the checkout)

    if sys.argv[1:2] == ["--unsorted-plan"]:  # phase 8's child process
        return refuse_unsorted_plan(sys.argv[2])
    if sys.argv[1:2] == ["--mesh"]:  # phase 12's child process
        return mesh_child()
    if sys.argv[1:2] == ["--tablewise"]:  # phase 13's child process
        return tablewise_child(sys.argv[2])
    if sys.argv[1:2] == ["--rowwise"]:  # phase 14's child process
        return rowwise_child(sys.argv[2])
    if sys.argv[1:2] in (["--tablewise-worlds"], ["--rowwise-worlds"]):
        return run_layout_worlds(sys.argv[1][2:-7], sys.argv[2:])
    if sys.argv[1:2] == ["--kernel5-against"]:
        return run_kernel5_against(sys.argv[2:])
    if sys.argv[1:2] == ["--kernel23-against"]:
        return run_kernel23_against(sys.argv[2:])
    if sys.argv[1:2] == ["--fp8-windows"]:
        return run_fp8_windows_cold()
    if sys.argv[1:2] == ["--bench"]:
        return run_bench_only(sys.argv[2:])
    procs = {}
    try:
        return run_phases(procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run_kernel5_against(args) -> int:
    """``--kernel5-against SOURCE``: the build, then phases 9 and 10 with
    their gates, where each of Kernel 5's entries is also timed against the
    same entry built from SOURCE (``kernel5_against_turns``). Prints the
    card's name and power limit, then one JSON line of the turns. Not the
    smoke run: it prints no ``ok`` line."""
    from pathlib import Path

    import torch

    if len(args) != 1:
        print("chip_smoke: --kernel5-against takes one source", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(build_kernel5_against, Path(args[0]).resolve())
        phase_build()
        KERNEL5_AGAINST.update(fut.result())
    _, k5 = phase_terabyte(device)
    gc.collect()
    torch.cuda.empty_cache()
    _, _, k5_ragged = phase_ragged(device)
    print(card_name())
    print(json.dumps({"kernel5_against": {"ordered_scatter_add (1tb step)": k5["against"],
                                          "ordered_grad_update (ragged step)": k5_ragged["against"]}}), flush=True)
    return 0


def run_fp8_windows_cold() -> int:
    """``--fp8-windows``: the build, then phase 6's fp8 windows
    (``phase_fp8_windows``) in this new process twice, the first pass under
    torch.profiler: it prints the first pass's heaviest host operations by
    self time (CUDA's module loading at a kernel's first launch among
    them), then the card, then one JSON line of both passes' window device
    seconds. Not the smoke run: no ``ok`` line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", 0)
    phase_build()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, cold = phase_fp8_windows(device)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=50))
    _, warm = phase_fp8_windows(device)
    print(card_name())
    print(json.dumps({"fp8_windows": {"first_pass_profiled": cold, "second_pass": warm}}), flush=True)
    return 0


KERNEL23 = ("binned_sgd", "binned_scatter_add")  # Kernels 2 and 3: the sources that share row_runs.cuh


def build_kernel23_against(dirs) -> dict:
    """Kernels 2 and 3 built from each directory of ``dirs``: its
    binned_sgd.cu and binned_scatter_add.cu beside its own row_runs.cuh,
    with this checkout's C interface (``ops/_cuda.py``), all compiled at
    once. Returns {directory name: {kernel: C entry}}."""
    import ctypes

    from cachedembedding_tpu_torch import _build
    from cachedembedding_tpu_torch.ops import _cuda

    jobs = {(d.name, k): (lambda d=d, k=k: _build.build(f"lib{k}-{d.name}", [d / f"{k}.cu"], _build.nvcc_command,
                                                         [d / "row_runs.cuh"]))
            for d in dirs for k in KERNEL23}
    out = {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {key: pool.submit(f) for key, f in jobs.items()}
        for (name, k), fut in futs.items():
            path, secs, _ = fut.result()
            log(f"[build] {name}/{k}.cu (nvcc sm_90a): {secs:.1f} s -> {path.name}")
            out.setdefault(name, {})[k] = _cuda.bind(ctypes.CDLL(str(path)), k)
    return out


def kernel2_call(fn, cw, g, accum, perm, grouped, slr: float, eps: float = 0.0) -> None:
    """One launch of a build's Kernel 2 entry ``fn``, as the wrapper makes it."""
    from cachedembedding_tpu_torch.ops import _cuda
    from cachedembedding_tpu_torch.ops.binned_scatter import _DTYPE_CODES, _partials

    L, D = g.shape
    rc = fn(cw.data_ptr(), g.data_ptr(), 0 if accum is None else accum.data_ptr(), perm.data_ptr(),
            grouped.data_ptr(), _partials(L, D, cw.device).data_ptr(), L, D, float(slr), float(eps),
            _DTYPE_CODES[cw.dtype], _DTYPE_CODES[g.dtype], _cuda.stream_of(cw))
    _cuda.check_launch("binned_sgd (against)", rc)


def kernel3_call(fn, g, perm, grouped, num_rows: int):
    """One launch of a build's Kernel 3 entry ``fn``; returns its output."""
    import torch

    from cachedembedding_tpu_torch.ops import _cuda
    from cachedembedding_tpu_torch.ops.binned_scatter import _GRAD_CODES, _partials

    L, D = g.shape
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    rc = fn(out.data_ptr(), g.data_ptr(), perm.data_ptr(), grouped.data_ptr(), _partials(L, D, g.device).data_ptr(),
            L, num_rows, D, _GRAD_CODES[g.dtype], _cuda.stream_of(g))
    _cuda.check_launch("binned_scatter_add (against)", rc)
    return out


def kernel2_bound_ms(L: int, D: int, g_elt: int, n_bins: int, n_touched: int, row_elt: int,
                     adagrad: bool = False) -> float:
    """Kernel 2's bytes bound: the grads, perm and ids, the bin starts, and a
    read and a write of each touched row (and of its 4-byte accumulator)."""
    return (L * D * g_elt + 2 * L * 4 + n_bins * 4 + 2 * n_touched * (D * row_elt + (4 if adagrad else 0))) \
        / HBM_BYTES_PER_S * 1e3


def kernel23_against_cases(device, data_dir):
    """The steps of ``--kernel23-against``, one group at a time (each
    group's trainer is closed before the next is built). Yields
    (case, kernel, run, bound_ms): ``run(fn, fresh)`` launches a build's
    entry ``fn`` once on the case's inputs, from the case's state when
    ``fresh`` (returning the tensors it wrote, for a bit comparison), else
    in place on a working copy (for timing)."""
    import torch

    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.ops.rounding import astype_storage
    from cachedembedding_tpu_torch.train import dlrm_main
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    def first_window(tr, batches):
        win = tr._begin_window(batches)
        return win.slot_ids[0], tuple(a[0] for a in win.plan)

    def sgd_case(cw0, g, plan, slr, accum0=None, eps=0.0):
        perm, grouped, bins = plan
        cw_t, acc_t = cw0.clone(), None if accum0 is None else accum0.clone()
        n_touched = int(torch.unique(grouped).numel())
        bound = kernel2_bound_ms(g.shape[0], g.shape[1], g.element_size(), bins.numel(), n_touched,
                                 cw0.element_size(), accum0 is not None)

        def run(fn, fresh):
            cw, acc = (cw0.clone(), None if accum0 is None else accum0.clone()) if fresh else (cw_t, acc_t)
            kernel2_call(fn, cw, g, acc, perm, grouped, slr, eps)
            return [cw] + ([] if acc is None else [acc])

        return run, bound

    # the slices' first step (bench.py's headline configuration: 901,228 rows of 128)
    cfg = slice_config("bfloat16")
    P, L = cfg.cache.prefetch_num, cfg.batch_size * cfg.num_sparse_features
    train = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, P, skew=0.5, seed=7)
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    _, plan = first_window(tr, [b for _, b in zip(range(P), train)])
    cw16 = tr.embed.cache_weight.clone()
    tr.close()
    (C, D), slr = cw16.shape, cfg.learning_rate
    gen = torch.Generator(device=device).manual_seed(0)
    g16 = (1e-3 * torch.randn((L, D), generator=gen, device=device)).to(torch.bfloat16)
    yield ("bf16 rows, bf16 grads", "binned_sgd", *sgd_case(cw16, g16, plan, slr))
    g32 = 1e-2 * torch.randn((L, D), generator=gen, device=device).abs()
    for name in (FP8, E5M2):
        dt = getattr(torch, name)
        cw8 = astype_storage(cw16.float(), dt)
        yield (f"{name} rows, f32 grads", "binned_sgd", *sgd_case(cw8, g32, plan, slr))
        yield (f"{name} rows, {name} grads", "binned_sgd", *sgd_case(cw8, astype_storage(g32, dt), plan, slr))
    perm, grouped, bins = plan
    for gname, g in (("bf16 grads", g16), ("f32 grads", g32)):
        bound = (8 * L + L * D * g.element_size() + bins.numel() * 4 + C * D * 4) / HBM_BYTES_PER_S * 1e3
        yield (f"Kernel 3, {gname}", "binned_scatter_add",
               lambda fn, fresh, g=g: [kernel3_call(fn, g, perm, grouped, C)], bound)
    del cw16, g16, g32, plan, perm, grouped, bins
    gc.collect()
    torch.cuda.empty_cache()

    # cli adagrad's cached step (bf16 rows) and the resident table's (f32 rows)
    for extra, label in ((["--use_cache"], "cached bf16 rows"), ([], "resident f32 rows")):
        args = dlrm_main.parse_args(["--dataset_dir", str(data_dir), *CLI_FLAGS, *ADAGRAD_FLAGS, *extra])
        cfg = dlrm_main.build_config(args)
        tr = dlrm_main.build_trainer(args, cfg, dlrm_main.get_freq(args, cfg), device)
        batches = [b for _, b in zip(range(cfg.cache.prefetch_num), dlrm_main.get_data(args, cfg, "train"))]
        _, plan = first_window(tr, batches)
        cw, acc = tr.embed.cache_weight, tr.embed.cache_accum
        L, D = plan[0].shape[0], cw.shape[1]
        g = 1e-3 * torch.randn((L, D), generator=gen, device=device)
        g = g if cw.dtype == torch.float32 else g.to(cw.dtype)
        slr, eps = cfg.learning_rate, cfg.adagrad_eps
        if extra:
            yield (f"Adagrad, {label} (cli adagrad)", "binned_sgd", *sgd_case(cw, g, plan, slr, acc, eps))
        else:  # 17 GB: updated in place, its touched rows restored for each fresh launch
            perm, grouped, bins = plan
            t = torch.unique(grouped).long()
            before, acc0 = cw[t].clone(), acc[t].clone()
            for with_acc in (False, True):

                def run(fn, fresh, with_acc=with_acc):
                    if fresh:
                        cw[t], acc[t] = before, acc0
                    kernel2_call(fn, cw, g, acc if with_acc else None, perm, grouped, slr, eps)
                    return [cw[t].clone()] + ([acc[t].clone()] if with_acc else []) if fresh else []

                yield (f"{'Adagrad' if with_acc else 'SGD'}, {label} (cli {'adagrad ' if with_acc else ''}resident)",
                       "binned_sgd", run, kernel2_bound_ms(L, D, 4, bins.numel(), t.numel(), 4, with_acc))
            cw[t], acc[t] = before, acc0
        tr.close()
        del tr, cw, acc, g, plan
        gc.collect()
        torch.cuda.empty_cache()


def run_kernel23_against(args) -> int:
    """``--kernel23-against DIR [DIR ...]``: the build, then Kernels 2 and 3
    of this checkout and of each DIR (``build_kernel23_against``) on the
    steps of ``kernel23_against_cases``: whether each build writes this
    build's bits, device ms in turns (this, the others, then back), and each
    build's device ms by CUDA kernel (``kernel_breakdown``). Prints the
    card's name and power limit, then one JSON line; no ``ok`` line. The
    same bits are reported, not required: a DIR may hold a deliberately
    altered copy, to measure what a part of the kernel costs."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from cachedembedding_tpu_torch import _build
    from cachedembedding_tpu_torch.ops import _cuda

    if not args:
        print("chip_smoke: --kernel23-against takes one or more source directories", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    dirs = [Path(a).resolve() for a in args]
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(build_kernel23_against, dirs)
        phase_build()
        builds = {"this": {k: _cuda.kernel_entry(k) for k in KERNEL23}, **fut.result()}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_", dir=_build.BUILD_DIR))
    out = {}
    try:
        data_dir = write_cli_dataset(Path(tempfile.mkdtemp(prefix="criteo_kaggle_", dir=root)))
        for case, kernel, run, bound in kernel23_against_cases(device, data_dir):
            fns = {src: b[kernel] for src, b in builds.items()}
            want = [x.view(torch.uint8) for x in run(fns["this"], True)]
            same = {}
            for src, fn in fns.items():
                got = [x.view(torch.uint8) for x in run(fn, True)]
                same[src] = all(torch.equal(a, b) for a, b in zip(got, want))
                del got
            del want
            order = list(fns) + list(fns)[::-1]
            turns = {src: [] for src in fns}
            for src in order:
                turns[src].append(device_median_ms(lambda: run(fns[src], False)))
            split = {src: kernel_breakdown(lambda: run(fn, False)) for src, fn in fns.items()}
            out[case] = {"bound_ms": bound, "same_bits": same, "device_ms": turns, "by_cuda_kernel_ms": split,
                         "share": {src: bound / (sum(t) / len(t)) for src, t in turns.items()}}
            log(f"[against] {case}: {json.dumps(out[case])}")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(card_name())
    print(json.dumps({"kernel23_against": out}), flush=True)
    return 0


def run_phases(procs: dict) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    smi = card_name()
    log(f"[build] done in {time.perf_counter() - t0:.1f} s; card: {smi}")
    procs.update(start_unsorted_plan_checks())
    run_cases = check_ordered_run_cases(device)
    bf16_sweep = check_bf16_add_sweep(device)
    for name in REFERENCE_SLICES:
        phase_reference(device, name)
    finish_unsorted_plan_checks(procs)

    cfg = slice_config("bfloat16")
    launches_bf16, tr, win, _ = phase_slice(cfg, device)
    kernels = phase_kernels(cfg, tr, win)
    tr.close()
    del tr, win
    gc.collect()
    torch.cuda.empty_cache()

    cfg8 = slice_config(FP8)
    launches_fp8, tr, win, first_update = phase_slice(cfg8, device)
    k1_fp8, k34 = phase_kernels_fp8(cfg8, tr, win, first_update)
    kernels[0]["on_fp8_slice"] = k1_fp8
    kernels[1]["on_fp8_rows"] = check_kernel2_fp8_rows(first_update[0], win, cfg8.learning_rate)
    kernels[1]["fp8_narrowing"] = check_fp8_narrowing(device)
    kernels += k34
    tr.close()
    del tr, win, first_update
    gc.collect()
    torch.cuda.empty_cache()
    fp8_paths, fp8_windows = phase_fp8_windows(device)
    launches_wire, wire_numbers = phase_wire(device)
    quantized_admits = check_quantized_admits(device)
    gc.collect()
    torch.cuda.empty_cache()
    launches_dp, device_planner = phase_device_planner(device)
    gc.collect()
    torch.cuda.empty_cache()
    launches_1tb, k5 = phase_terabyte(device)
    gc.collect()
    torch.cuda.empty_cache()
    launches_ragged, k1_ragged, k5_ragged = phase_ragged(device)
    kernels[0]["on_ragged_step"] = k1_ragged
    # Kernel 5: its dense ragged entry on this slice's path, its scatter entry on the 1TB run's
    kernels.append({**k5_ragged, "ordered_scatter_add_entry": {
        k: v for k, v in k5.items() if k not in ("name", "route", "source", "replaces")}, "run_cases": run_cases,
                    "bf16_add_sweep": bf16_sweep})
    gc.collect()
    torch.cuda.empty_cache()
    phase_bare_module(device)
    cli = phase_cli(device)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh()
    bench = phase_bench()
    host_link = measure_host_link(device)
    kernels[0]["on_resident_table"] = cli["gather_rows"]
    kernels[1]["on_resident_table"] = cli["binned_sgd"]
    kernels[1]["adagrad_epilogue_on_resident_table"] = cli["binned_adagrad"]
    kernels[1]["adagrad_epilogue_on_cli_adagrad_step"] = cli["binned_adagrad_cached"]
    kernels[0]["on_rowwise_step"] = cli["rowwise"]["gather_rows"]
    kernels[1]["on_rowwise_step"] = cli["rowwise"]["binned_sgd"]

    # the mesh path: its three runs' launches summed
    launches_mesh = {e: sum(r["mesh"]["launches"][e] for r in mesh.values() if isinstance(r, dict) and "mesh" in r)
                     for e in launches_bf16}
    paths = {"bf16 slice": launches_bf16, "fp8 slice": launches_fp8, **fp8_paths, "wire": launches_wire,
             **launches_dp, "1tb sparse": launches_1tb,
             "ragged": launches_ragged, **cli["launches"], "mesh": launches_mesh,
             "bench": {e: bench["launches"].get(e, 0) for e in launches_bf16}}
    for k in kernels:
        name = k["name"]
        entries = KERNEL_ENTRIES.get(name, (name,))
        by_path = {path: sum(counts[e] for e in entries) for path, counts in paths.items()}
        k["launches"] = by_path[MAIN_PATH[name]]
        k["launches_by_path"] = by_path
        if len(entries) > 1:
            k["launches_by_entry"] = {e: {path: counts[e] for path, counts in paths.items()} for e in entries}
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"wire": wire_numbers, "quantized_admits": quantized_admits,
                      "device_planner": device_planner, "fp8_windows": fp8_windows}))
    print(json.dumps({"mesh": mesh, "baseline": cli["baseline"], "host_link": host_link,
                      "bf16_slice": SLICE_NUMBERS.get("bfloat16"), "cli": cli["numbers"], "tablewise": cli["tablewise"],
                      "rowwise": cli["rowwise"], "bench": bench}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
