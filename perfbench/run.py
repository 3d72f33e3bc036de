"""Run one cell of the benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the cell's configuration and mix are found by name (``spec.py``);
the trainer (``cachedembedding_tpu_torch``) is built with tables and dense
weights made on the device from ``--seed``; its first three steps run
through ``train`` and are read back for the check; it warms up past
eviction onset; the batches of the window are made (outside the clock)
for as many iterations as the warm rate fills ``--seconds``; the state
that the window's first two training windows start from is read back;
then one continuous ``train`` call is timed, up to its eviction
writebacks' drain and a device synchronize, with one read-back of the
state inside it, when the trainer pulls the batch after those two
windows. ``setup_s`` is the time from process start to that call less the
seconds spent in ``Stream.batches``: the harness's own batch making, whose
count follows the program's rate, is no set-up of the program's. With
``--trace 1`` the trainer then trains ten more windows, the
last eight under ``torch.profiler``, whose trace feeds the per-layer
metrics that read the device; those that read the program's spans and
counters read the timed window's. After the window the program is freed
and the plain reference (the dense model that the configuration names,
``reference/<name>.py``, trained by ``reference/training.py``) runs the
first three steps from the seed and the two windows from the state read
before them; ``check.py`` decides ``correct``.

Standard error carries the progress, and last the numbers compared, each
beside its limit; standard output's last line is the result. The run
fails without a CUDA card (it never falls back to the CPU) and when JAX or
the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches of anything that compiles, at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / ".bench_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, program, spec, stats, trace  # noqa: E402
from perfbench.reference import training  # noqa: E402
from perfbench.traffic import Stream  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cachedembedding_tpu"}
GIB = 2 ** 30
TRACE_WINDOWS = 10  # windows a --trace 1 run trains after its timed window, the last 8 traced
STRETCH_WINDOWS = 2  # the timed call's first windows that the check compares


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(device)}, power limit not read ({e})"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """The window's batches, in order. Stamps the host clock when the
    trainer pulls each training window's first batch, and calls
    ``on_window(i)`` there with the window's index."""

    def __init__(self, batches: list, per_window: int, on_window=None):
        self.batches, self.per_window, self.on_window = batches, per_window, on_window
        self.stamps: List[float] = []

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i % self.per_window == 0:
                self.stamps.append(time.perf_counter())
                if self.on_window is not None:
                    self.on_window(i // self.per_window)
            yield b


@dataclasses.dataclass
class Cell:
    """A cell's parts, and the program built for it."""

    config: dict
    limits: dict
    reference: object  # the configuration's reference module (``spec.reference``)
    cfg: object
    stream: Stream
    trainer: object
    params0: dict
    device: torch.device


def prepare(cell: str, seed: int, device: torch.device, config: Optional[dict] = None,
            mix: Optional[dict] = None, limits: Optional[dict] = None) -> Cell:
    """Find the cell's files and build its trainer from ``seed``:
    configuration and mix files unless given."""
    if config is None or mix is None or limits is None:
        w = spec.workload(spec.load_benchmark(), cell)
        config = config or spec.config(w["config"])
        mix = mix or spec.mix(w["traffic"])
        limits = limits or spec.limits(cell)
    cfg = program.dlrm_config(config, mix, seed)
    stream = Stream(mix, cfg.num_embeddings_per_feature, cfg.dense_in_features, seed, device)
    freq = stream.freq_map() if config["embedding"] == "cached" else None
    trainer = program.build_trainer(config, cfg, freq, device)
    ref = spec.reference(config)
    params0 = program.make_dense_params(ref.dense_shapes(config["dlrm"]), seed, device)
    program.load_dense(trainer, params0)
    return Cell(config, limits, ref, cfg, stream, trainer, params0, device)


def _lookups(batch):
    """A batch's lookups in the order the program feeds their grads to its
    embedding update: the global ids (int64) and each one's bag ``b * F +
    f``, or None where every bag holds one id. Uniform bags of P ids come
    in Kernel 1's (B * P, F) order (row ``b * P + k`` holds each feature's
    k-th id of example b), ragged ones in their flat feature-major stream."""
    v = batch.sparse_features
    F, B = v.num_features, v.batch_size
    vals = v.values.numpy().astype(np.int64)
    if v.offsets is None and v.pooling is not None:
        N = vals.shape[0] // F
        look = vals.reshape(F, N).T.reshape(-1)
        if v.pooling == 1:
            return look, None
        return look, (np.arange(N)[:, None] // v.pooling * F + np.arange(F)[None, :]).reshape(-1)
    seg = np.repeat(np.arange(F * B), np.diff(v.offsets_or_implicit().numpy()))  # f * B + b
    return vals, seg % B * F + seg // B


def _touched(batches: list) -> np.ndarray:
    return np.unique(np.concatenate([b.sparse_features.values.numpy() for b in batches]).astype(np.int64))


class State(NamedTuple):
    """The program's state as the check reads it: the dense parameters,
    rows in their storage dtype as a step reads them (a row that the host
    table holds in f32 is rounded as an admit rounds it), the mask of rows
    read from the host table, and the rows' Adagrad accumulators (None
    under SGD)."""

    dense: dict
    rows: torch.Tensor
    host: np.ndarray
    acc: Optional[torch.Tensor]


def _state(c: Cell, ids: np.ndarray) -> State:
    rows, host = program.read_rows(c.trainer, ids)
    return State(program.dense_state(c.trainer), rows.to(program.storage_dtype(c.trainer)).float(), host,
                 program.read_accum(c.trainer, ids))


def run_prefix(c: Cell, batches: list) -> dict:
    """The program's first three steps through ``train`` (a window of one,
    then one of two), with its state read before step 1, after step 1 and
    after step 3 (dense parameters and the rows those steps touch), and
    the grad rows its embedding update was fed on step 1."""
    ids = _touched(batches[:3])
    s0 = _state(c, ids)
    with program.update_grads(c.trainer, 1) as fed:
        losses = list(c.trainer.train(batches[:1], num_iters=1).losses)
    s1 = _state(c, ids)
    losses += c.trainer.train(batches[1:3], num_iters=2).losses
    s3 = _state(c, ids)
    return {"ids": ids, "losses": losses, "s0": s0, "s1": s1, "s3": s3, "fed": fed[0] if fed else None}


def free_program(c: Cell) -> None:
    c.trainer.close()
    c.trainer = None
    gc.collect()
    if c.device.type == "cuda":
        torch.cuda.empty_cache()


def _row_grads(fed: torch.Tensor, batch, ids: np.ndarray) -> torch.Tensor:
    """The fed grad rows (a row a lookup, in ``_lookups``' order) summed
    per compact row."""
    look = _lookups(batch)[0]
    out = torch.zeros((ids.shape[0], fed.shape[1]), dtype=torch.float64)
    return out.index_add_(0, torch.from_numpy(np.searchsorted(ids, look)), fed.double())


def reference_steps(batches: list, ids_dev: torch.Tensor) -> List[training.Step]:
    """The reference's steps of ``batches``, each lookup mapped into the
    compact rows ``ids_dev`` (sorted global ids, on the reference's
    device)."""
    out, dev = [], ids_dev.device
    for b in batches:
        look, bag = _lookups(b)
        out.append(training.Step(torch.searchsorted(ids_dev, torch.from_numpy(look).to(dev)),
                                 None if bag is None else torch.from_numpy(bag).to(dev),
                                 b.dense_features.to(dev), b.labels.to(dev), b.sparse_features.num_features))
    return out


def _table_of(cfg, ids: np.ndarray) -> np.ndarray:
    offs = np.concatenate([[0], np.cumsum(cfg.num_embeddings_per_feature)])
    return np.searchsorted(offs, ids, side="right") - 1


def compare(c: Cell, prefix: dict, batches: list, stretch: dict, witness: bool = False) -> dict:
    """The reference's steps from the benchmark's inputs (the start) and
    from the program's state before the timed stretch, and the readings of
    the program's against them. With ``witness``, also the readings of the
    reference run with the configuration's lower precisions
    (``train_steps(lowered=...)``) in the program's place, under
    ``witness``."""
    cfg, dev, F = c.cfg, c.device, c.cfg.num_sparse_features
    prec = c.config["precision"]
    stored = getattr(torch, prec["stored_rows"])
    lowered = getattr(torch, prec["tower_operands"])
    adagrad = cfg.embedding_optimizer == "rowwise_adagrad"

    def train(params, rows, steps, keep, low, acc):
        return training.train_steps(
            c.reference.logits, params, rows, steps, cfg.learning_rate, stored, prec["row_update"],
            prec.get("row_grad_sum", "float32"), keep, low, cfg.reduction_mode,
            training.Adagrad(acc, cfg.adagrad_eps) if adagrad else None)

    def lv(st, table):
        return check.leaves(st[0], st[1], table, F)

    ids = prefix["ids"]
    table = _table_of(cfg, ids)
    ids_dev = torch.as_tensor(ids, device=dev)
    rows0 = training.canonical_rows(ids_dev, cfg.num_embeddings_per_feature, cfg.seed,
                                    cfg.embedding_dim).to(stored).float()
    acc0 = torch.full((ids.shape[0],), float(cfg.adagrad_initial)) if adagrad else None
    steps = reference_steps(batches[:3], ids_dev)
    p = prefix
    prog = {"losses": p["losses"], "s0": lv(p["s0"], table), "s1": lv(p["s1"], table), "s3": lv(p["s3"], table),
            "grad_tables": check.leaves({}, _row_grads(p["fed"], batches[0], ids), table, F)}
    s0 = lv(({k: v.cpu() for k, v in c.params0.items()}, rows0.cpu()), table)

    def start_ref(low):
        ref = train(c.params0, rows0, steps, (1, 3), low, acc0)
        return {"losses": ref["losses"], "s0": s0, "s1": lv(ref["after"][1], table),
                "s3": lv(ref["after"][3], table), "grad_tables": check.leaves({}, ref["row_grad"], table, F)}

    ref = start_ref(None)
    read = check.readings(prog, ref, cfg.learning_rate)
    wit = check.readings(start_ref(lowered), ref, cfg.learning_rate) if witness else None

    sids = stretch["ids"]
    st = _table_of(cfg, sids)
    ssteps = reference_steps(stretch["batches"], torch.as_tensor(sids, device=dev))
    A, B = stretch["A"], stretch["B"]
    hm = torch.from_numpy(B.host)
    sA = lv(A, st)
    n = len(ssteps)

    def stretch_ref(low):
        r = train({k: v.to(dev) for k, v in A.dense.items()}, A.rows.to(dev), ssteps, (1, n), low, A.acc)
        end = r["after"][n]
        out = {"losses": r["losses"], "sA": sA, "s1": lv(r["after"][1], st), "sB": lv(end, st),
               "host": {"A": A.rows[hm], "B": end[1][hm]}}
        if adagrad:
            out["acc"] = {"A": A.acc, "B": end[2]}
        return out

    sref = stretch_ref(None)
    sprog = {"losses": stretch["losses"], "sA": sA, "sB": lv(B, st), "host": {"A": A.rows[hm], "B": B.rows[hm]}}
    if adagrad:
        sprog["acc"] = {"A": A.acc, "B": B.acc}
    read.update(check.stretch_readings(sprog, sref, cfg.learning_rate))
    if witness:
        wit.update(check.stretch_readings(stretch_ref(lowered), sref, cfg.learning_rate))
        read["witness"] = {k: v for k, v in wit.items() if not k.startswith("losses")}
    return read


def _spans(trainer) -> None:
    """Wrap the trainer's window stages (plan and stage, with its id
    encoding, packing, update plans and shipping; finish; dispatch) and the
    cache's planner in the benchmark's own profiler spans (``bench.*``), for
    the rest of the process."""
    from torch.profiler import record_function

    def wrap(obj, attr, name):
        f = getattr(obj, attr)

        def spanned(*a, **k):
            with record_function(name):
                return f(*a, **k)

        setattr(obj, attr, spanned)

    import cachedembedding_tpu_torch.train.trainer as trainer_mod

    for attr, name in (("_begin_window", "bench.plan_and_stage"), ("_finish_window", "bench.finish_window"),
                       ("_dispatch_window", "bench.dispatch_window"), ("_encode_ids", "bench.encode_ids"),
                       ("_dense_parts", "bench.pack_dense"), ("_admit_parts", "bench.pack_admits"),
                       ("_ship", "bench.ship")):
        wrap(trainer, attr, name)
    for attr, name in (("begin_window_staging", "bench.cache_plan"), ("begin_prepare", "bench.cache_plan_device"),
                       ("finish_prepare", "bench.cache_finish")):
        if hasattr(trainer.embed, attr):
            wrap(trainer.embed, attr, name)
    for attr, name in (("sort_plan_np", "bench.sort_plan"), ("sort_plan", "bench.sort_plan_device")):
        wrap(trainer_mod, attr, name)


@dataclasses.dataclass
class Run:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    cfg: object
    cached: bool
    batch_size: int
    steps: int
    windows: int
    seconds: float
    examples_per_s: float
    report: object
    stats: object
    row_bytes: int
    lookups_per_step: int  # ids a step: the batch times the ids of an example's bags
    example_flops: int  # the dense model's operations a training example (its reference's ``example_flops``)
    trace: Optional[trace.Trace] = None
    unique_per_step: Optional[float] = None
    window_intervals: Optional[List[float]] = None  # seconds from one training window's first pull to the next


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: torch.device, config: Optional[dict] = None,
             mix: Optional[dict] = None, limits: Optional[dict] = None, warmup_iters: Optional[int] = None,
             witness: bool = False):
    """One run of ``cell``; returns the result line's object and every
    reading of the check (``compare``)."""
    from cachedembedding_tpu_torch.cache.manager import CacheStats

    cuda = device.type == "cuda"
    say(f"card: {card_line(device) if cuda else 'cpu'}; cell {cell}, seed {seed}, {seconds} s, trace {int(traced)}")
    c = prepare(cell, seed, device, config, mix, limits)
    cfg, pn, B = c.cfg, max(1, c.cfg.cache.prefetch_num), c.cfg.batch_size
    say(f"trainer built: {cfg.total_num_embeddings:,} rows x {cfg.embedding_dim}, "
        f"{c.config['embedding']}, rows stored in {c.config['cache']['cache_dtype']}")
    warm = max(3, int(c.config["warmup_iters"] if warmup_iters is None else warmup_iters))
    gen_s = 0.0  # seconds in Stream.batches, left out of setup_s

    def make_batches(start: int, n: int, **kw):
        nonlocal gen_s
        _sync(device)  # the program's queued work stays the program's
        t = time.perf_counter()
        out = c.stream.batches(start, n, **kw)
        gen_s += time.perf_counter() - t
        return out

    warm_batches = make_batches(0, warm)
    prefix = run_prefix(c, warm_batches)
    first3 = warm_batches[:3]
    say(f"steps 1-3 read back; losses {prefix['losses']}")
    # the warm-up's last chunk, one train call of up to 16 windows, gives the
    # steady rate: its steps after its first window over their time
    last = min(16 * pn, warm - 3)
    done = 3
    while done < warm - last:
        n = min(8 * pn, warm - last - done)
        c.trainer.train(warm_batches[done:done + n], num_iters=n)
        done += n
    feed = Feed(warm_batches[done:warm], pn)
    c.trainer.train(feed, num_iters=last)
    _sync(device)
    it_s = (last - pn) / (time.perf_counter() - feed.stamps[1]) if last > pn else 1.0
    # the trainer pulls a window's first batch once the windows before it
    # are enqueued (host planner) or all but the last (device planner, which
    # plans the next window ahead of the current one's steps)
    at = STRETCH_WINDOWS + (1 if c.trainer.device_planner else 0)
    n_win = max(at + 1, round(it_s * seconds / pn))
    steps = n_win * pn
    say(f"warm-up {warm} iterations, the last {last} at {it_s:.2f} it/s after their first window: "
        f"the window gets {n_win} windows of {pn}")
    batches = make_batches(warm, steps)
    tail, uniq = make_batches(warm + steps, TRACE_WINDOWS * pn, unique=True) if traced else (None, None)
    say(f"batch making: {gen_s:.2f} s for {warm + len(batches) + len(tail or [])} batches "
        f"(outside the window and out of set-up)")
    del warm_batches
    # the check's stretch: the state before the timed call, and (in the
    # call) when the trainer pulls the first batch after the stretch
    k = STRETCH_WINDOWS * pn
    stretch = {"batches": batches[:k], "ids": _touched(batches[:k])}
    stretch["A"] = _state(c, stretch["ids"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    c.trainer.embed.stats = CacheStats()
    pause = [0.0]

    def at_window(i: int) -> None:
        if i == at:
            t = time.perf_counter()
            stretch["B"] = _state(c, stretch["ids"])
            pause[0] = time.perf_counter() - t

    feed = Feed(batches, pn, at_window)
    gc.collect()
    gc.freeze()  # the harness's own heap (the window's batches) out of the collector's way
    to_window = time.perf_counter() - T_START
    setup_s = to_window - gen_s
    t0 = time.perf_counter()
    rep = c.trainer.train(feed, num_iters=steps)
    drain = getattr(c.trainer.embed, "_drain_writebacks", None)
    if drain is not None:
        drain()
    _sync(device)
    wall = time.perf_counter() - t0
    peak = max(peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
    window_stats = c.trainer.embed.stats
    losses = np.asarray(rep.losses, np.float64)
    failed = int((~np.isfinite(losses)).sum()) + (steps - losses.shape[0])
    stretch["losses"] = rep.losses[:k]
    say(f"window: {steps} steps in {wall:.3f} s (the check's read-back after step {k} took {pause[0]:.3f} s of "
        f"it: {stretch['ids'].shape[0]} rows, {int(stretch['B'].host.sum())} of them from the host table); host "
        f"{statistics.median(rep.window_host_s) * 1e3:.1f} ms, device "
        f"{statistics.median(rep.window_device_s) * 1e3 if rep.window_device_s else float('nan'):.1f} ms "
        f"a window (medians)")

    tr = None
    if traced and cuda:
        # the traced windows follow the timed one, on the same trainer: the
        # profiler's cost and its trace's processing stay out of the window
        from torch.profiler import ProfilerActivity, profile, schedule

        _spans(c.trainer)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=1, warmup=1, active=TRACE_WINDOWS - 2, repeat=1))
        prof.start()
        t = time.perf_counter()
        c.trainer.train(Feed(tail, pn, lambda i: prof.step()), num_iters=len(tail))
        if drain is not None:
            drain()
        _sync(device)
        prof.stop()
        traced_s = time.perf_counter() - t
        tr = trace.from_profiler(prof)
        del prof
        say(f"traced {TRACE_WINDOWS - 2} of {TRACE_WINDOWS} further windows ({traced_s:.2f} s); trace read in "
            f"{time.perf_counter() - t - traced_s:.1f} s; idle share of the traced span "
            f"{trace.idle_share(tr)} (the profiler's host cost stretches it)")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"refused: the run loaded {', '.join(found)}")

    intervals = stats.intervals(feed.stamps)
    metrics = {}
    bench = spec.load_benchmark()
    if not traced:
        e2e = {
            "examples_per_s": (stats.rate(steps * B, wall), "examples/s"),
            "peak_hbm_gib": (peak / GIB, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        for m in spec.metrics_of(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]][0], "unit": m["unit"]}
    say(f"window intervals: {len(intervals)}, median {statistics.median(intervals) * 1e3:.1f} ms, "
        f"p95 {stats.percentile(intervals, 95) * 1e3:.1f} ms; {stats.rate(steps * B, wall):.0f} examples/s; "
        f"peak {peak / GIB:.4f} GiB; set-up {setup_s:.3f} s ({to_window:.3f} s to the first timed step, less "
        f"{gen_s:.3f} s of batch making)")
    run = Run(cfg=cfg, cached=c.config["embedding"] == "cached", batch_size=B,
              steps=steps, windows=n_win, seconds=wall, examples_per_s=stats.rate(steps * B, wall), report=rep,
              stats=window_stats, row_bytes=c.trainer.embed.cache_weight.element_size(),
              lookups_per_step=B * sum(c.stream.hotness), example_flops=c.reference.example_flops(c.config["dlrm"]),
              trace=tr,
              unique_per_step=float(np.mean(uniq)) if uniq else None, window_intervals=intervals)
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        if tr is not None and tr.device:
            lo, hi = trace.window(tr)
            dev_info["busy_s"] = trace.busy_seconds(tr)
            dev_info["window_s"] = hi - lo
            breakdown = trace.breakdown(tr)
        for m in spec.metrics_of(bench, cell, "per_layer"):
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del batches, feed, tail
    gc.unfreeze()
    free_program(c)
    t = time.perf_counter()
    read = compare(c, prefix, first3, stretch, witness)
    correct, checks = check.judge(read, c.limits)
    correct = correct and failed == 0
    say(f"reference ({time.perf_counter() - t:.1f} s): losses {read['losses_ref']}; leaves compared: dense "
        f"{read['kept_dense']}, tables {read['kept_tables']}; worst leaves: "
        + ", ".join(f"{k} {read[k + '.worst']:.4g} ({read[k + '.leaf']})" for k in read if k + ".worst" in read)
        + f"; writeback rows {read['writeback_rows']}")
    for k, v in checks.items():
        say(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}")
    say(f"check correct {correct} (failed steps {failed} of {steps})")
    out = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, read


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    a = p.parse_args(argv)
    w = spec.workload(spec.load_benchmark(), a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"refused: cell {a.workload} needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    out, _ = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), device)
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
