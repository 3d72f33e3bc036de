"""The port's command line (``train/dlrm_main.py``) against the JAX package's
on the same Criteo-format npy files, on the CPU: the same flags and defaults,
the same config, the same AUROC and losses (row-wise Adagrad, the sparse
gradient, fp8 rows with rounding off, float8_e5m2 rows, the device planner,
a column-wise mesh of two ranks, and the table-wise and row-sharded cached
layouts on one and two ranks included), the multi-host launch's errors (and
JAX's own refusal of ``--planner device`` with row-wise Adagrad), and
``--world_size`` resolved as JAX resolves it."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import cachedembedding_tpu.models.hybrid as jax_hybrid_mod
import cachedembedding_tpu.parallel.row_cached as jax_row_cached_mod
import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.models.dlrm as port_dlrm
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
import torch_parity as tp
from cachedembedding_tpu.train import dlrm_main as jax_main
from cachedembedding_tpu_torch.ops import rounding as port_rounding
from cachedembedding_tpu_torch.train import dlrm_main as port_main

TABLES = [50, 200, 30]


def write_dataset(d, days=(0, 1, 6), rows=384, seed=0):
    """Kaggle-format days with labels that the dense features and the first
    table's ids predict."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for day in days:
        dense = rng.random((rows, 13)).astype(np.float32)
        sparse = rng.integers(0, 10_000, (rows, len(TABLES))).astype(np.int64)
        logit = 3.0 * (dense[:, 0] - 0.5) + np.where(sparse[:, 0] % 50 < 10, 1.5, -0.5)
        labels = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.int32)
        np.save(d / f"day_{day}_dense.npy", dense)
        np.save(d / f"day_{day}_sparse.npy", sparse)
        np.save(d / f"day_{day}_labels.npy", labels)
    return d


def small_argv(d, *extra):
    return ["--dataset_dir", str(d), "--kaggle", "--num_embeddings_per_feature", ",".join(map(str, TABLES)),
            "--batch_size", "32", "--embedding_dim", "16", "--dense_arch_layer_sizes", "32,16",
            "--over_arch_layer_sizes", "16,1", "--prefetch_num", "2", "--limit_val_batches", "5",
            "--limit_test_batches", "5", "--world_size", "1", "--platform", "cpu", *extra]


# the port's flags that the JAX CLI lacks (DLRM-DCNv2 and its multi-hot synthetic stream), at their defaults
PORT_ONLY_FLAGS = {"interaction_type": "dot", "dcn_num_layers": 3, "dcn_low_rank_dim": 512, "multi_hot_sizes": None}
PORT_ONLY_FIELDS = ("interaction_type", "dcn_num_layers", "dcn_low_rank_dim")


def _jax_flags(args) -> dict:
    """The port's parsed flags but its own ones, which must be at their defaults."""
    got = vars(args)
    assert {k: got.pop(k) for k in PORT_ONLY_FLAGS} == PORT_ONLY_FLAGS
    return got


def test_flags_and_defaults_match_jax():
    assert _jax_flags(port_main.parse_args([])) == vars(jax_main.parse_args([]))
    argv = ["--lr", "0.3", "--use_cache", "--use_freq", "--model", "deepfm", "--cache_dtype", "float32",
            "--transfer_dtype", "bfloat16", "--change_lr", "--validation_freq_within_epoch", "5"]
    assert _jax_flags(port_main.parse_args(argv)) == vars(jax_main.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--dataset_dir", "/data/criteo_kaggle"], ["--dataset_dir", "/data/x", "--kaggle"],
    ["--dataset_dir", "/data/avazu"], ["--dataset_dir", "/data/criteo_1tb"],
    ["--num_embeddings_per_feature", "5,6", "--model", "deepfm", "--cache_dtype", "float8_e4m3fn",
     "--stochastic_rounding", "on", "--use_lfu", "--shuffle_batches", "--epochs", "2"],
])
def test_build_config_matches_jax(argv):
    got = dataclasses.asdict(port_main.build_config(port_main.parse_args(argv)))
    want = dataclasses.asdict(jax_main.build_config(jax_main.parse_args(argv)))
    assert {k: got.pop(k) for k in PORT_ONLY_FIELDS} == {k: PORT_ONLY_FLAGS[k] for k in PORT_ONLY_FIELDS}
    assert got == want


def _record_losses(monkeypatch, cls, sink):
    train = cls.train

    def recording(self, *a, **k):
        rep = train(self, *a, **k)
        sink.extend(rep.losses)
        return rep

    monkeypatch.setattr(cls, "train", recording)


def _metrics(out: str) -> dict:
    return {stage: (float(a), int(n)) for stage, a, n in
            re.findall(r"epoch 0 (val|test): auroc=([0-9.]+) accuracy=[0-9.]+ over (\d+)", out)}


CACHED = ["--use_cache", "--use_freq", "--cache_ratio", "0.8"]


def _as_e5m2(build_config):
    """The JAX CLI offers no float8_e5m2 choice; its trainer stores them.
    Its config is given e5m2 rows after its flags are parsed as e4m3fn."""
    def build(args):
        cfg = build_config(args)
        cfg.cache.cache_dtype = "float8_e5m2"
        return cfg
    return build


@pytest.mark.parametrize("extra,rows", [
    ([*CACHED, "--cache_dtype", "float32"], "f32"),
    (["--cache_dtype", "float32"], "f32"),  # no --use_cache: the resident table (f32 rows)
    ([*CACHED, "--cache_dtype", "float32", "--model", "deepfm"], "f32"),
    (CACHED, "bf16"),  # the CLI's default rows
    ([*CACHED, "--cache_dtype", "float32", "--embedding_optimizer", "rowwise_adagrad", "--learning_rate", "0.1"],
     "f32"),
    ([*CACHED, "--use_sparse_embed_grad"], "exact order"),
    ([*CACHED, "--cache_dtype", "float8_e4m3fn", "--stochastic_rounding", "off"], "fp8"),
    ([*CACHED, "--cache_dtype", "float8_e5m2"], "fp8"),
    ([*CACHED, "--cache_dtype", "float32", "--planner", "device"], "f32"),
], ids=["f32", "resident", "deepfm", "bf16", "adagrad", "use_sparse_embed_grad", "e4m3_rounding_off", "e5m2",
        "planner_device"])
def test_main_matches_jax_on_files(tmp_path, capsys, monkeypatch, extra, rows):
    """Both mains on the same files, one epoch with val/test: f32 rows give
    AUROC within 1e-4 and the losses within rtol 1e-5; the CLI's default
    bf16 rows give losses within rtol 2e-2 and AUROC within 2e-2 (the port
    sums the same bf16 grads in f32 in another order, which moves a row's
    rounding by one ulp). The sparse gradient adds the same bf16 addends in
    the same order in both (1e-4), and fp8 rows (rounding off, or e5m2 with
    JAX's uniforms shared) differ by f32 GEMM order flipping a rounding
    (1e-3). Both write or read the same id_freq_map.npy."""
    if "float8_e5m2" in extra:
        monkeypatch.setattr(jax_main, "build_config", _as_e5m2(jax_main.build_config))
        monkeypatch.setattr(port_rounding, "philox_uniform", tp.jax_uniform)
    d = write_dataset(tmp_path / "criteo_kaggle")
    jl, pl = [], []
    _record_losses(monkeypatch, jax_trainer_mod.CachedDLRMTrainer, jl)
    _record_losses(monkeypatch, port_trainer_mod.CachedDLRMTrainer, pl)
    jax_extra = ["float8_e4m3fn" if x == "float8_e5m2" else x for x in extra]
    jax_main.main(small_argv(d, *jax_extra))
    want = _metrics(capsys.readouterr().out)
    products = dict(port_dlrm.PRODUCTS)
    port_main.main(small_argv(d, *extra))
    captured = capsys.readouterr()
    got = _metrics(captured.out)
    assert set(got) == set(want) == {"val", "test"}
    assert len(pl) == len(jl) == 24 and np.isfinite(pl).all()
    tol, rtol = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2), "exact order": (1e-4, 1e-4), "fp8": (1e-3, 1e-3)}[rows]
    for stage in ("val", "test"):
        assert got[stage][1] == want[stage][1] == 160
        assert abs(got[stage][0] - want[stage][0]) <= tol, (stage, got, want)
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    stats = _run_stats(captured.err)
    assert {"trainer.fetch", "trainer.stage", "cache.plan_host", "cache.admit", "trainer.dispatch",
            "step.forward_backward"} <= set(stats["span_ms_per_window"])
    assert (stats["h2d_bytes"] > 0 and stats["d2h_bytes"] > 0) == ("--use_cache" in extra)
    run_products = {k: v - products[k] for k, v in stats["tower_products"].items()}
    assert run_products["tensor_core"] == 0 and run_products["f32"] > 0  # the CPU
    if "--use_freq" in extra:
        assert "id_freq_map: loaded" in captured.err  # JAX's main wrote it first


@pytest.mark.parametrize("case", ["coordinator_without_counts", "no_coordinator_no_launcher"])
def test_multihost_launch_errors(monkeypatch, case):
    """``--coordinator_address`` without ``--num_processes`` and
    ``--process_id`` exits with the JAX CLI's message, in both mains;
    ``--multihost`` with neither a coordinator nor a launcher's environment
    raises in the port (it never trains one process alone)."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if case == "no_coordinator_no_launcher":
        with pytest.raises(RuntimeError, match="--multihost without --coordinator_address joins a launcher"):
            port_main.main(["--platform", "cpu", "--multihost"])
        return
    argv = ["--platform", "cpu", "--multihost", "--coordinator_address", "127.0.0.1:1", "--num_processes", "2"]
    msgs = []
    for main in (jax_main.main, port_main.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("--coordinator_address requires --num_processes and --process_id")


def test_world_size_two_on_cpu_matches_jax(tmp_path, capfd):
    """``--world_size 2 --platform cpu``: the port spawns two gloo ranks that
    train one column-wise mesh, and only rank 0 prints; JAX's main builds a
    mesh of two of its devices. Cached bf16 rows on the dense branch: AUROC
    within 2e-2 (the tolerance of the one-device bf16 case above)."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    argv = small_argv(d, *CACHED)
    i = argv.index("--world_size")
    argv[i + 1] = "2"
    jax_main.main(argv)
    want = _metrics(capfd.readouterr().out)
    port_main.main(argv)
    captured = capfd.readouterr()
    got = _metrics(captured.out)
    assert set(got) == set(want) == {"val", "test"}
    for stage in ("val", "test"):
        assert got[stage][1] == want[stage][1] == 160
        assert abs(got[stage][0] - want[stage][0]) <= 2e-2, (stage, got, want)
    assert captured.out.count("epoch 0 val: auroc=") == 1  # rank 0 alone prints
    assert captured.err.count("mesh: 2 devices, column-wise hybrid") == 1 and "run stats: {" in captured.err


def test_device_planner_refusals_match_jax(tmp_path, capsys):
    """--planner device with row-wise Adagrad: JAX's main still raises its
    bag's ValueError (its accumulators tier with the host planner's
    staging); the port's main trains, the accumulators moving with the
    device planner's admits and writebacks."""
    argv = small_argv(write_dataset(tmp_path / "criteo_kaggle"), *CACHED, "--planner", "device",
                      "--embedding_optimizer", "rowwise_adagrad", "--learning_rate", "0.1")
    with pytest.raises(ValueError, match="requires the host planner"):
        jax_main.main(argv)
    port_main.main(argv)
    captured = capsys.readouterr()
    assert set(_metrics(captured.out)) == {"val", "test"}
    stats = json.loads(re.search(r"run stats: (\{.*\})", captured.err).group(1))
    assert stats["accum_positive_device_rows"] > 0


DCN_ARGV = ["--num_embeddings_per_feature", "50,200,3000", "--multi_hot_sizes", "3,1,4", "--batch_size", "32",
            "--embedding_dim", "16", "--dense_arch_layer_sizes", "32,16", "--over_arch_layer_sizes", "16,1",
            "--interaction_type", "dcn", "--dcn_num_layers", "2", "--dcn_low_rank_dim", "8",
            "--compute_dtype", "bfloat16", "--use_cache", "--use_freq", "--cache_ratio", "0.1", "--planner", "device",
            "--embedding_optimizer", "rowwise_adagrad", "--learning_rate", "0.1", "--prefetch_num", "2",
            "--limit_train_batches", "8", "--limit_val_batches", "2", "--limit_test_batches", "2",
            "--world_size", "1", "--platform", "cpu"]


def test_dcn_multi_hot_run_on_the_device_planner(capsys):
    """A tiny DLRM-DCNv2 run of the port's command line (flags the JAX CLI
    lacks): the synthetic stream's multi-hot bags of 3, 1 and 4 ids, three
    cross layers' worth of flags, row-wise Adagrad on the device planner
    with a cache that evicts; it trains, evaluates and prints its stats."""
    port_main.main(DCN_ARGV)
    out = capsys.readouterr()
    assert set(_metrics(out.out)) == {"val", "test"}
    assert "interaction_type='dcn', dcn_num_layers=2, dcn_low_rank_dim=8" in out.err
    stats = json.loads(re.search(r"run stats: (\{.*\})", out.err).group(1))
    assert stats["accum_positive_device_rows"] > 0 and stats["accum_positive_host_rows"] > 0
    assert stats["span_ms_per_window"]["cache.admit_accum"] >= 0.0


@pytest.mark.parametrize("extra,err", [
    (["--use_rowwise"], "table-wise and row-wise layouts train the pairwise dots only"),
    (["--use_tablewise"], "table-wise and row-wise layouts train the pairwise dots only"),
    (["--dataset_dir", "/nonexistent/criteo_kaggle"], "takes no --dataset_dir"),
], ids=["rowwise", "tablewise", "dataset_dir"])
def test_dcn_refusals(extra, err):
    with pytest.raises((NotImplementedError, ValueError), match=err):
        port_main.main(DCN_ARGV + extra)


@pytest.mark.parametrize("world_size,cards,ranks", [
    (None, 2, 2), (None, 1, 1), ("1", 4, 1),
], ids=["unset_two_cards", "unset_one_card", "set"])
def test_single_card_note(monkeypatch, world_size, cards, ranks):
    """--world_size resolves as in JAX (``args.world_size or
    len(jax.devices())``): unset, every visible CUDA device on the card, and
    one rank under --platform cpu; more ranks than visible cards raise. (The
    one-line note that the port trained on one card went with the mesh.)"""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    extra = ["--world_size", world_size] if world_size else []
    assert port_main.resolve_world_size(port_main.parse_args(extra)) == ranks
    assert port_main.resolve_world_size(port_main.parse_args(extra + ["--platform", "cpu"])) == 1
    with pytest.raises(ValueError, match=f"--world_size {cards + 1}: {cards} CUDA devices are visible"):
        port_main.resolve_world_size(port_main.parse_args(["--world_size", str(cards + 1)]))


def test_default_platform_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main(["--limit_train_batches", "1"])
    with pytest.raises(ValueError, match="--platform"):
        port_main.main(["--platform", "tpu"])


def test_checkpoint_resume_and_mid_epoch_validation(tmp_path, capsys):
    """--checkpoint_dir saves after the epoch and a second run resumes from
    it; --validation_freq_within_epoch validates every N steps;
    --profile_dir writes a torch.profiler trace; --inspect_time logs every
    step."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    ck, prof = tmp_path / "ckpt", tmp_path / "prof"
    argv = small_argv(d, "--use_cache", "--cache_ratio", "0.8", "--checkpoint_dir", str(ck))
    port_main.main([*argv, "--limit_train_batches", "12", "--validation_freq_within_epoch", "5",
                    "--profile_dir", str(prof)])
    first = capsys.readouterr()
    assert [m for m in re.findall(r"epoch 0 it (\d+): val auroc=", first.out)] == ["5", "10", "12"]
    assert (ck / "meta.json").exists() and (prof / "trace.json").exists()
    port_main.main([*argv, "--limit_train_batches", "2"])
    second = capsys.readouterr()
    assert f"resumed from {ck} at step 12" in second.err
    port_main.main(small_argv(d, "--use_cache", "--cache_ratio", "0.8", "--inspect_time",
                              "--limit_train_batches", "3"))
    out = capsys.readouterr().out
    assert re.findall(r"^it (\d): loss=", out, re.M) == ["2", "3"] and "inspect: " in out


TABLEWISE = ["--use_tablewise", "--use_freq", "--cache_ratio", "0.1"]


def _record_jax_windows(monkeypatch, sink):
    """Record the losses of JAX's ``run_hybrid`` (its model's windows)."""
    train_window = jax_hybrid_mod.HybridParallelDLRM.train_window

    def recording(self, *a, **k):
        out = train_window(self, *a, **k)
        sink.extend(np.asarray(out).tolist())
        return out

    monkeypatch.setattr(jax_hybrid_mod.HybridParallelDLRM, "train_window", recording)


def _run_stats(err: str) -> dict:
    import json

    return json.loads(re.search(r"run stats: (\{.*\})", err).group(1))


@pytest.mark.parametrize("world", ["1", "2"])
def test_tablewise_matches_jax(tmp_path, capfd, monkeypatch, world):
    """``--use_tablewise --platform cpu`` against JAX's ``run_hybrid`` on the
    same files, at one rank (in this process, a gloo group of one) and two
    (spawned ranks; Kaggle's hand-tuned map puts tables 0 and 2 on rank 0,
    table 1 on rank 1): the 24 losses within rtol 1e-5, val and test AUROC
    within 1e-4 (f32 rows: the f32 CLI case's tolerances), the same counts,
    and the cache statistics line JAX prints."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    argv = small_argv(d, *TABLEWISE)
    argv[argv.index("--world_size") + 1] = world
    jl = []
    _record_jax_windows(monkeypatch, jl)
    jax_main.main(argv)
    want_out = capfd.readouterr().out
    want = _metrics(want_out)
    res = port_main.main(argv)
    captured = capfd.readouterr()
    got = _metrics(captured.out)
    pl = _run_stats(captured.err)["losses"]
    assert set(got) == set(want) == {"val", "test"} and len(pl) == len(jl) == 24 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for stage in ("val", "test"):
        assert got[stage][1] == want[stage][1] == 160
        assert abs(got[stage][0] - want[stage][0]) <= 1e-4, (stage, got, want)
    comm = [ln for ln in captured.out.splitlines() if ln.startswith("CacheStats")]
    assert comm and comm[0].split(" swap_in")[0] == [ln for ln in want_out.splitlines()
                                                    if ln.startswith("CacheStats")][0].split(" swap_in")[0]
    assert captured.out.count(f"hybrid[{world}dev,tablewise] epoch 0 val: auroc=") == 1  # rank 0 alone prints
    if world == "1":  # the result the command returns in this process
        assert res["losses"] == pl and res["model"].embed.world == 1 and 0.0 < res["hit_rate"] <= 1.0


def test_tablewise_ignores_flags_as_jax(tmp_path, capfd, monkeypatch):
    """The table-wise layout trains DLRM towers with plain SGD on f32 rows
    and f32 admits whatever --model, --cache_dtype, --embedding_optimizer
    and --transfer_dtype say, in JAX and in the port: the same losses with
    and without them, and the port names them on one stderr line."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    odd = ["--model", "deepfm", "--cache_dtype", "float32", "--embedding_optimizer", "rowwise_adagrad",
           "--transfer_dtype", "int8"]
    runs, jl = {}, []
    _record_jax_windows(monkeypatch, jl)
    for name, extra in (("plain", []), ("odd", odd)):
        jax_main.main(small_argv(d, *TABLEWISE, *extra))
        res = port_main.main(small_argv(d, *TABLEWISE, *extra))
        runs[name] = (list(jl), res["losses"], capfd.readouterr().err)
        jl.clear()
    assert runs["odd"][0] == runs["plain"][0] and runs["odd"][1] == runs["plain"][1]
    line = [ln for ln in runs["odd"][2].splitlines() if ln.startswith("--use_tablewise ignores")]
    assert len(line) == 1 and all(f"--{k} " in line[0] for k in
                                  ("model", "cache_dtype", "embedding_optimizer", "transfer_dtype"))
    assert "--use_tablewise ignores" not in runs["plain"][2]


def test_tablewise_takes_the_kaggle_map_for_any_dataset(cpu_devices):
    """Without a dataset name the table-wise model takes Criteo-Kaggle's
    hand-tuned map, its first F entries, in JAX and in the port: the
    synthetic stream's 4 tables on 2 ranks are [0, 1, 0, 1]."""
    from cachedembedding_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cachedembedding_tpu_torch.models.hybrid import HybridParallelDLRM as PortHybrid
    from cachedembedding_tpu_torch.parallel.mesh import Mesh

    cfg = port_main.build_config(port_main.parse_args(["--use_tablewise", "--embedding_dim", "16",
                                                       "--dense_arch_layer_sizes", "8,16",
                                                       "--over_arch_layer_sizes", "8,1"]))
    jcfg = jax_main.build_config(jax_main.parse_args(["--use_tablewise", "--embedding_dim", "16",
                                                      "--dense_arch_layer_sizes", "8,16",
                                                      "--over_arch_layer_sizes", "8,1"]))
    want = jax_hybrid_mod.HybridParallelDLRM(jcfg, jax_make_mesh(2)).embed.tables_of_rank
    for r in range(2):
        got = PortHybrid(cfg, Mesh(group=None, host_group=None, rank=r, size=2, device=torch.device("cpu")))
        assert got.embed.tables_of_rank == want == [[0, 2], [1, 3]]
        assert got.embed.host_tables[r].num_rows == sum(cfg.num_embeddings_per_feature[t] for t in want[r]) + 1


def test_tablewise_against_the_resident_run(tmp_path, capfd, monkeypatch):
    """At one rank the table-wise host table is the fused table, seed for
    seed, plus a pad row, and f32 caching moves no value, so the table-wise
    run should train as the resident one (no --use_cache). In JAX it does
    so bit for bit only where the resident trainer gets f32 dense inputs:
    its training windows ship them in ``dense_input_dtype``, bf16 by
    default, which the command line does not set, while ``run_hybrid``
    feeds them in f32. So at the command line's flags JAX's two runs differ
    beyond rtol 1e-5, and with f32 dense inputs they are equal; the port's
    two runs, with f32 dense inputs, within rtol 1e-5."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    flags = ["--use_freq", "--cache_ratio", "0.01", "--warmup_ratio", "0.7", "--prefetch_num", "8"]
    tl, rl, rl32, pl32 = [], [], [], []
    _record_jax_windows(monkeypatch, tl)
    jax_main.main(small_argv(d, *flags, "--use_tablewise"))
    _record_losses(monkeypatch, jax_trainer_mod.CachedDLRMTrainer, rl)
    jax_main.main(small_argv(d, *flags))

    def f32_dense(build):
        def build_f32(args):
            cfg = build(args)
            cfg.dense_input_dtype = "float32"
            return cfg
        return build_f32

    monkeypatch.setattr(jax_main, "build_config", f32_dense(jax_main.build_config))
    _record_losses(monkeypatch, jax_trainer_mod.CachedDLRMTrainer, rl32)
    jax_main.main(small_argv(d, *flags))
    port_tw = port_main.main(small_argv(d, *flags, "--use_tablewise"))["losses"]
    monkeypatch.setattr(port_main, "build_config", f32_dense(port_main.build_config))
    _record_losses(monkeypatch, port_trainer_mod.CachedDLRMTrainer, pl32)
    port_main.main(small_argv(d, *flags))
    capfd.readouterr()
    tl, rl, rl32 = (np.asarray(x[:24]) for x in (tl, rl, rl32))
    assert len(tl) == len(rl32) == len(port_tw) == len(pl32) == 24
    assert np.max(np.abs(tl - rl) / np.abs(rl)) > 1e-5  # the bf16 dense wire
    np.testing.assert_array_equal(tl, rl32)
    np.testing.assert_allclose(port_tw, pl32, rtol=1e-5)
    np.testing.assert_allclose(port_tw, tl, rtol=1e-5)


ROWWISE = ["--use_rowwise", "--use_freq", "--cache_ratio", "0.8"]


def _record_jax_rowwise(monkeypatch, sink):
    """Record the losses of JAX's ``run_rowwise`` (its window programs)."""
    build = jax_row_cached_mod.build_rowwise_cached_window

    def recording_build(*a, **k):
        step = build(*a, **k)

        def run(*args):
            out = step(*args)
            sink.extend(np.asarray(out[2]).tolist())
            return out
        return run

    monkeypatch.setattr(jax_row_cached_mod, "build_rowwise_cached_window", recording_build)


@pytest.mark.parametrize("world,extra", [("1", []), ("2", []), ("1", ["--model", "deepfm"])],
                         ids=["world1", "world2", "deepfm"])
def test_rowwise_matches_jax(tmp_path, capfd, monkeypatch, world, extra):
    """``--use_rowwise --platform cpu`` against JAX's ``run_rowwise`` on the
    same files, at one rank (a gloo group of one in this process) and two
    (spawned ranks, two row shards), and with DeepFM: the 24 losses within
    rtol 1e-5, val and test AUROC within 1e-4 (f32 rows: the f32 CLI case's
    tolerances), the same counts, the JAX CLI's lines, and its cache
    statistics up to the swap-out bytes (which the writeback drain counts
    as it lands)."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    argv = small_argv(d, *ROWWISE, *extra)
    argv[argv.index("--world_size") + 1] = world
    jl = []
    _record_jax_rowwise(monkeypatch, jl)
    jax_main.main(argv)
    want_out = capfd.readouterr().out
    want = _metrics(want_out)
    res = port_main.main(argv)
    captured = capfd.readouterr()
    got = _metrics(captured.out)
    pl = _run_stats(captured.err)["losses"]
    assert set(got) == set(want) == {"val", "test"} and len(pl) == len(jl) == 24 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for stage in ("val", "test"):
        assert got[stage][1] == want[stage][1] == 160
        assert abs(got[stage][0] - want[stage][0]) <= 1e-4, (stage, got, want)

    def comm(out):
        return [ln.split(" swap_out")[0] for ln in out.splitlines() if ln.startswith("CacheStats")]

    assert comm(captured.out) == comm(want_out) and len(comm(want_out)) == 1
    final = re.search(rf"rowwise\[{world}dev\] epoch 0: 24 iters .*final loss=([0-9.]+)", captured.out)
    assert final and float(final.group(1)) == pytest.approx(jl[-1], rel=1e-4)
    assert captured.out.count(f"rowwise[{world}dev] epoch 0 val: auroc=") == 1  # rank 0 alone prints
    if world == "1":  # the result the command returns in this process
        assert res["losses"] == pl and res["embed"].world == 1 and 0.0 < res["hit_rate"] <= 1.0
        res["embed"].close()


def test_rowwise_ignores_flags_as_jax(tmp_path, capfd, monkeypatch):
    """The row-sharded layout trains with plain SGD on f32 rows in f32
    whatever --cache_dtype, --embedding_optimizer, --compute_dtype,
    --planner and --stochastic_rounding say, in JAX and in the port: the
    same losses with and without them, and the port names them on one
    stderr line."""
    d = write_dataset(tmp_path / "criteo_kaggle")
    odd = ["--cache_dtype", "float8_e4m3fn", "--embedding_optimizer", "rowwise_adagrad", "--compute_dtype",
           "bfloat16", "--planner", "device", "--stochastic_rounding", "on"]
    runs, jl = {}, []
    _record_jax_rowwise(monkeypatch, jl)
    for name, extra in (("plain", []), ("odd", odd)):
        jax_main.main(small_argv(d, *ROWWISE, *extra))
        res = port_main.main(small_argv(d, *ROWWISE, *extra))
        res["embed"].close()
        runs[name] = (list(jl), res["losses"], capfd.readouterr().err)
        jl.clear()
    assert runs["odd"][0] == runs["plain"][0] and runs["odd"][1] == runs["plain"][1]
    line = [ln for ln in runs["odd"][2].splitlines() if ln.startswith("--use_rowwise ignores")]
    assert len(line) == 1 and all(f"--{k} " in line[0] for k in
                                  ("cache_dtype", "embedding_optimizer", "compute_dtype", "planner",
                                   "stochastic_rounding"))
    assert "--use_rowwise ignores" not in runs["plain"][2]
