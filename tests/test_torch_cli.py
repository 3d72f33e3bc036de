"""The port's command line (``train/dlrm_main.py``) against the JAX package's
on the same Criteo-format npy files, on the CPU: the same flags and defaults,
the same config, the same AUROC and losses (row-wise Adagrad, the sparse
gradient, fp8 rows with rounding off, float8_e5m2 rows and the device
planner included), a refusal naming its ROADMAP item for every flag outside
the port (and JAX's own refusal of ``--planner device`` with row-wise
Adagrad), and the note
on stderr where several GPUs are visible and ``--world_size`` is unset."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
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


def test_flags_and_defaults_match_jax():
    assert vars(port_main.parse_args([])) == vars(jax_main.parse_args([]))
    argv = ["--lr", "0.3", "--use_cache", "--use_freq", "--model", "deepfm", "--cache_dtype", "float32",
            "--transfer_dtype", "bfloat16", "--change_lr", "--validation_freq_within_epoch", "5"]
    assert vars(port_main.parse_args(argv)) == vars(jax_main.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--dataset_dir", "/data/criteo_kaggle"], ["--dataset_dir", "/data/x", "--kaggle"],
    ["--dataset_dir", "/data/avazu"], ["--dataset_dir", "/data/criteo_1tb"],
    ["--num_embeddings_per_feature", "5,6", "--model", "deepfm", "--cache_dtype", "float8_e4m3fn",
     "--stochastic_rounding", "on", "--use_lfu", "--shuffle_batches", "--epochs", "2"],
])
def test_build_config_matches_jax(argv):
    got = dataclasses.asdict(port_main.build_config(port_main.parse_args(argv)))
    want = dataclasses.asdict(jax_main.build_config(jax_main.parse_args(argv)))
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
    assert "run stats: {" in captured.err
    if "--use_freq" in extra:
        assert "id_freq_map: loaded" in captured.err  # JAX's main wrote it first


@pytest.mark.parametrize("flag,item", [
    (["--use_tablewise"], 9), (["--use_rowwise"], 9), (["--multihost"], 9), (["--world_size", "2"], 9),
])
def test_refused_flags_name_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item {item}\b"):
        port_main.main(["--platform", "cpu", *flag])


def test_device_planner_refusals_match_jax(tmp_path):
    """--planner device with row-wise Adagrad: both mains raise the bag's
    ValueError (the accumulators tier with the host planner's staging)."""
    argv = small_argv(write_dataset(tmp_path / "criteo_kaggle"), *CACHED, "--planner", "device",
                      "--embedding_optimizer", "rowwise_adagrad")
    for main in (jax_main.main, port_main.main):
        with pytest.raises(ValueError, match="requires the host planner"):
            main(argv)


@pytest.mark.parametrize("world_size,cards,noted", [
    (None, 2, True), (None, 1, False), ("1", 4, False),
], ids=["unset_two_cards", "unset_one_card", "set"])
def test_single_card_note(tmp_path, capsys, monkeypatch, world_size, cards, noted):
    """With --world_size unset and more than one CUDA device visible, the
    port says on stderr, in one line, that it trains on one card where the
    JAX CLI would use every visible device (ROADMAP Queue 1 item 9)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    argv = small_argv(write_dataset(tmp_path / "criteo_kaggle"), "--limit_train_batches", "1")
    i = argv.index("--world_size")
    del argv[i : i + 2]
    port_main.main(argv + (["--world_size", world_size] if world_size else []))
    lines = [ln for ln in capsys.readouterr().err.splitlines() if "--world_size is unset" in ln]
    assert len(lines) == int(noted)
    if noted:
        assert f"{cards} CUDA devices" in lines[0] and "ROADMAP Queue 1 item 9" in lines[0]


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
