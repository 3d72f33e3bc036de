"""The port's multi-host launch (the counterpart of
``tests/test_multiprocess.py``), on the CPU: two processes, each one host of
``--multihost --coordinator_address 127.0.0.1:<port> --num_processes 2
--process_id p --world_size 2 --platform cpu`` (so each spawns one gloo
rank, and the ranks meet over TCP), against one process at ``--world_size
2`` (which spawns both ranks itself, meeting through a file): the
column-wise mesh with int8 admits through eviction churn, the table-wise
layout and the row-sharded cached layout give the same metrics, and the same
final loss where the layout prints one; and a row-sharded bag's flushed
master (``tests/torch_dist.py::rowwise_flush_case``) is the same on both
hosts and equal to the one-process run's, byte for byte (the collectives
are the same gloo calls either way).

Processes write to files, not pipes: draining two live pipes one after the
other can block a process whose pipe filled mid-collective, and its peer
with it."""

import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

COMMON = [
    "--platform", "cpu", "--world_size", "2",
    "--use_cache", "--cache_ratio", "0.04", "--use_freq",
    "--batch_size", "128", "--embedding_dim", "32",
    "--num_embeddings_per_feature", "4000,4000,4000,4000",
    "--dense_arch_layer_sizes", "32,32", "--over_arch_layer_sizes", "32,1",
    "--limit_train_batches", "24", "--limit_val_batches", "2",
    "--limit_test_batches", "2", "--prefetch_num", "2",
]
LAYOUTS = {
    "column": COMMON + ["--transfer_dtype", "int8", "--use_overlap"],
    "tablewise": COMMON + ["--use_tablewise"],
    "rowwise": COMMON + ["--use_rowwise"],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + os.path.join(REPO, "tests") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _metrics(out: str) -> dict:
    m = {}
    for stage in ("val", "test"):
        g = re.search(rf"{stage}: auroc=([0-9.]+) accuracy=([0-9.]+)", out)
        assert g, f"no {stage} metrics in output:\n{out[-2000:]}"
        m[stage] = (float(g.group(1)), float(g.group(2)))
    g = re.search(r"final loss=([0-9.]+)", out)
    if g:
        m["loss"] = float(g.group(1))
    return m


def _wait(cmds, tmp_path, tag) -> list:
    """Run the commands at once, each writing to its own file; returns their
    outputs, each checked for exit code 0."""
    procs, files = [], []
    for i, cmd in enumerate(cmds):
        f = open(tmp_path / f"{tag}{i}.log", "w+")
        files.append(f)
        procs.append(subprocess.Popen(cmd, env=_env(), cwd=REPO, stdout=f, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p, f in zip(procs, files):
            p.wait(timeout=TIMEOUT_S)
            f.seek(0)
            out = f.read()
            assert p.returncode == 0, f"{tag} process failed:\n{out[-3000:]}"
            outs.append(out)
    finally:
        for p, f in zip(procs, files):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return outs


def _cli(extra):
    return [sys.executable, "-m", "cachedembedding_tpu_torch.train.dlrm_main", *extra]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_hosts_match_one_process(tmp_path, layout):
    args = LAYOUTS[layout]
    port = _free_port()
    hosts = _wait([_cli(["--multihost", "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
                         "--process_id", str(p), *args]) for p in range(2)], tmp_path, "host")
    m0, m1 = _metrics(hosts[0]), _metrics(hosts[1])  # each host's first rank prints
    assert m0 == m1, f"hosts disagree: {m0} vs {m1}"
    one = _metrics(_wait([_cli(args)], tmp_path, "single")[0])
    assert m0 == one, f"two hosts {m0} != one process {one}"
    if layout == "column":
        assert "swap_out" in hosts[0]  # the churn's statistics were printed
    else:
        assert "loss" in m0


def test_two_hosts_flush_the_same_master(tmp_path):
    """``dense_weight`` on two hosts: each owner broadcasts its shard, so
    both hosts hold the same master, byte for byte, equal to the master of
    the same run with both ranks in one process."""
    port = _free_port()
    outs = [str(tmp_path / f"master{p}.pkl") for p in range(2)]
    code = ("import sys, torch_dist; "
            "torch_dist.tcp_rank('rowwise_flush_case', sys.argv[1], 2, int(sys.argv[2]), sys.argv[3])")
    _wait([[sys.executable, "-c", code, f"127.0.0.1:{port}", str(p), outs[p]] for p in range(2)], tmp_path, "flush")
    hosts = [pickle.loads(open(o, "rb").read()) for o in outs]
    assert hosts[0][0] == hosts[1][0], "the hosts reconstructed different masters"
    single = torch_dist.spawn("rowwise_flush_case", 2, tmp_path / "single")
    assert single[0][0] == single[1][0] == hosts[0][0]
    assert hosts[0][1].shape == (1024, 16) and np.isfinite(hosts[0][1]).all()


@pytest.mark.parametrize("local,env,want", [(0, None, 0), (None, "0", 0), (1, None, None), (None, None, None)],
                         ids=["local_rank", "LOCAL_RANK", "card_not_visible", "one_host_too_many"])
def test_make_mesh_takes_the_local_card(monkeypatch, local, env, want):
    """On the card a rank's card is its local rank (the command's spawn
    index, else the launcher's LOCAL_RANK), not its global rank: global rank
    1 of 2, its host's only rank, runs on card 0 of the one visible. A local
    rank past the visible cards raises, and without a local rank a mesh
    larger than the visible cards does (one host)."""
    import torch

    from cachedembedding_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if env is not None:
        monkeypatch.setenv("LOCAL_RANK", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(port_mesh.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(port_mesh.dist, "new_group", lambda **k: "host group")
    if want is None:
        msg = "rank 1 runs on card 1; 1 CUDA devices" if local is not None else "a mesh of 2 ranks needs 2 CUDA"
        with pytest.raises(ValueError, match=msg):
            port_mesh.make_mesh(2, "cuda", local_rank=local)
        return
    m = port_mesh.make_mesh(2, "cuda", local_rank=local)
    assert (m.rank, m.size, m.device, m.host_group) == (1, 2, torch.device("cuda", want), "host group")


def test_world_size_splits_over_hosts(monkeypatch):
    """Under ``--multihost --coordinator_address`` the world is every host's
    ranks: unset, one rank a host on the CPU and every visible card of every
    host on the card; it must split evenly over the hosts, and a host's
    share, not the whole world, is held against its visible cards."""
    import torch

    from cachedembedding_tpu_torch.train import dlrm_main as port_main

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mh = ["--multihost", "--coordinator_address", "127.0.0.1:1", "--num_processes", "2", "--process_id", "1"]

    def world(*extra):
        return port_main.resolve_world_size(port_main.parse_args([*mh, *extra]))

    assert world("--platform", "cpu") == 2 and world("--platform", "cpu", "--world_size", "4") == 4
    assert world() == 4 and world("--world_size", "2") == 2
    with pytest.raises(ValueError, match="--world_size 3 does not split evenly over 2 processes"):
        world("--platform", "cpu", "--world_size", "3")
    with pytest.raises(ValueError, match=r"--world_size 6 \(3 a process\): 2 CUDA devices are visible"):
        world("--world_size", "6")
