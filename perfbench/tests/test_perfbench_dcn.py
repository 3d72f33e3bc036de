"""DLRM-DCNv2 in the harness, on the CPU at a tiny size: the configuration
that ``dcn/`` holds as data alone (the port's DCN model, multi-hot bags,
row-wise Adagrad, the device planner, a cache that evicts) reads correct
when sound and not correct under each fault it can have; the benchmark's
reference ``reference/dlrm_dcnv2.py`` and the tests' plain model
``tests/plain_dcnv2.py`` give the same logits and gradients; and the
published shape's shapes and operations."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from perfbench import faults, program, run, spec
from perfbench.reference import dlrm_dcnv2

CPU = torch.device("cpu")
HERE = Path(__file__).resolve().parent
SEEDS = (2**31 + 31, 2**31 + 32, 2**31 + 33)


def dcn():
    """(config, mix, limits) of the tiny DCN case, as its files hold them."""
    return tuple(json.loads((HERE / "dcn" / f"{n}.json").read_text()) for n in ("config", "mix", "limits"))


def _run(config, mix, limits, seed):
    return run.run_cell("tiny-dcn", seed, 0.5, False, CPU, config=config, mix=mix, limits=limits, warmup_iters=8)


@pytest.mark.parametrize("seed", SEEDS)
def test_dcn_case_is_correct(seed):
    out, read = _run(*dcn(), seed)
    assert out["correct"], out["checks"]
    assert read["writeback_rows"] > 0 and "accum_gap" in out["checks"]


@pytest.mark.parametrize("fault", ["rows_unchanged", "writeback_lost", "half_batch", "accum_frozen"])
def test_dcn_case_rejects_faults(fault):
    config, mix, limits = dcn()
    assert fault in faults.faults_of(config)
    with faults.FAULTS[fault]():
        out, _ = _run(config, mix, limits, SEEDS[0])
    assert not out["correct"], out["checks"]


def _plain_module():
    path = HERE.parents[1] / "tests" / "plain_dcnv2.py"
    spec_ = importlib.util.spec_from_file_location("plain_dcnv2_copy", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("lowered", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_the_two_copies_of_the_reference_agree(lowered):
    """On one seeded input, the benchmark's reference and the tests' plain
    model give equal logits and gradients (dense parameters and bags), so
    that neither copy drifts from the other."""
    plain = _plain_module()
    config = dcn()[0]
    params = program.make_dense_params(dlrm_dcnv2.dense_shapes(config["dlrm"]), 2**31 + 5, CPU)
    F, D = len(config["dlrm"]["num_embeddings_per_feature"]), config["dlrm"]["embedding_dim"]
    g = torch.Generator().manual_seed(3)
    dense = torch.rand(32, config["dlrm"]["dense_in_features"], generator=g)
    emb = torch.randn(32, F, D, generator=g) * 0.1
    labels = torch.randint(0, 2, (32,), generator=g)
    outs = []
    for logits in (dlrm_dcnv2.logits, plain.logits):
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        e = emb.clone().requires_grad_(True)
        z = logits(ps, dense, e, lowered)
        plain.bce(z, labels).backward()
        outs.append((z.detach(), {**{k: v.grad for k, v in ps.items()}, "bags": e.grad}))
    (za, ga), (zb, gb) = outs
    assert torch.equal(za, zb)
    assert set(ga) == set(gb) and all(torch.equal(ga[k], gb[k]) for k in ga)


def test_published_shape():
    """The cell's configuration: the model's state dict is the reference's
    shapes, and an example costs 96,169,472 operations."""
    config = spec.config("dlrm-dcnv2-mlperf-cached")
    assert spec.reference(config) is dlrm_dcnv2
    d = config["dlrm"]
    assert sum(d["num_embeddings_per_feature"]) == 204_184_588 and len(d["num_embeddings_per_feature"]) == 26
    assert sum(spec.mix("mlperf-multihot-s050")["bags"]["hotness"]) == 214
    assert dlrm_dcnv2.example_flops(d) == 96_169_472
    shapes = dlrm_dcnv2.dense_shapes(d)
    assert shapes["crossnet.V_kernels.2"] == ((512, 3456), 3456) and shapes["over_arch.0.weight"][0] == (1024, 3456)
    from cachedembedding_tpu_torch.models.dlrm import DLRM

    m = DLRM(d["embedding_dim"], 26, d["dense_in_features"], d["dense_arch_layer_sizes"], d["over_arch_layer_sizes"],
             interaction_type="dcn", dcn_num_layers=3, dcn_low_rank_dim=512)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {k: s for k, (s, _) in shapes.items()}
