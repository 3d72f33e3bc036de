"""The benchmark's cell reads what it read before the harness took other
models, multi-hot bags and row-wise Adagrad: at the tiny size, the stream,
the frequency map, the initial dense weights and the reference's outputs
are bit for bit the values recorded from the harness before that change
(SHA-256 digests of their bytes, first 16 hex digits). The reference runs
on one thread: the CPU's f32 products sum in another order on more."""

import hashlib

import numpy as np
import pytest
import torch

from perfbench import program, run, spec
from perfbench.reference import training
from perfbench.tests.tiny import tiny
from perfbench.traffic import Stream

SEED = 2**31 + 77
CPU = torch.device("cpu")
DENSE_NAMES = [f"{a}.{i}.{w}" for a, n in (("dense_arch", 3), ("over_arch", 5))
               for i in range(n) for w in ("weight", "bias")]
RECORDED = {
    "stream": "e7da193382461c35",
    "unique": [166, 183, 184, 180, 178],
    "freq": "be4cbe36397e1fd8",
    "dense0": "d4350a047934d111",
    # (row_update, lowered): losses, first row grads, state after step 1, after step 3
    ("per_step", None): ([0.6924630999565125, 0.6911572217941284, 0.6964766383171082],
                         "0ed5fb4aba9e3160", "b867ef90d0564709", "1b6cfd1f644887dd"),
    ("per_step", torch.bfloat16): ([0.6924630999565125, 0.6911560297012329, 0.6964755058288574],
                                   "df47ddcf74ba1942", "7209e839560d101a", "973164901ddc4af1"),
    ("per_addend", None): ([0.6924630999565125, 0.6911571621894836, 0.6964766979217529],
                           "0ed5fb4aba9e3160", "05370e1c9823fbda", "ff36a60ed2f85499"),
    ("per_addend", torch.bfloat16): ([0.6924630999565125, 0.6911558508872986, 0.6964754462242126],
                                     "df47ddcf74ba1942", "9d4fdac1dae7cd2e", "03823ab35a279c36"),
}


def _digest(*ts) -> str:
    m = hashlib.sha256()
    for t in ts:
        m.update(torch.as_tensor(t).detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return m.hexdigest()[:16]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    config, mix, _ = tiny("cached")
    cfg = program.dlrm_config(config, mix, SEED)
    stream = Stream(mix, cfg.num_embeddings_per_feature, cfg.dense_in_features, SEED, CPU)
    return config, cfg, stream


def test_stream_and_frequency_map_unchanged(cell):
    _, _, stream = cell
    bs = stream.batches(0, 6)
    assert _digest(*[b.sparse_features.values for b in bs], *[b.dense_features for b in bs],
                   *[b.labels for b in bs]) == RECORDED["stream"]
    assert stream.batches(3, 5, unique=True)[1] == RECORDED["unique"]
    assert _digest(torch.from_numpy(stream.freq_map())) == RECORDED["freq"]


def test_initial_dense_weights_unchanged(cell):
    config, _, _ = cell
    p0 = program.make_dense_params(spec.reference(config).dense_shapes(config["dlrm"]), SEED, CPU)
    assert list(p0) == DENSE_NAMES
    assert _digest(*p0.values()) == RECORDED["dense0"]


@pytest.mark.parametrize("row_update", ["per_step", "per_addend"])
@pytest.mark.parametrize("lowered", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_reference_outputs_unchanged(cell, one_thread, row_update, lowered):
    config, cfg, stream = cell
    bs = stream.batches(0, 3)
    ids = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in bs]).astype(np.int64))
    ids_t = torch.as_tensor(ids)
    rows0 = training.canonical_rows(ids_t, cfg.num_embeddings_per_feature, cfg.seed,
                                    cfg.embedding_dim).to(torch.bfloat16).float()
    ref = spec.reference(config)
    p0 = program.make_dense_params(ref.dense_shapes(config["dlrm"]), SEED, CPU)
    r = training.train_steps(ref.logits, p0, rows0, run.reference_steps(bs, ids_t), cfg.learning_rate,
                             torch.bfloat16, row_update, keep=(1, 3), lowered=lowered)
    losses, grads, after1, after3 = RECORDED[(row_update, lowered)]
    assert r["losses"] == losses
    assert _digest(r["row_grad"]) == grads
    for n, want in ((1, after1), (3, after3)):
        params, rows, acc = r["after"][n]
        assert acc is None
        assert _digest(*[params[k] for k in DENSE_NAMES], rows) == want
