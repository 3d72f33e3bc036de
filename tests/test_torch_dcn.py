"""DLRM-DCNv2 in the port (``models/dlrm.py`` with ``interaction_type="dcn"``)
and row-wise Adagrad on the device planner, on the CPU at small widths:

  * the model against the plain reference ``tests/plain_dcnv2.py``: logits
    and every dense and pooled-bag gradient, in f32 compute against the
    reference and in bf16 compute against the reference with its operands
    lowered to bf16; a precision below the stated one fails the same
    tolerances;
  * ragged windows on the device planner with row-wise Adagrad and an
    evicting cache, against a plain loop over the plain reference: rows,
    accumulators and dense parameters;
  * the device planner against the host planner under Adagrad on the same
    stream: rows and accumulators after evictions, after ``flush`` and
    after a checkpoint round trip;
  * the refused options, and the span ``cache.admit_accum``."""

import numpy as np
import pytest
import torch

import plain_dcnv2
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import MultiHotLongTailDataset
from cachedembedding_tpu_torch.models.dlrm import DLRM, bce_with_logits
from cachedembedding_tpu_torch.models.hybrid import HybridParallelDLRM
from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer
from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

TABLES = [50, 300, 4000, 20000]
HOT = [3, 1, 5, 2]
B, D, DIN, P = 64, 16, 5, 2
ARCH = dict(dense_arch_layer_sizes=(32, D), over_arch_layer_sizes=(64, 32, 1))
DCN = dict(interaction_type="dcn", dcn_num_layers=3, dcn_low_rank_dim=8)

# The port and the plain reference multiply the same operands (f32, or the
# same bf16-rounded values, where the reference's ``lowered`` rounds what
# the port keeps in bf16) with f32 products and sums: only the order of the
# f32 sums may differ, which moves a norm by a few f32 last places; a
# rounding flipped by that order moves one element by one bf16 place.
LOGIT_TOL = 1e-5   # relative gap of the logits' norms
GRAD_TOL = 1e-4    # relative gap of each gradient's norm
# one bf16 rounding of the operands moves the logits and gradients by some
# 1e-3 of their norm (measured: 1.5e-3 to 1.7e-3 and 0.15 on the worst
# gradient), a hundred times the tolerances


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _model(dtype: torch.dtype) -> DLRM:
    m = DLRM(D, len(TABLES), DIN, ARCH["dense_arch_layer_sizes"], ARCH["over_arch_layer_sizes"],
             compute_dtype=dtype, seed=5, **DCN)
    with torch.no_grad():  # biases off zero, so that their gradients and products are exercised
        for name, prm in m.named_parameters():
            if name.startswith("crossnet.bias"):
                prm.copy_(torch.randn(prm.shape, generator=torch.Generator().manual_seed(len(name))) * 0.05)
    return m


def _inputs():
    g = torch.Generator().manual_seed(11)
    return (torch.rand(128, DIN, generator=g), torch.randn(128, len(TABLES), D, generator=g) * 0.1,
            torch.randint(0, 2, (128,), generator=g))


def _port(dtype):
    """The port's logits and gradients (dense parameters and the bags), and
    its parameters."""
    m = _model(dtype)
    dense, emb, labels = _inputs()
    emb = emb.requires_grad_(True)
    z = m(dense, emb)
    bce_with_logits(z, labels).backward()
    grads = {n: p.grad for n, p in m.named_parameters()}
    grads["bags"] = emb.grad
    return z.detach(), grads, {n: p.detach().clone() for n, p in m.named_parameters()}


def _plain(params, lowered):
    dense, emb, labels = _inputs()
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    emb = emb.requires_grad_(True)
    z = plain_dcnv2.logits(ps, dense, emb, lowered)
    plain_dcnv2.bce(z, labels).backward()
    grads = {k: v.grad for k, v in ps.items()}
    grads["bags"] = emb.grad
    return z.detach(), grads


def _gaps(port_dtype, lowered):
    z, g, params = _port(port_dtype)
    zr, gr = _plain(params, lowered)
    assert set(g) == set(gr) and len(g) == 2 * 2 + 3 * 3 + 2 * 3 + 1
    return _gap(z, zr), {k: _gap(g[k], gr[k]) for k in g}


@pytest.mark.parametrize("port,lowered", [(torch.float32, None), (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_dcn_matches_the_plain_reference(port, lowered):
    logit_gap, grad_gaps = _gaps(port, lowered)
    assert logit_gap <= LOGIT_TOL
    worst = max(grad_gaps, key=grad_gaps.get)
    assert grad_gaps[worst] <= GRAD_TOL, (worst, grad_gaps[worst])


@pytest.mark.parametrize("port,lowered", [(torch.float32, torch.bfloat16), (torch.bfloat16, None)],
                         ids=["program_f32_vs_lowered", "reference_f32_vs_program_bf16"])
def test_a_lower_precision_fails_the_tolerances(port, lowered):
    """The program in f32 against the bf16-lowered reference, and the f32
    reference against the bf16 program: each side a precision off, the
    logits and the gradients miss the tolerances by far."""
    logit_gap, grad_gaps = _gaps(port, lowered)
    assert logit_gap > 10 * LOGIT_TOL
    assert max(grad_gaps.values()) > 10 * GRAD_TOL


def test_dot_model_has_no_crossnet():
    m = DLRM(D, len(TABLES), DIN, **{k: v for k, v in ARCH.items()})
    assert m.crossnet is None and not any(k.startswith("crossnet") for k in m.state_dict())
    names = list(_model(torch.float32).state_dict())
    assert [n for n in names if n.startswith("crossnet")] == [
        f"crossnet.{k}.{i}" for k in ("V_kernels", "W_kernels", "bias") for i in range(3)]
    assert _model(torch.float32).state_dict()["over_arch.0.weight"].shape == (64, (len(TABLES) + 1) * D)


# -- ragged windows on the device planner with row-wise Adagrad ---------------

LR, EPS = 0.1, 1e-8


def _cfg(planner: str, compute: str = "float32", cache_dtype: str = "float32", **kw) -> DLRMConfig:
    """A small cache (1.5%: 365 slots, evicting from the second window on;
    admits in chunks of 64 rows) over uniform-init tables, f32 dense
    features on both planners' links; ``kw`` overrides the model's fields."""
    fields = dict(num_embeddings_per_feature=TABLES, embedding_dim=D, dense_in_features=DIN, batch_size=B,
                  learning_rate=LR, compute_dtype=compute, embedding_optimizer="rowwise_adagrad", adagrad_eps=EPS,
                  dense_input_dtype="float32", seed=3, **ARCH, **DCN)
    fields.update(kw)
    return DLRMConfig(**fields, cache=CacheConfig(cache_ratio=0.015, prefetch_num=P, planner=planner,
                                                  cache_dtype=cache_dtype, weight_init="uniform", buffer_size=64))


def _data(windows: int, seed: int = 7):
    return MultiHotLongTailDataset(TABLES, B, windows * P, HOT, dense_in_features=DIN, skew=0.5, seed=seed)


def _trainer(planner: str, **kw) -> CachedDLRMTrainer:
    return CachedDLRMTrainer(_cfg(planner, **kw), id_freq_map=_data(16).id_freq_map(), device="cpu")


def _plain_loop(params, table, acc, batches):
    """The plain reference's training: per step, each bag pooled in f32 from
    its rows, the loss's gradients by autograd, each row's lookup gradients
    summed, row-wise Adagrad on the rows, SGD on the dense parameters."""
    params = {k: v.clone() for k, v in params.items()}
    table, acc = table.clone(), acc.clone()
    F = len(TABLES)
    for b in batches:
        f = b.sparse_features
        ids = f.values.long()
        seg = torch.repeat_interleave(torch.arange(F * B), f.lengths().long())  # feature-major bag f * B + b
        look = table[ids].requires_grad_(True)
        emb = torch.zeros(F * B, D).index_add(0, seg, look).view(F, B, D).transpose(0, 1)
        ps = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = plain_dcnv2.loss(ps, b.dense_features, emb, b.labels.float())
        grads = torch.autograd.grad(loss, [*ps.values(), look])
        with torch.no_grad():
            params = {k: v - LR * g for (k, v), g in zip(ps.items(), grads[:-1])}
            rows = torch.unique(ids)
            s = torch.zeros_like(table).index_add_(0, ids, grads[-1])[rows]
            acc[rows] += torch.mean(s * s, dim=1)
            table[rows] -= LR * s / (torch.sqrt(acc[rows]) + EPS)[:, None]
    return params, table, acc


def test_ragged_device_adagrad_matches_a_plain_loop():
    """Three windows of multi-hot ragged bags through the device planner,
    f32 rows and compute, with a cache small enough that rows are evicted,
    written back and admitted again: the rows, their accumulators and the
    dense parameters, wherever they live, against the plain loop (the
    port sums a row's grads in stream order, the loop by ``index_add_``:
    f32 round-off apart)."""
    tr = _trainer("device")
    table0 = torch.from_numpy(tr.embed.host_table.array.copy())
    acc0 = torch.zeros(sum(TABLES))
    params0 = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    batches = list(_data(3))
    tr.train(batches, num_iters=len(batches))
    assert sum(tr.embed.stats.num_write_back_history) > 0  # trained rows went back to the host table
    tr.embed.flush()
    params, table, acc = _plain_loop(params0, table0, acc0, batches)
    rows = np.arange(sum(TABLES), dtype=np.int64)
    np.testing.assert_allclose(tr.embed.host_table.gather(rows), table.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.embed.host_accum.gather(rows), acc.numpy(), rtol=1e-4, atol=1e-10)
    for k, v in tr.model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), params[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    tr.close()


def _host_state(tr):
    """Every row and accumulator of the host table and store, f32."""
    rows = np.arange(sum(TABLES), dtype=np.int64)
    tr.embed._drain_writebacks()
    return tr.embed.host_table.gather(rows), tr.embed.host_accum.gather(rows)


def _live_state(tr):
    """Every row and accumulator where it lives now, without a flush: the
    cache slot of a cached row, else the host table and store (the two
    planners may pick other victims, so their host tables differ until a
    flush)."""
    table, acc = _host_state(tr)
    slots, rows = tr.embed.resident()
    idx = torch.from_numpy(slots.astype(np.int64))
    table[rows] = tr.embed.cache_weight.index_select(0, idx).float().numpy()
    acc[rows] = tr.embed.cache_accum.index_select(0, idx).numpy()
    return table, acc


@pytest.mark.parametrize("cache_dtype,compute", [("float32", "float32"), ("bfloat16", "bfloat16")])
def test_device_planner_matches_the_host_planner_under_adagrad(tmp_path, cache_dtype, compute):
    """The same ragged stream through both planners: equal losses; equal
    rows and accumulators after the evictions (wherever each lives), in the
    host table and store after ``flush``, and after each trainer's checkpoint is loaded into a
    fresh trainer of the other planner and trained on."""
    kw = dict(compute=compute, cache_dtype=cache_dtype)
    trs = {p: _trainer(p, **kw) for p in ("device", "host")}
    losses = {p: tr.train(_data(4), num_iters=4 * P).losses for p, tr in trs.items()}
    assert losses["device"] == losses["host"]
    assert sum(trs["device"].embed.stats.num_write_back_history) > 0
    (rd, ad), (rh, ah) = _live_state(trs["device"]), _live_state(trs["host"])
    np.testing.assert_array_equal(rd, rh)
    np.testing.assert_array_equal(ad, ah)
    for tr in trs.values():
        tr.embed.flush()
    (rd, ad), (rh, ah) = _host_state(trs["device"]), _host_state(trs["host"])
    np.testing.assert_array_equal(rd, rh)
    np.testing.assert_array_equal(ad, ah)
    assert (ad > 0).sum() > 100
    more = {}
    for p, other in (("device", "host"), ("host", "device")):
        save_checkpoint(str(tmp_path / p), trs[p])
        fresh = _trainer(other, **kw)
        assert load_checkpoint(str(tmp_path / p), fresh) == 4 * P
        r, a = _host_state(fresh)
        np.testing.assert_array_equal(r, rd)
        np.testing.assert_array_equal(a, ad)
        more[p] = fresh.train(_data(2, seed=9), num_iters=2 * P).losses
        fresh.embed.flush()
        more[p + "_state"] = _host_state(fresh)
        fresh.close()
    assert more["device"] == more["host"]
    for a, b in zip(more["device_state"], more["host_state"]):
        np.testing.assert_array_equal(a, b)
    for tr in trs.values():
        tr.close()


# -- refusals and the span ------------------------------------------------------

def test_refused_options():
    with pytest.raises(ValueError, match="unknown interaction_type 'cross'"):
        CachedDLRMTrainer(_cfg("device", interaction_type="cross"), device="cpu")
    with pytest.raises(ValueError, match="model 'deepfm' has none"):
        CachedDLRMTrainer(_cfg("device", model="deepfm"), device="cpu")
    with pytest.raises(NotImplementedError, match="dcn' on a mesh"):
        mesh = make_mesh(1, "cpu")
        try:
            CachedDLRMTrainer(_cfg("device"), device="cpu", mesh=mesh)
        finally:
            destroy_mesh(mesh)
    with pytest.raises(NotImplementedError, match="table-wise layout"):
        CachedDLRMTrainer(_cfg("device", use_tablewise=True), device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid layouts train the pairwise dots only"):
        HybridParallelDLRM(_cfg("device"), mesh=object())
    with pytest.raises(ValueError, match="unknown interaction_type"):
        DLRM(D, 2, DIN, (8, D), (8, 1), interaction_type="cross")


def test_admit_accum_span_follows_the_admits():
    """``cache.admit_accum`` sits in a window's spans exactly where the
    device planner's Adagrad window admitted rows (a second pass over the
    same stream, all of it cached, admits none), never on SGD or on the
    host planner."""
    tr = CachedDLRMTrainer(
        DLRMConfig(num_embeddings_per_feature=TABLES, embedding_dim=D, dense_in_features=DIN, batch_size=B,
                   learning_rate=LR, embedding_optimizer="rowwise_adagrad", **ARCH, **DCN,
                   cache=CacheConfig(cache_ratio=0.5, prefetch_num=P, planner="device")),
        id_freq_map=_data(16).id_freq_map(), device="cpu")
    reps = [tr.train(_data(3), num_iters=3 * P) for _ in range(2)]
    misses = tr.embed.stats.num_miss_history
    entries = [e for r in reps for e in r.window_spans]
    assert len(entries) == len(misses) == 6 and misses[0] > 0 and misses[-1] == 0
    for e, n in zip(entries, misses):
        assert ("cache.admit_accum" in e) == (n > 0)
        assert e.get("cache.admit_accum", 0.0) <= e["cache.admit"]
    tr.close()
    for planner, opt in (("device", "sgd"), ("host", "rowwise_adagrad")):
        tr = _trainer(planner, embedding_optimizer=opt)
        rep = tr.train(_data(2), num_iters=2 * P)
        assert sum(tr.embed.stats.num_miss_history) > 0
        assert not any("cache.admit_accum" in e for e in rep.window_spans)
        tr.close()
