"""The port's DLRM module against the JAX package's dense towers: identical
init from a seed, weight transfer both ways, and the same logits, loss and
gradients (dense params and gathered rows) on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.models import dlrm as jax_dlrm
from cachedembedding_tpu_torch.models.dlrm import (
    DLRM,
    bce_with_logits,
    init_dlrm_dense,
    params_from_jax,
    params_to_jax,
)

ARCH = dict(embedding_dim=16, num_sparse_features=5, dense_in_features=4,
            dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1))


def _jax_params(seed):
    a = ARCH
    return jax_dlrm.init_dlrm_dense(
        seed, a["embedding_dim"], a["num_sparse_features"], a["dense_in_features"],
        a["dense_arch_layer_sizes"], a["over_arch_layer_sizes"],
    )


def test_same_seed_same_init():
    ref = _jax_params(1234)
    mine = init_dlrm_dense(1234, *ARCH.values())
    for arch in ("dense_arch", "over_arch"):
        for a, b in zip(getattr(ref, arch), mine[arch]):
            np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
            np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])
    model = DLRM(*ARCH.values(), seed=1234)
    for arch in ("dense_arch", "over_arch"):
        for a, lin in zip(getattr(ref, arch), getattr(model, arch)):
            np.testing.assert_array_equal(np.asarray(a["w"]).T, lin.weight.detach().numpy())


def test_params_from_jax_round_trip():
    ref = _jax_params(99)
    model = DLRM(*ARCH.values(), seed=0)
    model.load_state_dict(params_from_jax(ref))
    back = params_to_jax(model)
    for arch in ("dense_arch", "over_arch"):
        for a, b in zip(getattr(ref, arch), back[arch]):
            np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])  # (in, out) again
            np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_backward_matches_jax(dtype):
    """f32: rtol 1e-5 (sums in another order). bf16: rtol 2e-2, because bf16
    rounds at different points if the two frameworks ever disagree on where;
    the port keeps the f32 bias add with one rounding, the cotangent rounding
    of the interaction backward and the f32 logits head."""
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 1e-4)
    rng = np.random.default_rng(7)
    B, F, D, Din = 32, ARCH["num_sparse_features"], ARCH["embedding_dim"], ARCH["dense_in_features"]
    dense = rng.random((B, Din), dtype=np.float32)
    sparse = (0.3 * rng.standard_normal((B, F, D))).astype(np.float32)
    labels = rng.integers(0, 2, size=B).astype(np.float32)
    params = _jax_params(5)
    cd = jnp.dtype(dtype)

    def loss_fn(p, s):
        logits = jax_dlrm.dlrm_dense_forward(p, jnp.asarray(dense), s, cd)
        return jax_dlrm.bce_with_logits(logits, jnp.asarray(labels)), logits

    (loss_ref, logits_ref), (gp_ref, gs_ref) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(sparse)
    )
    model = DLRM(*ARCH.values(), compute_dtype=getattr(torch, dtype), seed=5)
    s = torch.from_numpy(sparse).requires_grad_(True)
    logits = model(torch.from_numpy(dense), s)
    loss = bce_with_logits(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), rtol=rtol, atol=atol)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=rtol)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs_ref), rtol=rtol, atol=atol)
    for arch in ("dense_arch", "over_arch"):
        for g, lin in zip(getattr(gp_ref, arch), getattr(model, arch)):
            np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(g["w"]), rtol=rtol, atol=atol)
            np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(g["b"]), rtol=rtol, atol=atol)


def test_refuses_gather_interaction():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DLRM(*ARCH.values(), interaction_impl="gather")
