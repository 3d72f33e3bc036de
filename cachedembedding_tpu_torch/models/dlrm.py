"""DLRM dense towers + feature interaction as a torch ``nn.Module``
(counterpart of ``cachedembedding_tpu/models/dlrm.py``).

  * DenseArch — MLP with ReLU on every layer.
  * InteractionArch — concat [dense_emb, sparse (B, F, D)], pairwise dot
    products by batched matmul, upper-triangle (offset 1) flatten, concat with
    dense_emb.
  * OverArch — MLP with ReLU on all but the final linear layer.

Numerics follow the JAX package so that both give the same values:
  * each linear layer multiplies operands rounded to ``compute_dtype`` with
    f32 accumulation, adds the f32 bias, and rounds once to the compute dtype
    (``_linear``); the logits head stays f32;
  * the interaction's backward rounds the symmetrized cotangent to the
    operand dtype before its grad-dot (``_PairwiseDots``).
Exact products of bf16 operands fit an f32 mantissa, so the f32 matmul of the
rounded operands is the f32-accumulated bf16 matmul.

The weights are initialized by the JAX package's numpy routine (copied here:
``_key_seed_seq``, ``_linear_init_np``, ``init_dlrm_dense``), so the same seed
gives the same weights in both packages. ``nn.Linear`` stores weight as
(out, in): the transpose of the JAX ``w`` (in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


def choose(n: int, k: int) -> int:
    return math.comb(n, k) if 0 <= k <= n else 0


# ---------------------------------------------------------------------------
# numpy init, shared bit-for-bit with the JAX package
# ---------------------------------------------------------------------------

def _key_seed_seq(seed: int) -> np.random.SeedSequence:
    """The JAX package's SeedSequence for an int seed (the entropy it derives
    from ``jax.random.PRNGKey(seed)``: [hi32, lo32])."""
    s = int(seed)
    return np.random.SeedSequence([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF])


def _linear_init_np(rng: np.random.Generator, in_f: int, out_f: int) -> Dict[str, np.ndarray]:
    """torch.nn.Linear default init: W, b ~ U(+-1/sqrt(fan_in)); W is (in, out)."""
    bound = 1.0 / math.sqrt(in_f)
    return {
        "w": rng.uniform(-bound, bound, (in_f, out_f)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (out_f,)).astype(np.float32),
    }


def init_dlrm_dense(
    seed: int,
    embedding_dim: int,
    num_sparse_features: int,
    dense_in_features: int,
    dense_arch_layer_sizes: Sequence[int],
    over_arch_layer_sizes: Sequence[int],
) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Numpy weights in the JAX ``DLRMParams`` layout:
    {"dense_arch": [{"w": (in, out), "b": (out,)}, ...], "over_arch": [...]}."""
    ss1, ss2 = _key_seed_seq(seed).spawn(2)
    if dense_in_features <= 0:
        dense_arch: List[Dict[str, np.ndarray]] = []
        over_in = choose(num_sparse_features, 2)
    else:
        if dense_arch_layer_sizes[-1] != embedding_dim:
            raise ValueError("DenseArch output dim must equal embedding_dim for the interaction")
        rng1 = np.random.default_rng(ss1)
        dense_arch = []
        in_f = dense_in_features
        for out_f in dense_arch_layer_sizes:
            dense_arch.append(_linear_init_np(rng1, in_f, out_f))
            in_f = out_f
        over_in = embedding_dim + choose(num_sparse_features + 1, 2)
    if len(over_arch_layer_sizes) <= 1:
        raise ValueError("OverArch must have multiple layers.")
    rng2 = np.random.default_rng(ss2)
    over_arch = []
    in_f = over_in
    for out_f in over_arch_layer_sizes:
        over_arch.append(_linear_init_np(rng2, in_f, out_f))
        in_f = out_f
    return {"dense_arch": dense_arch, "over_arch": over_arch}


def params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """State dict of ``DLRM`` from JAX ``DLRMParams`` given as numpy (a
    ``DLRMParams`` or a dict with ``dense_arch``/``over_arch`` lists of
    {"w": (in, out), "b": (out,)}). Each ``w`` is TRANSPOSED to nn.Linear's
    (out, in); biases carry over as they are."""
    get = (lambda k: params_np[k]) if isinstance(params_np, dict) else (lambda k: getattr(params_np, k))
    sd = {}
    for arch in ("dense_arch", "over_arch"):
        for i, p in enumerate(get(arch)):
            sd[f"{arch}.{i}.weight"] = torch.from_numpy(np.array(p["w"], np.float32).T.copy())
            sd[f"{arch}.{i}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
    return sd


def params_to_jax(model: "DLRM") -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Inverse of ``params_from_jax``: numpy weights in the JAX layout."""
    return {
        arch: [
            {"w": lin.weight.detach().cpu().numpy().T.copy(), "b": lin.bias.detach().cpu().numpy().copy()}
            for lin in getattr(model, arch)
        ]
        for arch in ("dense_arch", "over_arch")
    }


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Matmul of ``dtype``-rounded operands with f32 accumulation; the bias
    add is f32 and rounds once to ``dtype`` (or ``out_dtype``)."""
    y = x.to(dtype).float() @ layer.weight.to(dtype).float().t()
    return (y + layer.bias).to(out_dtype or dtype)


def _mlp(layers: nn.ModuleList, x: torch.Tensor, dtype: torch.dtype, final_relu: bool = True) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = _linear(layer, x, dtype)
        if final_relu or i + 1 < len(layers):
            x = torch.relu(x)
    return x


class _PairwiseDots(torch.autograd.Function):
    """(B, n, n) f32 pairwise dots of a (B, n, D) compute-dtype input. The
    backward rounds the symmetrized cotangent to the operand dtype before the
    grad-dot, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, combined: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(combined)
        c = combined.float()
        return torch.bmm(c, c.transpose(1, 2))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (combined,) = ctx.saved_tensors
        gsym = (g + g.transpose(1, 2)).to(combined.dtype)
        d = torch.bmm(gsym.float(), combined.float())
        return d.to(combined.dtype)


class DLRM(nn.Module):
    """DLRM dense modules: logits (B,) from dense features (B, Din) and pooled
    sparse embeddings (B, F, D)."""

    def __init__(
        self,
        embedding_dim: int,
        num_sparse_features: int,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        *,
        compute_dtype: torch.dtype = torch.float32,
        interaction_impl: str = "bmm",
        seed: int = 1024,
        device=None,
    ):
        super().__init__()
        if interaction_impl != "bmm":
            raise NotImplementedError(
                "interaction_impl='gather' is ROADMAP Queue 1 item 3 (models)"
            )
        self.compute_dtype = compute_dtype
        params = init_dlrm_dense(
            seed, embedding_dim, num_sparse_features, dense_in_features,
            dense_arch_layer_sizes, over_arch_layer_sizes,
        )

        def linears(arch):
            return nn.ModuleList(
                nn.Linear(p["w"].shape[0], p["w"].shape[1], device="meta") for p in params[arch]
            )

        self.dense_arch = linears("dense_arch")
        self.over_arch = linears("over_arch")
        self.load_state_dict(params_from_jax(params), assign=True)
        if device is not None:
            self.to(device)
        n = num_sparse_features + (1 if self.dense_arch else 0)
        r, c = np.triu_indices(n, k=1)
        self.register_buffer("_triu_r", torch.as_tensor(r, dtype=torch.long, device=device), persistent=False)
        self.register_buffer("_triu_c", torch.as_tensor(c, dtype=torch.long, device=device), persistent=False)

    def interaction(self, dense_emb: Optional[torch.Tensor], sparse_bfd: torch.Tensor) -> torch.Tensor:
        """(B, D + pairs) with the dense embedding, else (B, pairs)."""
        dt = self.compute_dtype
        if dense_emb is not None:
            combined = torch.cat([dense_emb[:, None, :].to(dt), sparse_bfd.to(dt)], dim=1)
        else:
            combined = sparse_bfd.to(dt)
        flat = _PairwiseDots.apply(combined)[:, self._triu_r, self._triu_c]
        if dense_emb is not None:
            return torch.cat([dense_emb, flat], dim=1)  # promotes to f32
        return flat

    def forward(self, dense_features: Optional[torch.Tensor], sparse_bfd: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        dense_emb = _mlp(self.dense_arch, dense_features, dt) if len(self.dense_arch) else None
        x = self.interaction(dense_emb, sparse_bfd)
        x = _mlp(self.over_arch[:-1], x, dt, final_relu=True)
        # the (B, 1) head stays f32: the BCE mean over the batch wants it
        logits = _linear(self.over_arch[-1], x, dt, out_dtype=torch.float32)
        return logits[:, 0]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean BCEWithLogitsLoss, in the JAX package's formulation."""
    labels = labels.to(logits.dtype)
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )
