"""DeepFM, the second model family, as a torch ``nn.Module`` (counterpart of
``cachedembedding_tpu/models/deepfm.py``).

  * DenseArch: num_dense -> hidden -> D, ReLU after both layers.
  * FM interaction over [dense_emb (B, D)] + the F pooled embeddings:
      - deep: flatten-concat (B, (F+1)*D) -> Linear -> ReLU -> (B, DI);
      - factorization machine: 0.5 * sum_d [(sum_f x)^2 - sum_f x^2] -> (B, 1),
        in f32;
      - output concat [dense_emb, deep, fm] -> (B, D + DI + 1).
  * OverArch: Linear(D + DI + 1, 1) in f32, then Sigmoid: the model emits
    probabilities, and training uses BCE on them (``bce_probs``).

The layers share ``models/dlrm.py``'s ``_linear`` numerics (operands rounded
to ``compute_dtype``, f32 accumulation, one rounding of the bias add), and the
weights come from the JAX package's numpy init (``init_deepfm``), so the same
seed gives the same weights in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
from torch import nn

from cachedembedding_tpu_torch.models.dlrm import _key_seed_seq, _linear, _linear_init_np, _mlp

Layer = Dict[str, np.ndarray]


def init_deepfm(
    seed: int,
    embedding_dim: int,
    num_sparse_features: int,
    num_dense_features: int,
    hidden_layer_size: int,
    deep_fm_dimension: int,
) -> Dict[str, Union[List[Layer], Layer]]:
    """Numpy weights in the JAX ``DeepFMParams`` layout: {"dense_arch": [2
    layers], "deep_fm": layer, "over_arch": layer}, each layer {"w": (in,
    out), "b": (out,)}."""
    ss1, ss2, ss3 = _key_seed_seq(seed).spawn(3)
    rng1 = np.random.default_rng(ss1)
    dense_arch = [
        _linear_init_np(rng1, num_dense_features, hidden_layer_size),
        _linear_init_np(rng1, hidden_layer_size, embedding_dim),
    ]
    fm_in = (num_sparse_features + 1) * embedding_dim
    deep_fm = _linear_init_np(np.random.default_rng(ss2), fm_in, deep_fm_dimension)
    over = _linear_init_np(np.random.default_rng(ss3), embedding_dim + deep_fm_dimension + 1, 1)
    return {"dense_arch": dense_arch, "deep_fm": deep_fm, "over_arch": over}


def _get(params, key):
    return params[key] if isinstance(params, dict) else getattr(params, key)


def _lin_sd(prefix: str, p) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.from_numpy(np.array(p["w"], np.float32).T.copy()),
            f"{prefix}.bias": torch.from_numpy(np.array(p["b"], np.float32))}


def params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """State dict of ``DeepFM`` from JAX ``DeepFMParams`` given as numpy (a
    ``DeepFMParams`` or a dict of the same fields). Each ``w`` is transposed
    to nn.Linear's (out, in)."""
    sd = {}
    for i, p in enumerate(_get(params_np, "dense_arch")):
        sd.update(_lin_sd(f"dense_arch.{i}", p))
    sd.update(_lin_sd("deep_fm", _get(params_np, "deep_fm")))
    sd.update(_lin_sd("over_arch", _get(params_np, "over_arch")))
    return sd


def params_to_jax(model: "DeepFM") -> Dict[str, Union[List[Layer], Layer]]:
    """Inverse of ``params_from_jax``: numpy weights in the JAX layout."""

    def lin(layer: nn.Linear) -> Layer:
        return {"w": layer.weight.detach().cpu().numpy().T.copy(), "b": layer.bias.detach().cpu().numpy().copy()}

    return {"dense_arch": [lin(x) for x in model.dense_arch], "deep_fm": lin(model.deep_fm),
            "over_arch": lin(model.over_arch)}


def factorization_machine(x_bfd: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_d [(sum_f x)^2 - sum_f x^2], the order-2 FM term: (B, 1)."""
    sum_f = x_bfd.sum(dim=1)
    sum_sq = (x_bfd ** 2).sum(dim=1)
    return 0.5 * (sum_f ** 2 - sum_sq).sum(dim=1, keepdim=True)


class DeepFM(nn.Module):
    """DeepFM dense modules: probabilities (B,) from dense features (B, Din)
    and pooled sparse embeddings (B, F, D)."""

    def __init__(
        self,
        embedding_dim: int,
        num_sparse_features: int,
        dense_in_features: int,
        hidden_layer_size: int,
        deep_fm_dimension: int,
        *,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 1024,
        device=None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        params = init_deepfm(seed, embedding_dim, num_sparse_features, dense_in_features,
                             hidden_layer_size, deep_fm_dimension)

        def linear(p) -> nn.Linear:
            return nn.Linear(p["w"].shape[0], p["w"].shape[1], device="meta")

        self.dense_arch = nn.ModuleList(linear(p) for p in params["dense_arch"])
        self.deep_fm = linear(params["deep_fm"])
        self.over_arch = linear(params["over_arch"])
        self.load_state_dict(params_from_jax(params), assign=True)
        if device is not None:
            self.to(device)

    def forward(self, dense_features: torch.Tensor, sparse_bfd: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        dense_emb = _mlp(self.dense_arch, dense_features, dt, final_relu=True)
        combined = torch.cat([dense_emb[:, None, :], sparse_bfd], dim=1)  # (B, F+1, D), promoted
        B = combined.shape[0]
        deep = torch.relu(_linear(self.deep_fm, combined.reshape(B, -1), dt))
        fm = factorization_machine(combined.float())
        cat = torch.cat([dense_emb, deep, fm], dim=1)  # promotes to f32
        logits = _linear(self.over_arch, cat, dt, out_dtype=torch.float32)[:, 0]
        return torch.sigmoid(logits)


def bce_probs(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE on probabilities, in the JAX package's formulation."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    y = labels.to(p.dtype)
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
