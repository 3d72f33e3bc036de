"""Plain reference of the DLRM dense model (arXiv:1906.00091, as the
configurations state it): PyTorch operations only, f32. It imports nothing
of the program. The training around it is ``training.py``'s.

* bottom tower: ``Linear`` + ReLU on every layer, dense features to
  ``embedding_dim``;
* each sparse feature's pooled bag, so the batch's embeddings are ``(B, F,
  D)``;
* interaction: the ``F + 1`` vectors (the bottom tower's output first),
  every pairwise dot product ``i < j`` in row-major order, concatenated
  after the bottom tower's output;
* top tower: ``Linear`` + ReLU on all but the last layer, one logit;
* loss: the batch's mean binary cross-entropy on the logit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .training import rounder


def dense_shapes(dlrm: dict) -> Dict[str, tuple]:
    """Each dense parameter's name (the model's state dict's), shape and
    fan-in, from a configuration's ``dlrm`` fields: the bottom tower from
    the dense features to ``embedding_dim``, the top tower from
    ``embedding_dim`` plus the pairwise dots of the ``F + 1`` vectors to one
    logit."""
    out = {}
    n = len(dlrm["num_embeddings_per_feature"]) + 1
    for arch, fan, sizes in (("dense_arch", dlrm["dense_in_features"], dlrm["dense_arch_layer_sizes"]),
                             ("over_arch", dlrm["embedding_dim"] + n * (n - 1) // 2, dlrm["over_arch_layer_sizes"])):
        for i, o in enumerate(sizes):
            out[f"{arch}.{i}.weight"] = ((o, fan), fan)
            out[f"{arch}.{i}.bias"] = ((o,), fan)
            fan = o
    return out


def _linear_flops(sizes_in_out, first_takes_grad: bool) -> int:
    """Per example, a tower of ``Linear`` layers ``[(in, out), ...]``:
    forward ``2 in out`` a layer, the weight gradient ``2 in out``, the
    input gradient ``2 in out`` on every layer but a first whose input
    takes no gradient."""
    f = 0
    for i, (a, b) in enumerate(sizes_in_out):
        f += 2 * a * b * (3 if (i or first_takes_grad) else 2)
    return f


def example_flops(dlrm: dict) -> int:
    """Operations per training example of the DLRM step (forward and
    backward), from a configuration's ``dlrm`` fields: the bottom tower (its
    first layer's input, the dense features, takes no gradient), the ``P =
    n (n - 1) / 2`` pairwise dots of the ``n = F + 1`` vectors of D (forward
    ``2 P D``; backward, each pair's cotangent into both vectors, ``4 P
    D``), and the top tower from ``D + P`` inputs. Bias, activation and loss
    terms are linear in the widths and left out (under 0.1% of the total)."""
    bottom, top = list(dlrm["dense_arch_layer_sizes"]), list(dlrm["over_arch_layer_sizes"])
    dim = dlrm["embedding_dim"]
    n = len(dlrm["num_embeddings_per_feature"]) + 1
    P = n * (n - 1) // 2
    return (_linear_flops(list(zip([dlrm["dense_in_features"], *bottom[:-1]], bottom)), False) + 6 * P * dim
            + _linear_flops(list(zip([dim + P, *top[:-1]], top)), True))


def _tower(params: Dict[str, torch.Tensor], arch: str, x: torch.Tensor, last_relu: bool, rnd) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith(arch + ".") and k.endswith(".weight"))
    for i in range(n):
        x = rnd(x) @ rnd(params[f"{arch}.{i}.weight"]).t() + params[f"{arch}.{i}.bias"]
        if last_relu or i + 1 < n:
            x = torch.relu(x)
    return x


def logits(params: Dict[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor,
           lowered: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B,) logits from dense features (B, Din) and embeddings (B, F, D).
    With ``lowered``, every product's operands are rounded to that dtype
    first (products and sums stay f32)."""
    rnd = rounder(lowered)
    z = _tower(params, "dense_arch", dense, True, rnd)
    v = rnd(torch.cat([z[:, None, :], emb], dim=1))
    n = v.shape[1]
    r, c = torch.triu_indices(n, n, 1, device=v.device)
    dots = torch.bmm(v, v.transpose(1, 2))[:, r, c]
    return _tower(params, "over_arch", torch.cat([z, dots], dim=1), False, rnd)[:, 0]
