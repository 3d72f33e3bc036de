"""Plain reference of the DLRM-DCNv2 dense model (MLPerf Training's
recommendation model since v3.0: torchrec's ``DLRM_DCN`` with its
``LowRankCrossNet``, arXiv:2008.13535), as the configurations state it:
PyTorch operations only, f32. It imports nothing of the program. The
training around it is ``training.py``'s. ``tests/plain_dcnv2.py`` holds the
same model for the CPU tests, and a test holds the two equal.

* bottom tower: ``Linear`` + ReLU on every layer, dense features to
  ``embedding_dim``;
* each sparse feature's pooled bag, so the batch's embeddings are ``(B, F,
  D)``;
* interaction: ``x_0``, the bottom tower's output and the F bags
  concatenated, dense first, into ``(B, (F + 1) D)``, then ``L`` low-rank
  cross layers ``x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l`` with ``V_l``
  ``(r, N)``, ``W_l`` ``(N, r)``, ``b_l`` ``(N,)``, ``N = (F + 1) D``;
* top tower from ``x_L``: ``Linear`` + ReLU on all but the last layer, one
  logit;
* loss: the batch's mean binary cross-entropy on the logit.

Departures from torchrec: the initial weights are the benchmark's
(``program.make_dense_params``: every weight and bias ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``, the cross bias's fan-in taken as ``r``, the fan-in of the
product it is added to), where torchrec draws ``V`` and ``W`` by
``xavier_normal_`` and starts ``b`` at zero; and the dense parameters train
by SGD (``training.py``), where MLPerf trains them by Adagrad.

``lowered`` (the witness, never the reference) models a program that
computes in that dtype: every product's operands rounded to it, in the
forward and the backward (a product's f32 cotangent too, where the cross
layers' ``W`` products take one), and the bottom tower's output, which such
a program keeps in it; sums, the bias adds and the cross layers' residual
stream stay f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .dlrm import _linear_flops, _tower
from .training import rounder


def _widths(dlrm: dict):
    """(N, r, L): the cross network's width, rank and depth."""
    n = len(dlrm["num_embeddings_per_feature"]) + 1
    return n * dlrm["embedding_dim"], dlrm["dcn_low_rank_dim"], dlrm["dcn_num_layers"]


def dense_shapes(dlrm: dict) -> Dict[str, tuple]:
    """Each dense parameter's name (the model's state dict's), shape and
    fan-in, from a configuration's ``dlrm`` fields: the bottom tower, the
    cross network (each ``V``, each ``W``, each bias) and the top tower
    from ``N`` inputs."""
    N, r, L = _widths(dlrm)
    out = {}
    fan = dlrm["dense_in_features"]
    for i, o in enumerate(dlrm["dense_arch_layer_sizes"]):
        out[f"dense_arch.{i}.weight"] = ((o, fan), fan)
        out[f"dense_arch.{i}.bias"] = ((o,), fan)
        fan = o
    for name, shape, fan in (("V_kernels", (r, N), N), ("W_kernels", (N, r), r), ("bias", (N,), r)):
        for l in range(L):
            out[f"crossnet.{name}.{l}"] = (shape, fan)
    fan = N
    for i, o in enumerate(dlrm["over_arch_layer_sizes"]):
        out[f"over_arch.{i}.weight"] = ((o, fan), fan)
        out[f"over_arch.{i}.bias"] = ((o,), fan)
        fan = o
    return out


def example_flops(dlrm: dict) -> int:
    """Operations per training example of the DLRM-DCNv2 step (forward and
    backward), from a configuration's ``dlrm`` fields: the bottom tower (its
    first layer's input takes no gradient); each cross layer's two products
    ``V x`` and ``W u`` (``2 N r`` each forward; the weight gradient and the
    input gradient ``2 N r`` each of both backward, ``x_0`` taking the
    embeddings' gradient), ``12 N r`` a layer; the top tower from ``N``
    inputs. Element-wise terms (bias, ``x_0 *``, residual, activations,
    loss) are linear in the widths and left out (under 0.1% of the total).
    MLPerf's published shape (13 dense features, bottom 512, 256, 128, 26
    tables of 128, 3 layers of rank 512 over N = 3,456, top 1024, 1024,
    512, 256, 1): bottom 2*13*512*2 + 6*(512*256 + 256*128) = 1,009,664;
    cross 3 * 12 * 3,456 * 512 = 63,700,992; top 6 * (3,456*1,024 +
    1,024*1,024 + 1,024*512 + 512*256 + 256) = 31,458,816; in all
    96,169,472."""
    N, r, L = _widths(dlrm)
    bottom, top = list(dlrm["dense_arch_layer_sizes"]), list(dlrm["over_arch_layer_sizes"])
    return (_linear_flops(list(zip([dlrm["dense_in_features"], *bottom[:-1]], bottom)), False) + 12 * N * r * L
            + _linear_flops(list(zip([N, *top[:-1]], top)), True))


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the backward rounds the cotangent to ``dtype``
    (kept in f32)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype).float(), None


def logits(params: Dict[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor,
           lowered: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B,) logits from dense features (B, Din) and embeddings (B, F, D).
    With ``lowered``, the witness's roundings (the module's docstring)."""
    rnd = rounder(lowered)
    rnd_grad = (lambda t: t) if lowered is None else (lambda t: _RoundGrad.apply(t, lowered))
    z = rnd(_tower(params, "dense_arch", dense, True, rnd))
    x0 = torch.cat([z[:, None, :], emb], dim=1).reshape(emb.shape[0], -1)
    x = x0
    L = sum(1 for k in params if k.startswith("crossnet.V_kernels."))
    for l in range(L):
        u = rnd(x) @ rnd(params[f"crossnet.V_kernels.{l}"]).t()
        y = rnd_grad(rnd(u) @ rnd(params[f"crossnet.W_kernels.{l}"]).t())
        x = x0 * (y + params[f"crossnet.bias.{l}"]) + x
    return _tower(params, "over_arch", x, False, rnd)[:, 0]
