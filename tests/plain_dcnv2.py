"""A plain DLRM-DCNv2 (torchrec's ``DLRM_DCN`` with its ``LowRankCrossNet``,
arXiv:2008.13535) for the CPU tests of the port's DCN model: plain PyTorch in
f32, importing neither JAX nor anything of the port. ``logits`` and ``loss``
are the forward; autograd gives the gradients.

* bottom tower: ``Linear`` + ReLU on every layer, the dense features to D;
* ``x_0``: the bottom tower's output and the F pooled bags (B, F, D),
  concatenated, dense first, into (B, (F + 1) D);
* each cross layer ``x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l``, with
  ``V_l`` (r, N), ``W_l`` (N, r), ``b_l`` (N,);
* top tower: ``Linear`` + ReLU on all but the last layer, one logit;
* loss: the mean binary cross-entropy on the logit.

Parameters come as a dict under the port's state-dict names
(``dense_arch.{i}.weight``, ``crossnet.V_kernels.{l}``, ...). Departures from
torchrec: none in the arithmetic; the tests load the port's weights, whose
cross kernels follow torchrec's ``xavier_normal_`` law and whose biases start
at zero, and the towers' the JAX package's ``nn.Linear`` law.

``lowered`` models a program that computes in that dtype (it is not the
reference): every product's operands rounded to it, in the forward and in
the backward (through each rounded operand's cast, which rounds that
operand's cotangent, and, for the cross layers' ``W`` products, whose f32
results feed f32 sums, the product's own f32 cotangent), and the bottom
tower's output, which such a program keeps in it. Sums, the bias adds and
the cross layers' residual stream stay f32. ``perfbench/reference/
dlrm_dcnv2.py`` is the benchmark's copy of this model.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _rounder(lowered: Optional[torch.dtype]):
    if lowered is None:
        return lambda t: t
    return lambda t: t.to(lowered).float()


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent to ``dtype``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype).float(), None


def _count(params: Dict[str, torch.Tensor], prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix))


def _tower(params, arch: str, x: torch.Tensor, last_relu: bool, rnd) -> torch.Tensor:
    n = _count(params, arch + ".") // 2
    for i in range(n):
        x = rnd(x) @ rnd(params[f"{arch}.{i}.weight"]).t() + params[f"{arch}.{i}.bias"]
        if last_relu or i + 1 < n:
            x = torch.relu(x)
    return x


def logits(params: Dict[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor,
           lowered: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B,) logits from dense features (B, Din) and pooled bags (B, F, D)."""
    rnd = _rounder(lowered)
    z = rnd(_tower(params, "dense_arch", dense, True, rnd))
    x0 = torch.cat([z[:, None, :], emb], dim=1).reshape(emb.shape[0], -1)
    x = x0
    for l in range(_count(params, "crossnet.V_kernels.")):
        u = rnd(x) @ rnd(params[f"crossnet.V_kernels.{l}"]).t()
        y = rnd(u) @ rnd(params[f"crossnet.W_kernels.{l}"]).t()
        if lowered is not None:
            y = _RoundGrad.apply(y, lowered)
        x = x0 * (y + params[f"crossnet.bias.{l}"]) + x
    return _tower(params, "over_arch", x, False, rnd)[:, 0]


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y = y.to(z.dtype)
    return torch.mean(torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs())))


def loss(params: Dict[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
         lowered: Optional[torch.dtype] = None) -> torch.Tensor:
    return bce(logits(params, dense, emb, lowered), labels)
