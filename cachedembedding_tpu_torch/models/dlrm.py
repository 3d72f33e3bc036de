"""DLRM dense towers + feature interaction as a torch ``nn.Module``
(counterpart of ``cachedembedding_tpu/models/dlrm.py``).

  * DenseArch — MLP with ReLU on every layer.
  * InteractionArch — concat [dense_emb, sparse (B, F, D)], pairwise dot
    products, upper-triangle (offset 1) flatten, concat with dense_emb.
    ``interaction_impl`` picks the JAX package's two custom VJPs: "bmm"
    (``_PairwiseDots``, the (B, n, n) dots) or "gather"
    (``_PairwiseTriuGather``, the (B, pairs) dots with a backward through
    the (pairs, n*n) symmetrising matrix).
  * OverArch — MLP with ReLU on all but the final linear layer.

With ``interaction_type="dcn"`` (DLRM-DCNv2, MLPerf Training's
recommendation model; torchrec's ``DLRM_DCN``) the pairwise dots give way to
a DCN-v2 low-rank cross network (``_CrossNet``, torchrec's
``LowRankCrossNet``, arXiv:2008.13535): the bottom tower's output and the F
pooled bags, dense first, concatenated into ``x_0`` (B, (F+1)*D), then
``x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l`` for each layer, and the top
tower from (F+1)*D inputs. The JAX package has no such model.

Numerics follow the JAX package so that both give the same values:
  * each linear layer multiplies operands rounded to ``compute_dtype`` with
    f32 accumulation, adds the f32 bias, and rounds once to the compute dtype
    (``_linear``); the logits head stays f32;
  * the interaction's backward rounds the symmetrized cotangent to the
    operand dtype before its grad-dot (``_PairwiseDots``,
    ``_PairwiseTriuGather``).
Exact products of bf16 operands fit an f32 mantissa, so the f32 matmul of the
rounded operands is the f32-accumulated bf16 matmul. With bf16 compute, the
products whose result is rounded to bf16 (every linear layer but the f32 head,
through ``_Bf16Linear``, and ``_PairwiseDots``) keep their operands in bf16,
which are bf16 values in the forward and the backward (the cotangent of a
bf16 output is bf16); ``_product`` sends them on the card to cuBLAS on the
tensor cores with f32 accumulation and an f32 result, so only the order of the
f32 sums differs, and multiplies them in f32 elsewhere. The head and f32
compute run the f32 chain of casts. The cross network's products feed f32
sums: with bf16 compute their operands are bf16 in the forward and the
backward (``_Bf16Product``: the f32 cotangent rounded once, dX and dW rounded
once to bf16), while the bias add, ``x_0 * (.) + x_l`` and the residual
stream stay f32. ``PRODUCTS`` counts both paths.

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


INTERACTION_TYPES = ("dot", "dcn")
# the cross network's kernels: the init's key and the state dict's name
_CROSS_NAMES = (("V", "V_kernels"), ("W", "W_kernels"), ("b", "bias"))


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
    interaction_type: str = "dot",
    dcn_num_layers: int = 3,
    dcn_low_rank_dim: int = 512,
) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Numpy weights in the JAX ``DLRMParams`` layout:
    {"dense_arch": [{"w": (in, out), "b": (out,)}, ...], "over_arch": [...]};
    with ``interaction_type="dcn"`` also "crossnet": {"V": [(r, N), ...],
    "W": [(N, r), ...], "b": [(N,), ...]} in torchrec's layout, V and W
    drawn from a third stream by torchrec's ``xavier_normal_``, b zeros."""
    if interaction_type not in INTERACTION_TYPES:
        raise ValueError(f"unknown interaction_type {interaction_type!r}")
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
    crossnet = None
    if interaction_type == "dcn":
        over_in = embedding_dim * (num_sparse_features + (1 if dense_arch else 0))
        rng3 = np.random.default_rng(_key_seed_seq(seed).spawn(3)[2])
        std = math.sqrt(2.0 / (over_in + dcn_low_rank_dim))  # xavier normal, gain 1: both kernels' fans
        crossnet = {"V": [], "W": [], "b": []}
        for _ in range(dcn_num_layers):
            crossnet["V"].append(rng3.normal(0.0, std, (dcn_low_rank_dim, over_in)).astype(np.float32))
            crossnet["W"].append(rng3.normal(0.0, std, (over_in, dcn_low_rank_dim)).astype(np.float32))
            crossnet["b"].append(np.zeros((over_in,), np.float32))
    if len(over_arch_layer_sizes) <= 1:
        raise ValueError("OverArch must have multiple layers.")
    rng2 = np.random.default_rng(ss2)
    over_arch = []
    in_f = over_in
    for out_f in over_arch_layer_sizes:
        over_arch.append(_linear_init_np(rng2, in_f, out_f))
        in_f = out_f
    if crossnet is not None:
        return {"dense_arch": dense_arch, "crossnet": crossnet, "over_arch": over_arch}
    return {"dense_arch": dense_arch, "over_arch": over_arch}


def params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """State dict of ``DLRM`` from JAX ``DLRMParams`` given as numpy (a
    ``DLRMParams`` or a dict with ``dense_arch``/``over_arch`` lists of
    {"w": (in, out), "b": (out,)}). Each ``w`` is TRANSPOSED to nn.Linear's
    (out, in); biases carry over as they are. A dict's "crossnet" (the DCN
    model's, which JAX lacks) carries over as it is, under torchrec's names."""
    get = (lambda k: params_np[k]) if isinstance(params_np, dict) else (lambda k: getattr(params_np, k))
    sd = {}
    for arch in ("dense_arch", "over_arch"):
        for i, p in enumerate(get(arch)):
            sd[f"{arch}.{i}.weight"] = torch.from_numpy(np.array(p["w"], np.float32).T.copy())
            sd[f"{arch}.{i}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
    cross = params_np.get("crossnet") if isinstance(params_np, dict) else None
    if cross is not None:
        for key, name in _CROSS_NAMES:
            for i, a in enumerate(cross[key]):
                sd[f"crossnet.{name}.{i}"] = torch.from_numpy(np.array(a, np.float32))
    return sd


def params_to_jax(model: "DLRM") -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Inverse of ``params_from_jax``: numpy weights in the JAX layout (and
    the DCN model's "crossnet")."""
    out = {
        arch: [
            {"w": lin.weight.detach().cpu().numpy().T.copy(), "b": lin.bias.detach().cpu().numpy().copy()}
            for lin in getattr(model, arch)
        ]
        for arch in ("dense_arch", "over_arch")
    }
    if model.crossnet is not None:
        out["crossnet"] = {key: [p.detach().cpu().numpy().copy() for p in getattr(model.crossnet, name)]
                           for key, name in _CROSS_NAMES}
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

#: The towers' matrix products of this process so far, forward and backward,
#: by path: "tensor_core" (bf16 operands into cuBLAS with f32 accumulation and
#: an f32 result, on the card) and "f32" (f32 products: the CPU, f32 compute,
#: the f32 head, the gather interaction). The f32 chain of a linear layer
#: counts its backward products when its forward records them for autograd.
PRODUCTS = {"tensor_core": 0, "f32": 0}


def _product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op`` (``torch.mm`` or ``torch.bmm``) of ``a`` and ``b`` with f32
    accumulation and an f32 result: bf16 operands on the card go as they are
    to the tensor cores, others are multiplied in f32."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        PRODUCTS["tensor_core"] += 1
        return op(a, b, out_dtype=torch.float32)
    PRODUCTS["f32"] += 1
    return op(a.float(), b.float())


class _Bf16Linear(torch.autograd.Function):
    """``_linear`` with bf16 compute and a bf16 result. It saves the bf16
    operands, not f32 copies, and returns the gradients of the f32 chain: dX
    and dW rounded once to bf16 (then to the input's and the weight's dtype),
    db summed in f32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, weight.dtype)
        return (_product(torch.mm, xb, wb.t()) + bias).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)  # the cotangent of a bf16 output: lossless
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _product(torch.mm, gb, wb).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _product(torch.mm, gb.t(), xb).to(torch.bfloat16).to(ctx.dtypes[1])
        if ctx.needs_input_grad[2]:
            db = g.sum(0, dtype=torch.float32)
        return dx, dw, db


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Matmul of ``dtype``-rounded operands with f32 accumulation; the bias
    add is f32 and rounds once to ``dtype`` (or ``out_dtype``). An f32 result
    (the head: its cotangent is not bf16-valued) and f32 compute (TF32 would
    change its results) take the f32 chain."""
    if dtype == torch.bfloat16 and out_dtype in (None, dtype):
        return _Bf16Linear.apply(x, layer.weight, layer.bias)
    y = x.to(dtype).float() @ layer.weight.to(dtype).float().t()
    PRODUCTS["f32"] += 1 + (x.requires_grad + layer.weight.requires_grad if torch.is_grad_enabled() else 0)
    return (y + layer.bias).to(out_dtype or dtype)


def _mlp(layers: nn.ModuleList, x: torch.Tensor, dtype: torch.dtype, final_relu: bool = True) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = _linear(layer, x, dtype)
        if final_relu or i + 1 < len(layers):
            x = torch.relu(x)
    return x


class _Bf16Product(torch.autograd.Function):
    """``x @ weight^T`` of bf16 operands with an f32 result, for products
    that feed f32 sums (the cross network's). The backward's operands are
    bf16 too: the f32 cotangent rounded once; dX and dW rounded once to bf16
    (then to the input's and the weight's dtype)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, weight.dtype)
        return _product(torch.mm, xb, wb.t())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(torch.mm, gb, wb).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _product(torch.mm, gb.t(), xb).to(torch.bfloat16).to(ctx.dtypes[1])
        return dx, dw


def _cross_product(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight^T`` with an f32 result: bf16 operands through
    ``_Bf16Product`` under bf16 compute, else the f32 product."""
    if dtype == torch.bfloat16:
        return _Bf16Product.apply(x, weight)
    PRODUCTS["f32"] += 1 + (x.requires_grad + weight.requires_grad if torch.is_grad_enabled() else 0)
    return x.float() @ weight.float().t()


class _CrossNet(nn.Module):
    """torchrec's ``LowRankCrossNet``: ``V_kernels`` (r, N), ``W_kernels``
    (N, r) and ``bias`` (N,) a layer; ``x_{l+1} = x_0 * (W_l (V_l x_l) +
    b_l) + x_l`` on the (B, N) f32 ``x_0``, in f32 but for the products'
    operands (``_cross_product``)."""

    def __init__(self, num_layers: int, in_features: int, low_rank_dim: int):
        super().__init__()

        def kernels(shape):
            return nn.ParameterList(nn.Parameter(torch.empty(shape, device="meta")) for _ in range(num_layers))

        self.V_kernels = kernels((low_rank_dim, in_features))
        self.W_kernels = kernels((in_features, low_rank_dim))
        self.bias = kernels((in_features,))

    def forward(self, x0: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x0
        for v, w, b in zip(self.V_kernels, self.W_kernels, self.bias):
            x = x0 * (_cross_product(_cross_product(x, v, dtype), w, dtype) + b) + x
        return x


class _PairwiseDots(torch.autograd.Function):
    """(B, n, n) f32 pairwise dots of a (B, n, D) compute-dtype input. The
    backward rounds the symmetrized cotangent to the operand dtype before the
    grad-dot, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, combined: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(combined)
        return _product(torch.bmm, combined, combined.transpose(1, 2))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (combined,) = ctx.saved_tensors
        gsym = (g + g.transpose(1, 2)).to(combined.dtype)
        return _product(torch.bmm, gsym, combined).to(combined.dtype)


def gsym_matrix(n: int) -> torch.Tensor:
    """(pairs, n*n) f32 0/1 matrix scattering a triu-pair cotangent to both
    (r, c) and (c, r): ``g @ M`` reshaped is (G + G^T) of the triu-only
    cotangent (the JAX package's ``_gsym_matrix``)."""
    r, c = np.triu_indices(n, k=1)
    m = np.zeros((r.size, n * n), np.float32)
    m[np.arange(r.size), r * n + c] = 1.0
    m[np.arange(r.size), c * n + r] = 1.0
    return torch.from_numpy(m)


class _PairwiseTriuGather(torch.autograd.Function):
    """(B, pairs) f32 upper-triangle pairwise dots of a (B, n, D)
    compute-dtype input, with the JAX package's backward (``_ptg_bwd``): the
    cotangent rounded to the operand dtype, symmetrised by the 0/1 matrix
    with f32 accumulation and rounded again, then the grad-dot in f32,
    rounded to the operand dtype. JAX computes the pairs as a fused gather
    and multiply-reduce; PyTorch would materialise the two (B, pairs, D)
    gathers, so the pairs come from the f32 batched matmul (exact products of
    the rounded operands, f32 sums in another order)."""

    @staticmethod
    def forward(ctx, combined: torch.Tensor, triu_r: torch.Tensor, triu_c: torch.Tensor,
                gsym: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(combined, gsym)
        PRODUCTS["f32"] += 1
        c = combined.float()
        return torch.bmm(c, c.transpose(1, 2))[:, triu_r, triu_c]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        combined, gsym_m = ctx.saved_tensors
        B, n, _ = combined.shape
        dt = combined.dtype
        PRODUCTS["f32"] += 2
        gsym = (g.to(dt).float() @ gsym_m).reshape(B, n, n).to(dt)
        d = torch.bmm(gsym.float(), combined.float())
        return d.to(dt), None, None, None


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
        interaction_type: str = "dot",
        dcn_num_layers: int = 3,
        dcn_low_rank_dim: int = 512,
    ):
        super().__init__()
        if interaction_impl not in ("bmm", "gather"):
            raise ValueError(f"unknown interaction_impl {interaction_impl!r}")
        self.interaction_impl = interaction_impl
        self.compute_dtype = compute_dtype
        params = init_dlrm_dense(
            seed, embedding_dim, num_sparse_features, dense_in_features,
            dense_arch_layer_sizes, over_arch_layer_sizes, interaction_type, dcn_num_layers, dcn_low_rank_dim,
        )

        def linears(arch):
            return nn.ModuleList(
                nn.Linear(p["w"].shape[0], p["w"].shape[1], device="meta") for p in params[arch]
            )

        self.dense_arch = linears("dense_arch")
        self.crossnet = None
        if interaction_type == "dcn":
            self.crossnet = _CrossNet(dcn_num_layers, params["over_arch"][0]["w"].shape[0], dcn_low_rank_dim)
        self.over_arch = linears("over_arch")
        self.load_state_dict(params_from_jax(params), assign=True)
        if device is not None:
            self.to(device)
        n = num_sparse_features + (1 if self.dense_arch else 0)
        r, c = np.triu_indices(n, k=1)
        self.register_buffer("_triu_r", torch.as_tensor(r, dtype=torch.long, device=device), persistent=False)
        self.register_buffer("_triu_c", torch.as_tensor(c, dtype=torch.long, device=device), persistent=False)
        self.register_buffer("_gsym", gsym_matrix(n).to(device), persistent=False)

    def interaction(self, dense_emb: Optional[torch.Tensor], sparse_bfd: torch.Tensor) -> torch.Tensor:
        """(B, D + pairs) with the dense embedding, else (B, pairs)."""
        dt = self.compute_dtype
        if dense_emb is not None:
            combined = torch.cat([dense_emb[:, None, :].to(dt), sparse_bfd.to(dt)], dim=1)
        else:
            combined = sparse_bfd.to(dt)
        if self.interaction_impl == "gather":
            flat = _PairwiseTriuGather.apply(combined, self._triu_r, self._triu_c, self._gsym)
        else:
            flat = _PairwiseDots.apply(combined)[:, self._triu_r, self._triu_c]
        if dense_emb is not None:
            return torch.cat([dense_emb, flat], dim=1)  # promotes to f32
        return flat

    def forward(self, dense_features: Optional[torch.Tensor], sparse_bfd: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        dense_emb = _mlp(self.dense_arch, dense_features, dt) if len(self.dense_arch) else None
        if self.crossnet is not None:
            parts = ([dense_emb[:, None, :].float()] if dense_emb is not None else []) + [sparse_bfd.float()]
            x = self.crossnet(torch.cat(parts, dim=1).reshape(sparse_bfd.shape[0], -1), dt)
        else:
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
