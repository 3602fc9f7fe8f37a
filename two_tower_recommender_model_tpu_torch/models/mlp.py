"""MLP towers matching `torchrec.modules.mlp.MLP` semantics.

Port of `two_tower_recommender_model_tpu/models/mlp.py` (`init_mlp` and the
forward of `apply_mlp`). Each layer is Linear -> activation, *including the
final layer* (torchrec applies the activation unconditionally, so the
reference towers emit non-negative embeddings); `final_activation=False`
gives the linear-head variant.

Weights live in `nn.Linear` layout, `weight` `[out, in]`; the JAX package
keeps `kernel` `[in, out]` (`params_from_numpy` in `models/two_tower.py`
transposes between them).

The fused tower backward (`_mlp2_relu` of the reference): with
`fused_backward=True`, a two-layer ReLU tower with the final ReLU on whose
shapes pass `ops.tower_bwd.fits` runs as `Mlp2Relu`, an autograd Function
whose forward is the two-layer forward (on CUDA bf16 with each layer's bias
and ReLU in `ops/relu_ties.py`, which decides rounding ties in k order) and
whose backward is the fused tower-backward kernel (`ops/tower_bwd.py`,
kernel #8).
"""

from __future__ import annotations

from typing import Sequence

import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device
import torch.nn.functional as F
from torch import nn

from two_tower_recommender_model_tpu_torch.ops.relu_ties import relu_ties
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import fits, tower_backward

_ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
}


def apply_mlp(
    layers: Sequence[nn.Linear],
    x: torch.Tensor,
    activation: str = "relu",
    final_activation: bool = True,
    compute_dtype: torch.dtype | None = None,
    fused_backward: bool = False,
) -> torch.Tensor:
    """The tower forward. With `compute_dtype`, inputs and weights are cast to
    it, each matmul accumulates in float32, its result is cast to the compute
    dtype, and the bias is added in that dtype (the reference's bf16 rule).
    `fused_backward` routes a fitting two-layer ReLU tower through `Mlp2Relu`
    (same forward, fused backward)."""
    act = _ACTIVATIONS[activation]
    n = len(layers)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if fused_backward and n == 2 and activation == "relu" and final_activation:
        l0, l1 = layers
        if fits(x.shape[1], l0.out_features, l1.out_features, x.shape[0]):
            cast = (lambda a: a.to(compute_dtype)) if compute_dtype is not None else (
                lambda a: a)
            # kernels in the reference's [in, out] layout
            return Mlp2Relu.apply(cast(l0.weight).T, cast(l0.bias), cast(l1.weight).T,
                                  cast(l1.bias), x)
    for i, layer in enumerate(layers):
        kernel, bias = layer.weight, layer.bias
        if compute_dtype is not None:
            kernel = kernel.to(compute_dtype)
            bias = bias.to(compute_dtype)
        x = torch.matmul(x.float(), kernel.float().T).to(x.dtype) + bias
        if i < n - 1 or final_activation:
            x = act(x)
    return x


class MLP(nn.Module):
    """A stack of `nn.Linear` layers run by `apply_mlp`. Parameters are left
    uninitialized (no draw from the global generator): fill them with
    `init_mlp` or copy weights in."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int], activation: str = "relu",
                 final_activation: bool = True, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        sizes = [in_size, *layer_sizes]
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            torch.nn.utils.skip_init(nn.Linear, a, b, dtype=dtype, device=device)
            for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.activation = activation
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None = None,
                fused_backward: bool = False) -> torch.Tensor:
        return apply_mlp(self.layers, x, self.activation, self.final_activation, compute_dtype,
                         fused_backward)


def init_mlp(
    generator: torch.Generator,
    in_size: int,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    activation: str = "relu",
    final_activation: bool = True,
) -> MLP:
    """Torch-Linear-style init: W ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the same
    for the bias, drawn from `generator` on the generator's device."""
    mlp = MLP(in_size, layer_sizes, activation, final_activation, dtype, generator.device)
    with torch.no_grad():
        for layer in mlp.layers:
            bound = 1.0 / layer.in_features ** 0.5
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return mlp


# --- the fused-backward two-layer ReLU tower -----------------------------------------


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`a @ w` in a's dtype, summed in f32 and rounded once (the reference's
    `preferred_element_type=f32` then cast). On CUDA bf16 operands this is one
    bf16 GEMM: cuBLAS sums in f32, and the package turns off its bf16
    reduction of split-K partials at import. Elsewhere the operands are
    widened to f32 (products of bf16 values are exact in f32, so the two
    routes differ only in the order of the sum)."""
    if a.is_cuda and a.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(a, w)
    return torch.matmul(a.float(), w.float()).to(a.dtype)


def _mlp2_fwd_impl(w1, b1, w2, b2, x):
    """`relu(relu(x @ w1 + b1) @ w2 + b2)` under the forward's dtype rule,
    with w1 [in, h1] and w2 [h1, h2] in the reference's layout.

    On CUDA bf16 each layer's bias and ReLU run in `relu_ties` (kernel
    `csrc/relu_ties.cu`): the GEMM sums in the tensor cores' order, and a
    sum at a bf16 rounding tie against -b is summed again in k order, so the
    forward makes the ReLU decisions the tower backward (#8), the plain
    route and the host make."""
    if x.is_cuda and all(t.dtype == torch.bfloat16 for t in (x, w1, b1, w2, b2)):
        h1 = relu_ties(_mm(x, w1), b1, x, w1)
        return relu_ties(_mm(h1, w2), b2, h1, w2)
    h1 = torch.relu(_mm(x, w1) + b1)
    return torch.relu(_mm(h1, w2) + b2)


class Mlp2Relu(torch.autograd.Function):
    """The flagship tower with the fused backward: the forward is two GEMMs
    (the reference leaves it to XLA) with the bias and ReLU in `relu_ties` on
    CUDA bf16, the backward one launch of the tower-backward kernel. The
    weight gradients come back in f32 and are cast to the weights' dtype, as
    the reference's `_mlp2_relu_bwd` does: under bf16 compute they are
    rounded to bf16 once, and the cast of the weights to bf16 widens them
    back to f32 in its own backward."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, x):
        out = _mlp2_fwd_impl(w1, b1, w2, b2, x)
        ctx.save_for_backward(w1, b1, w2, x, out)
        ctx.b2_dtype = b2.dtype
        return out

    @staticmethod
    def backward(ctx, dq):
        w1, b1, w2, x, out = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = tower_backward(x.contiguous(), dq.contiguous(), out, w1, b1,
                                                w2)
        return (dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype), dx)
